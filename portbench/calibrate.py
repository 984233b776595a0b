"""Readings that a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,... [--control-seeds 11,12,13]

For each seed: the cell's ring and program, the two warm batches, then the
ring once round and two batches past its wrap, and the check's sample of
those answers against the reference: the program's gaps (the lower
readings).  For each control seed, the control (the reference in
bfloat16, check.py) against the reference on the same sample: the
control's gaps (the upper readings).  One JSON line per seed on standard
output.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        cell = harness.Cell(args.workload, seed, "cuda")
        line = {"workload": args.workload, "seed": seed, **cell.readings(seed in controls),
                "device": torch.cuda.get_device_name()}
        print(json.dumps(line), flush=True)
        del cell
    return 0


if __name__ == "__main__":
    sys.exit(main())
