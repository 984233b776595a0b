"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with the cards
the cell asks for.  Standard output's last line is the result as one JSON
object; standard error's last lines are the numbers compared with the
reference, each beside its limit.  Exits non-zero, printing no result,
without CUDA or with fewer cards than the cell asks for, and where JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"modules of {', '.join(bad)} were loaded; the benchmark runs without them", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
