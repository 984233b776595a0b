"""Save, or compare, what the level wrappers return on the dissect tool's inputs.

A redesign of a level kernel that keeps its arithmetic returns the same bits
as the kernels it replaces.  ``save`` imports the port's package from a
given checkout of the repository (the working tree, or an older commit
unpacked beside it with ``git archive``), runs the probes of that
checkout's dissect tool (``kernel_dissect.probes`` at the tool's default
shape, B=4 1080x1920, inputs from seed 0) whose wrapper is one of
``WRAPPERS``, on the card, and saves every tensor
they return, with the peak device memory of each call above its inputs;
``compare`` reports for each result that both files hold whether they
hold the same bits, and the largest difference where they do not:

    python turbo_metrics_tpu_torch/tools/level_outputs.py save ROOT OUT.pt
    python turbo_metrics_tpu_torch/tools/level_outputs.py compare A.pt B.pt

Run ``save`` in a process of its own per checkout (both packages have one
name).  ``compare`` prints a line per result, then one JSON object
``{"compare": [{"result", "shape", "equal", "max_abs_diff"}, ...],
"only_in_a": [...], "only_in_b": [...]}`` (results of probes that one
checkout's tool does not have), and exits 1 where a compared result
differs or none is compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

# The wrappers whose results are saved: SSIM's and VIF's levels.
WRAPPERS = ("ssim_sums", "msssim_tail", "vif_scale0", "vif_tail")


def save(root: str, out: str) -> dict:
    """Run the probes of the checkout at ``root`` whose wrapper is in
    ``WRAPPERS`` once each on the card, at its dissect tool's default shape;
    save {"results": {"<entry> [i]": the
    i-th tensor the call returns}, "peak_mib": {entry: the call's peak
    device memory above what was allocated before it, MiB}} to ``out`` and
    return it."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the results are the card's")
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from turbo_metrics_tpu_torch.tools import kernel_dissect

    if not os.path.abspath(kernel_dissect.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {kernel_dissect.__file__}, not the package under {root}")
    shape = kernel_dissect.build_parser().parse_args([])
    results, peak_mib = {}, {}
    with torch.no_grad():
        for probe in kernel_dissect.probes(shape.batch, shape.height, shape.width, torch.device("cuda")):
            if probe.wrapper not in WRAPPERS:
                continue
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = probe.fn()
            torch.cuda.synchronize()
            peak_mib[probe.entry] = (torch.cuda.max_memory_allocated() - base) / 2**20
            print(f"{probe.entry} [{probe.wrapper}]: peak device memory above its inputs "
                  f"{peak_mib[probe.entry]:.1f} MiB ({torch.cuda.get_device_name()})", flush=True)
            for i, t in enumerate(got if isinstance(got, tuple) else (got,)):
                if t is not None:
                    results[f"{probe.entry} [{i}]"] = t.cpu()
    saved = {"results": results, "peak_mib": peak_mib}
    torch.save(saved, out)
    print(f"saved {len(results)} results of {', '.join(WRAPPERS)} from {root} to {out}", flush=True)
    return saved


def compare(a_path: str, b_path: str) -> dict:
    """For each result that both files hold: whether they hold the same bits
    (a probe that only one checkout's dissect tool has is listed apart)."""
    a, b = (torch.load(p)["results"] for p in (a_path, b_path))
    rows = []
    for key in sorted(set(a) & set(b)):
        x, y = a[key], b[key]
        same_shape = x.shape == y.shape
        rows.append({
            "result": key,
            "shape": list(x.shape),
            "equal": same_shape and torch.equal(x, y),
            "max_abs_diff": (x.double() - y.double()).abs().max().item() if same_shape else None,
        })
    for r in rows:
        print(f"{r['result']} {tuple(r['shape'])}: "
              + ("equal bit for bit" if r["equal"] else f"DIFFERS, max abs diff {r['max_abs_diff']}"),
              flush=True)
    out = {"compare": rows, "only_in_a": sorted(set(a) - set(b)), "only_in_b": sorted(set(b) - set(a))}
    for side in ("a", "b"):
        if out[f"only_in_{side}"]:
            print(f"only in {side} (not compared): {', '.join(out[f'only_in_{side}'])}", flush=True)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python turbo_metrics_tpu_torch/tools/level_outputs.py",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save", help="run a checkout's level wrappers on the card and save their results")
    s.add_argument("root", help="the checkout whose turbo_metrics_tpu_torch is imported")
    s.add_argument("out", help="the file to write (torch.save)")
    c = sub.add_parser("compare", help="compare two saved files bit for bit")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        save(args.root, args.out)
        return 0
    rows = compare(args.a, args.b)["compare"]
    return 0 if rows and all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
