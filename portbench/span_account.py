"""Where a cell's host time and idle seconds go, by the program's own spans.

    python3 portbench/span_account.py --cells <name> [<name> ...] [--seed <n>] [--out <file>]

From the root of a checkout, on a card.  Per cell, after set-up as a run
of ``run.py`` makes it: untraced windows with the program's recording
(``turbo_metrics_tpu_torch.utils.profiling``) off and on, in turns, each
read as ``launch_ms`` and ``score_ms`` read theirs (the harness's spans)
and, when on, by the program's records: ``tm.step``, ``tm.score``,
``tm.readback`` and ``tm.wait`` a batch, the self ms of every span and the
counters a batch; then a traced window each way, read by ``trace.Trace``
(off) and ``program_trace.ProgramTrace`` (on): the rate, ``idle_pct``,
``device_p95_ms``, the idle gaps by the innermost span, the device's time
by the innermost ``tm.`` mirror, and the share of the idle seconds inside
``pb.launch`` that a ``tm.`` span covers.  One JSON line per cell on
standard output, all of them in ``--out``.  Nothing here is a metric of
the benchmark: it measures what the harness's readers would read once the
harness switches the recording on.
"""

import argparse
import gc
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, trace  # noqa: E402
from portbench.program_trace import ProgramTrace  # noqa: E402
from turbo_metrics_tpu_torch.utils import profiling  # noqa: E402


def window(cell, seconds: float, on: bool) -> dict:
    """One untraced window with the recording ``on`` or off."""
    cell.spans.take()
    profiling.take()
    with profiling.tracing(on):
        window_s, lat, answers = cell.window(seconds)
    spans = cell.spans.take()
    records = profiling.take()
    n = len(lat)
    out = {"on": on, "batches": n, "fps": len(answers) / window_s,
           **{f"{k}_ms": float(np.mean(spans[f"pb.{k}"]) * 1e3) for k in ("launch", "score", "wait", "batch")}}
    if on:
        total = {k: v.total_s * 1e3 / n for k, v in records.spans.items()}
        out.update(
            step_ms=records.spans["tm.step"].total_s * 1e3 / records.spans["tm.step"].count,
            scoring_ms=total["tm.score"],
            readback_ms=total.get("tm.readback", 0.0),
            host_f64_ms=total["tm.score"] - total.get("tm.wait", 0.0) - total.get("tm.readback", 0.0),
            library_calls=sum(v for k, v in records.counters.items() if k.startswith("launches.")) / n,
            self_ms={k: v.self_s * 1e3 / n for k, v in sorted(records.spans.items(), key=lambda kv: -kv[1].self_s)},
            counters={k: v / n for k, v in records.counters.items()},
        )
    return out


def traced(cell, seconds: float, on: bool) -> dict:
    """One traced window with the recording ``on`` or off."""
    reader = trace.Trace
    if on:
        trace.Trace = ProgramTrace
    try:
        with profiling.tracing(on):
            answers, tr = cell.traced_window(seconds)
    finally:
        trace.Trace = reader
    profiling.take()
    out = {"on": on, "rate": len(answers) / tr.window_s(), "window_s": tr.window_s(), "busy_s": tr.busy_s(),
           "idle_pct": 100.0 * (1.0 - tr.busy_s() / tr.window_s()),
           "device_p95_ms": float(np.percentile(np.array(tr.batch_device_s()) * 1e3, 95)),
           "idle_gaps": tr.idle_gaps(25), "device_ops": tr.device_ops(12)}
    if on:
        out["device_families"] = tr.device_families(25)
        out["mirror_names"] = sorted({m[0] for m in tr.mirrors})
        out["launch_idle_s"], out["launch_idle_tm_share"] = tr.labelled_share("pb.launch")
    return out


def account(name: str, seed: int, seconds: float, turns: int, traced_s: float, device, size=None) -> dict:
    cell = harness.Cell(name, seed, device, size=size)
    for _ in range(harness.WARM_BATCHES):
        cell.batch_scores()
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    gc.collect()
    gc.freeze()
    try:
        runs = [window(cell, seconds, on) for on in ([False, True, True, False] * turns)[:2 * turns]]
        tr = [traced(cell, traced_s, on) for on in (False, True)]
    finally:
        cell.free_program()
        gc.unfreeze()
    medians = {}
    for on in (False, True):
        rs = [r for r in runs if r["on"] == on]
        keys = [k for k, v in rs[0].items() if isinstance(v, float)]
        medians["on" if on else "off"] = {k: statistics.median(r[k] for r in rs) for k in keys}
    return {"cell": name, "device": harness.device_info(torch.device(device), 1)["kind"], "medians": medians,
            "windows": runs, "traced": tr}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seed", type=int, default=3000000201)
    p.add_argument("--seconds", type=float, default=4.0, help="each untraced window")
    p.add_argument("--turns", type=int, default=3, help="untraced windows each way")
    p.add_argument("--traced", type=float, default=harness.TRACE_SECONDS, help="each traced window")
    p.add_argument("--out", type=Path)
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, nargs=2, help="width height, for a rehearsal on the CPU")
    args = p.parse_args(argv)
    results = []
    for k, name in enumerate(args.cells):
        results.append(account(name, args.seed + k, args.seconds, args.turns, args.traced, args.device,
                               tuple(args.size) if args.size else None))
        print(json.dumps({key: results[-1][key] for key in ("cell", "device", "medians")}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
