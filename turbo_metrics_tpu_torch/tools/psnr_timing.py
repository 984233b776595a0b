"""Time PSNR's mean squared error three ways on the same quantized pair.

``ops/quality.psnr`` scores the engine's quantized pair (8-bit codes in
f32).  A frame's PSNR must not depend on the batch or the mesh shard it is
scored in, so its sum of squared differences must be exact.  This tool
times, on one seeded pair of 8-bit codes (B, 3, H, W):

  * "f32 mean": ``torch.mean`` in f32, the formulation before the sums were
    made exact (torch splits its reduction by the number of frames, so a
    frame's value depends on the batch);
  * "runs of 256": the squared differences summed in f32 in runs of 256
    (each run's sum below 2**24, so exact), the runs in f64;
  * "f64 sum": the squared differences summed in f64 (each below 2**16 and
    all of a 4K frame's below 2**53, so exact);
  * "quality.psnr": the port's function, one of the two exact ones.

It checks that the exact formulations give the same dB bit for bit, on the
whole batch and on each half of it, and times each by CUDA events on the
card (the host clock on the CPU), in the order A B C D D C B A, ``--rounds``
times.  Run:

    python -m turbo_metrics_tpu_torch.tools.psnr_timing              # 1080p, B=8, on the card
    python -m turbo_metrics_tpu_torch.tools.psnr_timing --device cpu --batch 2 --height 48 --width 64

It prints a line per formulation and, last, one JSON object
``{"psnr_timing": [{"name", "ms"}, ...]}`` (``ms``: each timed run),
which ``main`` also returns.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from turbo_metrics_tpu_torch.ops import quality
from turbo_metrics_tpu_torch.utils.profiling import time_ms

PEAK2 = float(np.float32(255.0 * 255.0))


def _db(mse: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(PEAK2 / mse)


def f32_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    diff = a - b
    return _db(torch.mean(diff * diff, dim=(-3, -2, -1)))


def runs_of_256(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    diff = a - b
    sq = (diff * diff).flatten(-3)
    n = sq.shape[-1]
    if n % 256:
        sq = torch.nn.functional.pad(sq, (0, 256 - n % 256))
    runs = sq.unflatten(-1, (-1, 256)).sum(dim=-1)
    return _db((torch.sum(runs, dim=-1, dtype=torch.float64) / n).to(torch.float32))


def f64_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    diff = a - b
    n = diff[0].numel()
    return _db((torch.sum(diff * diff, dim=(-3, -2, -1), dtype=torch.float64) / n).to(torch.float32))


FORMULATIONS = {
    "f32 mean": f32_mean,
    "runs of 256": runs_of_256,
    "f64 sum": f64_sum,
    "quality.psnr": quality.psnr,
}
EXACT = ("runs of 256", "f64 sum", "quality.psnr")


def pair(batch: int, height: int, width: int, dev: torch.device) -> tuple:
    """Seeded 8-bit codes in f32, the distorted within +-8 of the
    reference."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (batch, 3, height, width))
    b = np.clip(a + rng.integers(-8, 9, a.shape), 0, 255)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(dev) for x in (a, b))


def check_exact(a: torch.Tensor, b: torch.Tensor) -> None:
    """The exact formulations agree bit for bit, on the batch and on each
    half of it."""
    half = max(a.shape[0] // 2, 1)
    for sl in (slice(None), slice(0, half), slice(half, None)):
        if not a[sl].shape[0]:
            continue
        want = FORMULATIONS[EXACT[0]](a[sl], b[sl])
        whole = FORMULATIONS[EXACT[0]](a, b)[sl]
        for name in EXACT:
            got = FORMULATIONS[name](a[sl], b[sl])
            if not (torch.equal(got, want) and torch.equal(got, whole)):
                raise AssertionError(f"{name} differs from {EXACT[0]} on frames {sl}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Time PSNR's mean squared error three ways.")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--iters", type=int, default=20, help="calls per timed run")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of A B C D D C B A")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device")
    a, b = pair(args.batch, args.height, args.width, dev)
    check_exact(a, b)
    names = list(FORMULATIONS)
    ms = {name: [] for name in names}
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            ms[name].append(time_ms(lambda: FORMULATIONS[name](a, b), args.iters, dev))
    shape = f"B={args.batch} 3x{args.height}x{args.width}"
    for name in names:
        print(f"{name}: " + " / ".join(f"{t:.4f}" for t in ms[name]) + f" ms ({shape}, {dev})")
    out = {"psnr_timing": [{"name": name, "ms": ms[name]} for name in names]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
