#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (turbo_metrics_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from turbo_metrics_tpu_torch/csrc with nvcc;
  3. write a seeded 1080p 8-bit 4:2:0 BT.709 limited-range Y4M pair
     (16 frames, noise on a smooth base) to a temporary directory;
  4. score it through the port's CLI (-m ssimulacra2 --output json) with both
     kernels' launch counters reset first: 16 finite scores, both kernels
     launched;
  5. hold each kernel against its plain PyTorch twin on the card at the main
     path's shapes (batch 8): sub-scores rtol 1e-4 / atol 1e-5, the emitted
     level 1 atol 1e-5, frame scores within 0.01 (also against the CLI's),
     and the same sub-scores from a second run; then the kernel path at
     other depths, transfers and ranges on small odd-sized pairs;
  6. score the frozen golden pair through the kernel route: 80.486135 +- 0.05;
  7. time each kernel and its twin, and the whole kernel and plain steps, with
     CUDA events after warm-up.
Prints one JSON line of per-kernel results, then as the last line
{"ok": true, "device": {...}}.  Without CUDA, or outside the repository, it
exits non-zero and prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 8
FRAMES = 16
WIDTH, HEIGHT = 1920, 1080
GOLDEN = 80.486135
SOURCE = "turbo_metrics_tpu_torch/csrc/ssimulacra2_scale.cu"


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def write_y4m_pair(directory: str):
    """Seeded 4:2:0 frames: a smooth moving base plus noise as the reference,
    the reference plus more noise as the distorted stream."""
    rng = np.random.default_rng(20261016)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    cy, cx = yy[::2, ::2] / 2, xx[::2, ::2] / 2
    paths = [os.path.join(directory, n) for n in ("ref.y4m", "dis.y4m")]
    files = [open(p, "wb") for p in paths]
    try:
        for f in files:
            f.write(f"YUV4MPEG2 W{WIDTH} H{HEIGHT} F25:1 Ip A1:1 C420\n".encode())
        for i in range(FRAMES):
            y = 126 + 80 * np.sin(xx / 37.0 + i * 0.1) * np.cos(yy / 23.0)
            u = 128 + 40 * np.sin(cx / 29.0 + i * 0.05)
            v = 128 + 40 * np.cos(cy / 17.0)
            ref = [p + rng.integers(-3, 4, p.shape) for p in (y, u, v)]
            dis = [p + rng.integers(-5, 6, p.shape) for p in ref]
            for f, planes in zip(files, (ref, dis)):
                f.write(b"FRAME\n")
                for p in planes:
                    f.write(np.clip(np.round(p), 0, 255).astype(np.uint8).tobytes())
    finally:
        for f in files:
            f.close()
    return paths


def srgb8_to_linear(img):
    """u8 sRGB -> linear f32 via the 256-entry LUT of the reference."""
    v = np.arange(256, dtype=np.float64) / 255.0
    alpha, beta = 1.0550107, 0.0030412825
    lut = np.where(v < 12.92 * beta, v / 12.92, ((v + (alpha - 1.0)) / alpha) ** 2.4)
    return lut.astype(np.float32)[img]


def golden_pair():
    rng = np.random.default_rng(20240901)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            128 + 90 * np.sin(xx / 13.0) * np.cos(yy / 11.0),
            128 + 70 * np.cos(xx / 7.0),
            128 + 50 * np.sin((xx + yy) / 19.0),
        ],
        axis=-1,
    )
    ref8 = np.clip(base, 0, 255).astype(np.uint8)
    dis8 = np.clip(ref8.astype(np.int16) + rng.integers(-9, 10, ref8.shape), 0, 255).astype(np.uint8)
    return srgb8_to_linear(ref8), srgb8_to_linear(dis8)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_main_path(ref_path: str, dis_path: str, dev):
    """Phase 4: the port's CLI on the Y4M pair, launch counters reset first."""
    from turbo_metrics_tpu_torch import cli
    from turbo_metrics_tpu_torch.ops.kernels import scale_stats, scale_tail

    scale_stats.fused_scale0_yuv.launches = 0
    scale_tail.fused_pyramid_tail.launches = 0
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = cli.main(
            [ref_path, dis_path, "-m", "ssimulacra2", "--output", "json",
             "--no-progress", "--device", str(dev)]
        )
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {
        "fused_scale0_yuv": scale_stats.fused_scale0_yuv.launches,
        "fused_pyramid_tail": scale_tail.fused_pyramid_tail.launches,
    }
    need(rc == 0, f"CLI exited {rc}")
    result = json.loads(out.getvalue())
    scores = result["ssimulacra2"]["scores"]
    need(result["frame_count"] == FRAMES and len(scores) == FRAMES, f"CLI did not score {FRAMES} frames")
    need(all(math.isfinite(s) for s in scores), f"non-finite CLI scores {scores}")
    log(f"CLI: {FRAMES} frames in {seconds:.2f} s (first call and decode included), launches {launches}")
    log(f"CLI scores: {scores}")
    return scores, launches


def load_batch(ref_path: str, dis_path: str, dev):
    """The first BATCH frame pairs as (2, B, h, w) / (2, B, ch, cw, 2) tensors."""
    from turbo_metrics_tpu_torch.io.y4m import Y4MFrameSource

    stacks = []
    for path in (ref_path, dis_path):
        src = Y4MFrameSource(open(path, "rb"), path=path)
        stacks.append([src.get_frame() for _ in range(BATCH)])
        src.close()
    y2 = np.stack([np.stack([f.y for f in fs]) for fs in stacks])
    uv2 = np.stack([np.stack([f.uv for f in fs]) for fs in stacks])
    return torch.from_numpy(y2).to(dev), torch.from_numpy(uv2).to(dev)


def check_close(name, got, want, rtol, atol) -> float:
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    need(not bool(bad.any()),
         f"{name}: {int(bad.sum())} values beyond rtol {rtol} / atol {atol}, max err {err.max().item():.3g}")
    return err.max().item()


def check_parity(y2, uv2, model, cli_scores):
    """Phase 5: each kernel against its plain twin on the same inputs at the
    main path's shapes; the kernel path's scores against the twins', the
    five-blur plain chain's and the CLI's.  Returns the max abs errors."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import (
        subscores_from_sums,
        ssimulacra2_subscores,
        ssimulacra2_subscores_from_yuv,
    )
    from turbo_metrics_tpu_torch.ops import colorspace
    from turbo_metrics_tpu_torch.ops.kernels import scale_stats, scale_tail

    taps, opsin, dims = model.taps, model.opsin, model.dims
    ns = len(dims)
    norms = scale_stats.norms_from_sums
    h0, w0 = dims[0]
    sums_k, lvl1_k = scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin)
    sums_p, lvl1_p = scale_stats.fused_scale0_yuv_ref(y2, uv2, taps, opsin)
    e1 = max(
        check_close("kernel 1 norms", norms(sums_k, h0 * w0), norms(sums_p, h0 * w0), 1e-4, 1e-5),
        check_close("kernel 1 level 1", lvl1_k, lvl1_p, 0.0, 1e-5),
    )
    tail_k = scale_tail.fused_pyramid_tail(lvl1_p, ns - 1, taps, opsin)
    tail_p = scale_tail.fused_pyramid_tail_ref(lvl1_p, ns - 1, taps, opsin)
    e2 = max(
        check_close(f"kernel 2 level {i + 1} norms", norms(tail_k[:, i], h * w),
                    norms(tail_p[:, i], h * w), 1e-4, 1e-5)
        for i, (h, w) in enumerate(dims[1:])
    )
    sub_k = ssimulacra2_subscores_from_yuv(y2, uv2, taps, opsin, num_scales=ns)
    sub_p = subscores_from_sums([sums_p] + list(tail_p.unbind(1)), dims)
    check_close("kernel path sub-scores", sub_k, sub_p, 1e-4, 1e-5)
    need(torch.equal(sub_k, ssimulacra2_subscores_from_yuv(y2, uv2, taps, opsin, num_scales=ns)),
         "kernel path sub-scores differ between two runs on the same input")
    lin = colorspace.yuv420_to_linear_rgb(y2, uv2)
    sub_chain = ssimulacra2_subscores(lin[0], lin[1], num_scales=ns)
    sc_k, sc_p, sc_c = (model.score(s) for s in (sub_k, sub_p, sub_chain))
    d_plain = float(np.abs(sc_k - sc_p).max())
    d_chain = float(np.abs(sc_k - sc_c).max())
    d_cli = float(np.abs(sc_k - np.asarray(cli_scores[:BATCH])).max())
    need(d_plain <= 0.01 and d_chain <= 0.01 and d_cli <= 0.01,
         f"scores apart: kernel vs twins {d_plain}, vs five-blur chain {d_chain}, vs CLI {d_cli}")
    log(f"kernel path scores {sc_k.tolist()}")
    log(f"max |score diff|: vs twins {d_plain:.3g}, vs five-blur plain chain {d_chain:.3g}, vs CLI {d_cli:.3g}")
    return e1, e2, lvl1_p


def check_other_formats(model) -> None:
    """Kernel paths the 1080p pair does not reach (u16 planes, the other
    transfers, full range, odd sizes) against the twins, on seeded
    independent random pairs at 2x67x99."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import (
        ssimulacra2_subscores_from_yuv,
        subscores_from_sums,
    )
    from turbo_metrics_tpu_torch.ops.downscale import scale_dims
    from turbo_metrics_tpu_torch.ops.kernels import scale_stats, scale_tail

    rng = np.random.default_rng(7)
    h, w = 67, 99
    dims = scale_dims(h, w)
    for depth, matrix, transfer, full in (
        (10, "bt2020", "pq", False), (10, "bt709", "hlg", True),
        (8, "bt601_625", "srgb", True), (12, "bt709", "linear", False),
    ):
        dt = np.uint8 if depth == 8 else np.uint16
        hi = 1 << depth
        y2 = torch.from_numpy(rng.integers(0, hi, (2, 2, h, w)).astype(dt)).to(model.device)
        uv2 = torch.from_numpy(
            rng.integers(0, hi, (2, 2, (h + 1) // 2, (w + 1) // 2, 2)).astype(dt)
        ).to(model.device)
        kw = dict(depth=depth, matrix=matrix, transfer=transfer, full_range=full)
        sub_k = ssimulacra2_subscores_from_yuv(y2, uv2, model.taps, model.opsin, num_scales=len(dims), **kw)
        s0, l1 = scale_stats.fused_scale0_yuv_ref(y2, uv2, model.taps, model.opsin, **kw)
        rest = scale_tail.fused_pyramid_tail_ref(l1, len(dims) - 1, model.taps, model.opsin)
        sub_p = subscores_from_sums([s0] + list(rest.unbind(1)), dims)
        err = check_close(f"{depth}-bit {matrix} {transfer} full={full}", sub_k, sub_p, 1e-4, 1e-5)
        log(f"{depth}-bit {matrix} {transfer} full={full} {h}x{w}: max abs err {err:.3g}")


def check_golden(dev) -> float:
    """Phase 6: the frozen golden pair through the kernel route."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2

    g_ref, g_dis = golden_pair()
    golden = Ssimulacra2(160, 120, device=dev).score_pair(g_ref, g_dis)
    need(abs(golden - GOLDEN) <= 0.05, f"golden pair {golden} vs {GOLDEN}")
    log(f"golden pair: {golden:.6f} (frozen {GOLDEN}, budget 0.05)")
    return golden


def main() -> int:
    try:
        from turbo_metrics_tpu_torch.models.ssimulacra2 import (
            Ssimulacra2,
            ssimulacra2_subscores_from_yuv,
        )
        from turbo_metrics_tpu_torch.ops.kernels import _build, scale_stats, scale_tail
    except ImportError as e:
        log(f"chip_smoke: cannot import the port ({e}); run it from the repository root")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
        return 2

    # Phase 1: the card.
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = [f"nvidia-smi failed: {e}"]
    card = smi[0] if smi else "nvidia-smi printed nothing"
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # Phase 2: build.
    t0 = time.monotonic()
    _build.LIBRARY.get()
    log(f"kernels built and loaded in {time.monotonic() - t0:.2f} s (nvcc {_build.LIBRARY.build_seconds:.2f} s)")
    for ln in _build.LIBRARY.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"  ptxas: {ln.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    with tempfile.TemporaryDirectory(prefix="tm_smoke_") as tmp:
        t0 = time.monotonic()
        ref_path, dis_path = write_y4m_pair(tmp)
        log(f"wrote {FRAMES}-frame {WIDTH}x{HEIGHT} Y4M pair in {time.monotonic() - t0:.1f} s")
        cli_scores, launches = run_main_path(ref_path, dis_path, dev)
        need(all(v > 0 for v in launches.values()), f"a kernel was not launched on the main path: {launches}")
        y2, uv2 = load_batch(ref_path, dis_path, dev)

    model = Ssimulacra2(WIDTH, HEIGHT, device=dev)
    taps, opsin, ns = model.taps, model.opsin, model.num_scales
    with torch.no_grad():
        e1, e2, lvl1 = check_parity(y2, uv2, model, cli_scores)
        check_other_formats(model)
        check_golden(dev)

        # Phase 7: timing (device time by CUDA events, after warm-up).
        def kernel_step():
            return ssimulacra2_subscores_from_yuv(y2, uv2, taps, opsin, num_scales=ns)

        def plain_step():
            _, l1 = scale_stats.fused_scale0_yuv_ref(y2, uv2, taps, opsin)
            return scale_tail.fused_pyramid_tail_ref(l1, ns - 1, taps, opsin)

        k1_ms = time_ms(lambda: scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin), 20)
        k1_plain_ms = time_ms(lambda: scale_stats.fused_scale0_yuv_ref(y2, uv2, taps, opsin), 5)
        k2_ms = time_ms(lambda: scale_tail.fused_pyramid_tail(lvl1, ns - 1, taps, opsin), 20)
        k2_plain_ms = time_ms(lambda: scale_tail.fused_pyramid_tail_ref(lvl1, ns - 1, taps, opsin), 5)
        # Kernel, plain, plain, kernel: the spread within this run.
        step_ms = [time_ms(kernel_step, 20)]
        plain_ms = [time_ms(plain_step, 5), time_ms(plain_step, 5)]
        step_ms.append(time_ms(kernel_step, 20))

    mpx = WIDTH * HEIGHT / 1e6
    for name, runs in (("kernel step", step_ms), ("plain step", plain_ms)):
        log(
            f"{name} B={BATCH} {WIDTH}x{HEIGHT}: "
            + " / ".join(f"{t:.3f} ms = {BATCH * 1e3 / t:.1f} fps = {BATCH * mpx * 1e3 / t:.1f} Mpx/s" for t in runs)
            + f" [{card}]"
        )
    log(f"kernel 1: {k1_ms:.3f} ms vs plain {k1_plain_ms:.3f} ms; "
        f"kernel 2: {k2_ms:.3f} ms vs plain {k2_plain_ms:.3f} ms [{card}]")
    log(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": "fused_scale0_yuv",
            "route": "cuda",
            "source": SOURCE,
            "replaces": "turbo_metrics_tpu/ops/pallas/scale_stats.py:1985",
            "launches": launches["fused_scale0_yuv"],
            "max_abs_err": e1,
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
        },
        {
            "name": "fused_pyramid_tail",
            "route": "cuda",
            "source": SOURCE,
            "replaces": "turbo_metrics_tpu/ops/pallas/scale_tail.py:243",
            "launches": launches["fused_pyramid_tail"],
            "max_abs_err": e2,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
        },
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"chip_smoke FAILED: {e}")
        sys.exit(1)
