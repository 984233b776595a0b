#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (turbo_metrics_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from turbo_metrics_tpu_torch/csrc with nvcc;
  3. write a seeded 1080p 8-bit 4:2:0 BT.709 limited-range Y4M pair
     (16 frames, noise on a smooth base) to a temporary directory;
  4. score it through the port's CLI (-m ssimulacra2 --output json), every
     launch counter reset just before and read just after: 16 finite
     scores, kernels 1 and 2 launched;
  4a. score it through the multi-metric route (-m ssimulacra2 -m psnr -m ssim
     -m msssim), counters reset just before and read just after: 16 finite
     values of each metric, kernels #6, #3, #11, #12 and 2 launched,
     SSIMULACRA2 within 1e-3 of phase 4's scores;
  5. hold each kernel against its plain PyTorch twin on the card at the main
     path's shapes (batch 8): sub-scores rtol 1e-4 / atol 1e-5, the emitted
     level 1 atol 1e-5, frame scores within 0.01 (also against the CLI's),
     and the same sub-scores from a second run; then the kernel path at
     other depths, transfers and ranges on small odd-sized pairs;
  5a. the same for the multi-metric kernels: conversion atol 1e-6, kernel #3
     as kernel 2, SSIM sums rtol 1e-5 with the emitted level 1 exactly equal,
     the MS-SSIM tail rtol 1e-5; per frame, the kernel route against the
     plain route and the CLI: PSNR 1e-4 dB, SSIM and MS-SSIM 1e-5,
     SSIMULACRA2 0.01; then a small odd-sized pair with an 8-bit reference
     and a 10-bit distorted stream, engine on the card against engine on
     the CPU;
  6. score the frozen golden pair through the kernel route: 80.486135 +- 0.05;
  7. time each kernel and its twin, the whole kernel and plain steps of both
     routes, with CUDA events after warm-up, and both CLI runs again warm.
Prints the card, then one JSON line of per-kernel results (with each
kernel's bound: the larger of its bytes over 3.35 TB/s and its f32
operations over 67 TFLOP/s, the H100 SXM data-sheet peaks), then as the
last line {"ok": true, "device": {...}}.  Without CUDA, or outside the
repository, it exits non-zero and prints no result.  Imports nothing of JAX.
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
CSRC = "turbo_metrics_tpu_torch/csrc/"
MULTI = ("ssimulacra2", "psnr", "ssim", "msssim")
MS_LEVELS = 5
# H100 SXM data-sheet peaks: device memory, and f32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations per pixel (an FMA counts 2, a pow, cube root or rounding 1):
F_CONVERT = 30  # one image: luma 3, per channel add, pow-form EOTF ~6, clamp 2
F_XYB = 59  # one image: opsin mix 24, three refined cube roots 21, XYB 10, 2x2 mean 4
F_S2 = 205  # per channel of the pair: products 3, two 11-tap passes over 4 planes 176, maps 26
F_QUANT = 8  # per channel of the pair: x*255, round, two clamps, both images
F_SSIM_ROW = 92  # per channel of the pair: a^2+b^2 and a*b 4, 11 taps over 4 planes 88
F_SSIM_COL = 104  # per valid pixel and channel: 11 taps over 4 planes 88, the map 16
F_HALFPOOL = 8  # per emitted pixel and channel: 3 adds and a scale, both images


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


def counted_kernels() -> dict:
    """Every kernel wrapper, by name: each counts its own launches."""
    from turbo_metrics_tpu_torch.ops.kernels import (
        convert,
        scale_stats,
        scale_tail,
        windowed,
        windowed_tail,
    )

    return {
        "fused_scale0_yuv": scale_stats.fused_scale0_yuv,
        "fused_pyramid_tail": scale_tail.fused_pyramid_tail,
        "fused_scale_rgb": scale_stats.fused_scale_rgb,
        "yuv420_to_linear_rgb_pair": convert.yuv420_to_linear_rgb_pair,
        "ssim_sums": windowed.ssim_sums,
        "msssim_tail": windowed_tail.msssim_tail,
    }


def run_cli(ref_path: str, dis_path: str, dev, metrics):
    """The port's CLI on the Y4M pair (--output json), every launch counter
    set to 0 just before and read just after.  Returns (per-metric scores,
    launches, host seconds)."""
    from turbo_metrics_tpu_torch import cli

    kernels = counted_kernels()
    for fn in kernels.values():
        fn.launches = 0
    args = [ref_path, dis_path, "--output", "json", "--no-progress", "--device", str(dev)]
    for m in metrics:
        args += ["-m", m]
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    need(rc == 0, f"CLI ({' '.join(metrics)}) exited {rc}")
    result = json.loads(out.getvalue())
    need(result["frame_count"] == FRAMES, f"CLI did not score {FRAMES} frames")
    scores = {}
    for m in metrics:
        vals = result[m]["scores"]
        need(len(vals) == FRAMES and all(math.isfinite(v) for v in vals),
             f"CLI {m}: want {FRAMES} finite values, got {vals}")
        scores[m] = np.asarray(vals, dtype=np.float64)
    return scores, launches, seconds


def run_main_path(ref_path: str, dis_path: str, dev, card: str):
    """Phase 4: SSIMULACRA2 alone through the CLI (kernels 1 and 2)."""
    scores, launches, seconds = run_cli(ref_path, dis_path, dev, ["ssimulacra2"])
    log(f"CLI -m ssimulacra2: {FRAMES} frames in {seconds:.2f} s (first call and decode included), "
        f"launches {launches} [{card}]")
    log(f"CLI scores: {scores['ssimulacra2'].tolist()}")
    need(launches["fused_scale0_yuv"] > 0 and launches["fused_pyramid_tail"] > 0,
         f"a kernel of the SSIMULACRA2 route was not launched: {launches}")
    return scores["ssimulacra2"], launches


def run_multi_path(ref_path: str, dis_path: str, dev, card: str, s2_scores):
    """Phase 4a: the four RGB families through the CLI (kernels #6, #3, #11,
    #12 and 2); SSIMULACRA2 within 1e-3 of the SSIMULACRA2-only route."""
    scores, launches, seconds = run_cli(ref_path, dis_path, dev, MULTI)
    log(f"CLI {' '.join('-m ' + m for m in MULTI)}: {FRAMES} frames in {seconds:.2f} s "
        f"(first call and decode included), launches {launches} [{card}]")
    for m in MULTI:
        log(f"CLI {m}: {scores[m].tolist()}")
    path = ("yuv420_to_linear_rgb_pair", "fused_scale_rgb", "ssim_sums", "msssim_tail",
            "fused_pyramid_tail")
    need(all(launches[k] > 0 for k in path), f"a kernel of the multi-metric route was not launched: {launches}")
    d_s2 = float(np.abs(scores["ssimulacra2"] - s2_scores).max())
    log(f"multi-metric route vs SSIMULACRA2-only route: max |score diff| {d_s2:.3g}")
    need(d_s2 <= 1e-3, f"SSIMULACRA2 of the two routes apart by {d_s2}")
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


def check_multi_parity(y2, uv2, model, qmod, cli_scores):
    """Phase 5a: each multi-metric kernel against its twin on the same
    inputs at the main path's shapes, then the kernel route's per-frame
    values against the plain route's and the CLI's.  Returns the max abs
    errors by kernel, the converted pair buffer and the emitted level 1."""
    from turbo_metrics_tpu_torch.ops import quality
    from turbo_metrics_tpu_torch.ops.kernels import convert, scale_stats, windowed, windowed_tail

    taps, opsin, win, dims = model.taps, model.opsin, qmod.window, model.dims
    h0, w0 = dims[0]
    norms = scale_stats.norms_from_sums
    err = {}
    p_k = convert.yuv420_to_linear_rgb_pair(y2, uv2)
    p12 = convert.yuv420_to_linear_rgb_pair_ref(y2, uv2)
    err["yuv420_to_linear_rgb_pair"] = check_close("conversion", p_k, p12, 0.0, 1e-6)
    s_k, l_k = scale_stats.fused_scale_rgb(p12, taps, opsin)
    s_p, l_p = scale_stats.fused_scale_rgb_ref(p12, taps, opsin)
    err["fused_scale_rgb"] = max(
        check_close("kernel #3 norms", norms(s_k, h0 * w0), norms(s_p, h0 * w0), 1e-4, 1e-5),
        check_close("kernel #3 level 1", l_k, l_p, 0.0, 1e-5),
    )
    ss_k, ds_k = windowed.ssim_sums(p12, win, quantize=True, emit_ds=True)
    ss_p, ds_p = windowed.ssim_sums_ref(p12, win, quantize=True, emit_ds=True)
    err["ssim_sums"] = check_close("SSIM sums", ss_k, ss_p, 1e-5, 0.0)
    need(torch.equal(ds_k, ds_p), "the emitted MS-SSIM level 1 differs from the twin's")
    lv, _ = quality._clamp_levels(h0, w0, MS_LEVELS)
    t_k = windowed_tail.msssim_tail(ds_p, lv - 1, win)
    t_p = windowed_tail.msssim_tail_ref(ds_p, lv - 1, win)
    err["msssim_tail"] = check_close("MS-SSIM tail sums", t_k, t_p, 1e-5, 0.0)

    got = multi_step_kernel(y2, uv2, model, qmod)
    want = multi_step_plain(y2, uv2, model)
    for name, tol in (("psnr", 1e-4), ("ssim", 1e-5), ("msssim", 1e-5), ("ssimulacra2", 0.01)):
        d_plain = float(np.abs(got[name] - want[name]).max())
        d_cli = float(np.abs(got[name] - cli_scores[name][:BATCH]).max())
        log(f"{name}: kernel route {got[name].tolist()}")
        log(f"{name}: max |diff| vs plain route {d_plain:.3g}, vs CLI {d_cli:.3g} (tolerance {tol})")
        need(d_plain <= tol and d_cli <= tol, f"{name}: kernel route vs plain {d_plain}, vs CLI {d_cli}")
    return err, p12, ds_p


def multi_step_kernel(y2, uv2, model, qmod) -> dict:
    """The multi-metric device step through the kernels, per-frame values."""
    from turbo_metrics_tpu_torch.ops.kernels import convert

    p12 = convert.yuv420_to_linear_rgb_pair(y2, uv2)
    out = qmod.from_rgb(p12, psnr=True, ssim=True, msssim=True)
    out["ssimulacra2"] = model.score(model.subscores_from_rgb(p12))
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v, dtype=np.float64) for k, v in out.items()}


def multi_step_plain(y2, uv2, model) -> dict:
    """The same step through the plain twins: conversion, the jnp
    formulation of PSNR / SSIM / MS-SSIM on the quantized pair, and the
    SSIMULACRA2 level twins."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import subscores_from_sums
    from turbo_metrics_tpu_torch.ops import quality
    from turbo_metrics_tpu_torch.ops.colorspace import f32_to_uint8
    from turbo_metrics_tpu_torch.ops.kernels import convert, scale_stats, scale_tail

    p12 = convert.yuv420_to_linear_rgb_pair_ref(y2, uv2)
    q = f32_to_uint8(p12, torch.float32)
    out = {"psnr": quality.psnr(q[0], q[1])}
    out["ssim"], out["msssim"] = quality.ssim_msssim(q[0], q[1], levels=MS_LEVELS)
    s0, l1 = scale_stats.fused_scale_rgb_ref(p12, model.taps, model.opsin)
    tail = scale_tail.fused_pyramid_tail_ref(l1, model.num_scales - 1, model.taps, model.opsin)
    out["ssimulacra2"] = model.score(subscores_from_sums([s0] + list(tail.unbind(1)), model.dims))
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v, dtype=np.float64) for k, v in out.items()}


def check_mixed_spec(dev) -> None:
    """A pair whose two inputs differ (8-bit reference, 10-bit distorted) on
    a small odd-sized frame: the engine on the card (one conversion launch
    per image into its slot) against the engine on the CPU (the twins)."""
    from turbo_metrics_tpu_torch.color.characteristics import height_fallback
    from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics
    from turbo_metrics_tpu_torch.io.frame_source import RawFrame

    rng = np.random.default_rng(11)
    h, w, n = 67, 99, 2
    ref, dis = [], []
    for _ in range(n):
        y = rng.integers(16, 236, (h, w))
        uv = rng.integers(16, 241, ((h + 1) // 2, (w + 1) // 2, 2))
        ref.append(RawFrame(y=y.astype(np.uint8), uv=uv.astype(np.uint8), depth=8))
        dis.append(RawFrame(
            y=np.clip(y * 4 + rng.integers(-12, 13, y.shape), 0, 1023).astype(np.uint16),
            uv=np.clip(uv * 4 + rng.integers(-12, 13, uv.shape), 0, 1023).astype(np.uint16),
            depth=10,
        ))
    cc = (height_fallback(h), "limited")
    metrics = Metrics(**{m: True for m in MULTI})
    conv = counted_kernels()["yuv420_to_linear_rgb_pair"]
    before = conv.launches
    got = TurboMetrics(w, h, metrics, batch=n, device=dev).compute_frames(ref, cc, dis, cc)
    need(conv.launches - before == 2, f"mixed specs: {conv.launches - before} conversion launches, want 2")
    want = TurboMetrics(w, h, metrics, batch=n, device="cpu").compute_frames(ref, cc, dis, cc)
    for name, tol in (("psnr", 1e-4), ("ssim", 1e-5), ("msssim", 1e-5), ("ssimulacra2", 0.01)):
        g = np.array([getattr(s, name) for s in got])
        wv = np.array([getattr(s, name) for s in want])
        d = float(np.abs(g - wv).max())
        log(f"mixed 8/10-bit {h}x{w} {name}: card {g.tolist()}, max |diff| vs CPU {d:.3g}")
        need(np.isfinite(g).all() and d <= tol, f"mixed specs {name}: card {g} vs CPU {wv}")


def s2_level_flops(bsz: int, h: int, w: int) -> float:
    return bsz * h * w * (2 * F_XYB + 3 * F_S2)


def ssim_level_flops(bsz: int, h: int, w: int, quantize: bool, emit: bool) -> float:
    per_plane = (
        h * w * (F_QUANT if quantize else 0) + h * (w - 10) * F_SSIM_ROW
        + (h - 10) * (w - 10) * F_SSIM_COL + ((h // 2) * (w // 2) * F_HALFPOOL if emit else 0)
    )
    return 3 * bsz * per_plane


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nb: float, flops: float):
    """(least ms, what bounds it): bytes over the memory rate or f32
    operations over the f32 rate, whichever takes longer."""
    t_bytes, t_ops = nb / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        from turbo_metrics_tpu_torch.ops import quality
        from turbo_metrics_tpu_torch.ops.kernels import (
            _build,
            convert,
            scale_stats,
            scale_tail,
            windowed,
            windowed_tail,
        )
        from turbo_metrics_tpu_torch.ops.quality import Quality
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
    log(f"kernels built and loaded in {time.monotonic() - t0:.2f} s "
        f"(nvcc {_build.LIBRARY.build_seconds:.2f} s) [{card}]")
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
        cli_scores, launches = run_main_path(ref_path, dis_path, dev, card)
        multi_scores, multi_launches = run_multi_path(ref_path, dis_path, dev, card, cli_scores)
        y2, uv2 = load_batch(ref_path, dis_path, dev)
        # Phase 7, CLI part: both routes again, warm.
        cli_warm_s = run_cli(ref_path, dis_path, dev, ["ssimulacra2"])[2]
        multi_warm_s = run_cli(ref_path, dis_path, dev, MULTI)[2]

    model = Ssimulacra2(WIDTH, HEIGHT, device=dev)
    qmod = Quality(device=dev)
    taps, opsin, ns, win = model.taps, model.opsin, model.num_scales, qmod.window
    with torch.no_grad():
        e1, e2, lvl1 = check_parity(y2, uv2, model, cli_scores)
        check_other_formats(model)
        multi_err, p12, ms_l1 = check_multi_parity(y2, uv2, model, qmod, multi_scores)
        check_mixed_spec(dev)
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

        lv, _ = quality._clamp_levels(HEIGHT, WIDTH, MS_LEVELS)
        k6_ms = time_ms(lambda: convert.yuv420_to_linear_rgb_pair(y2, uv2), 20)
        k6_plain_ms = time_ms(lambda: convert.yuv420_to_linear_rgb_pair_ref(y2, uv2), 5)
        k3_ms = time_ms(lambda: scale_stats.fused_scale_rgb(p12, taps, opsin), 20)
        k3_plain_ms = time_ms(lambda: scale_stats.fused_scale_rgb_ref(p12, taps, opsin), 5)
        k11_ms = time_ms(lambda: windowed.ssim_sums(p12, win, quantize=True, emit_ds=True), 20)
        k11_plain_ms = time_ms(lambda: windowed.ssim_sums_ref(p12, win, quantize=True, emit_ds=True), 5)
        k12_ms = time_ms(lambda: windowed_tail.msssim_tail(ms_l1, lv - 1, win), 20)
        k12_plain_ms = time_ms(lambda: windowed_tail.msssim_tail_ref(ms_l1, lv - 1, win), 5)
        psnr_ms = time_ms(lambda: qmod.from_rgb(p12, psnr=True), 20)
        multi_ms = [time_ms(lambda: multi_step_kernel(y2, uv2, model, qmod), 10)]
        multi_plain_ms = [time_ms(lambda: multi_step_plain(y2, uv2, model), 3) for _ in range(2)]
        multi_ms.append(time_ms(lambda: multi_step_kernel(y2, uv2, model, qmod), 10))

    mpx = WIDTH * HEIGHT / 1e6
    for name, runs in (
        ("kernel step", step_ms), ("plain step", plain_ms),
        ("multi-metric kernel step", multi_ms), ("multi-metric plain step", multi_plain_ms),
    ):
        log(
            f"{name} B={BATCH} {WIDTH}x{HEIGHT}: "
            + " / ".join(f"{t:.3f} ms = {BATCH * 1e3 / t:.1f} fps = {BATCH * mpx * 1e3 / t:.1f} Mpx/s" for t in runs)
            + f" [{card}]"
        )
    log(f"PSNR (plain torch expression on the pair buffer) {psnr_ms:.3f} ms [{card}]")
    log(f"CLI warm, {FRAMES} frames: -m ssimulacra2 {cli_warm_s * 1e3:.1f} ms, "
        f"multi-metric {multi_warm_s * 1e3:.1f} ms (host clock) [{card}]")

    # Bounds from this run's shapes: bytes each input read once and each
    # output written once, f32 operations of the algorithm (F_* above).
    _, bsz, h, w = y2.shape
    mh1, mw1 = ms_l1.shape[-2:]
    dims_s2 = model.dims
    s0_out = torch.empty(bsz, 3, 6)
    rows = [
        ("fused_scale0_yuv", "ssimulacra2_scale.cu", "scale_stats.py:1985", launches, e1, k1_ms,
         k1_plain_ms, nbytes(y2, uv2, lvl1, s0_out),
         bsz * h * w * 2 * F_CONVERT + s2_level_flops(bsz, h, w)),
        ("fused_pyramid_tail", "ssimulacra2_scale.cu", "scale_tail.py:243", launches, e2, k2_ms,
         k2_plain_ms, nbytes(lvl1) + (ns - 1) * nbytes(s0_out),
         sum(s2_level_flops(bsz, lh, lw) for lh, lw in dims_s2[1:])),
        ("fused_scale_rgb", "ssimulacra2_scale.cu", "scale_stats.py:2552", multi_launches,
         multi_err["fused_scale_rgb"], k3_ms, k3_plain_ms, nbytes(p12, lvl1, s0_out),
         s2_level_flops(bsz, h, w)),
        ("yuv420_to_linear_rgb_pair", "convert.cu", "convert.py:404", multi_launches,
         multi_err["yuv420_to_linear_rgb_pair"], k6_ms, k6_plain_ms, nbytes(y2, uv2, p12),
         bsz * h * w * 2 * F_CONVERT),
        ("ssim_sums", "windowed.cu", "windowed.py:400", multi_launches, multi_err["ssim_sums"],
         k11_ms, k11_plain_ms, nbytes(p12, ms_l1) + bsz * 3 * 2 * 4,
         ssim_level_flops(bsz, h, w, True, True)),
        ("msssim_tail", "windowed.cu", "windowed_tail.py:376", multi_launches,
         multi_err["msssim_tail"], k12_ms, k12_plain_ms, nbytes(ms_l1) + bsz * (lv - 1) * 3 * 2 * 4,
         sum(ssim_level_flops(bsz, mh1 >> i, mw1 >> i, False, i + 2 < lv) for i in range(lv - 1))),
    ]
    kernels = []
    for name, src_file, replaces, counts, err, ms, pms, nb, flops in rows:
        bound_ms, bound_by = bound(nb, flops)
        log(f"{name}: {ms:.3f} ms vs plain {pms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({nb / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), launches {counts[name]}, "
            f"max abs err {err:.3g} [{card}]")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": CSRC + src_file,
            "replaces": "turbo_metrics_tpu/ops/pallas/" + replaces,
            "launches": counts[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": pms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # No single PyTorch call computes any of these functions.
            "library_ms": None,
        })
    log(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB [{card}]")

    print(card)
    print(json.dumps({"kernels": kernels}))
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
