"""Dissect the cost of the level kernels: each CUDA kernel's device time.

The port's counterpart of the JAX package's tools/kernel_dissect.py, which
times the fused-scale kernel against stripped-down variants to find where
the time goes.  On the card it times, at that tool's shape (B=4, 1080x1920,
``lin1`` uniform in [0, 1) from ``default_rng(0)``, ``lin2 = lin1 * 0.99``),
the same four lines:

  * "scale0 full (with ds)": #3 ``fused_scale_rgb`` on the pair, the next
    level emitted;
  * "scale0 no-ds": the same without emission;
  * "scale0 v1 (xyb outside)": #8 ``scale_sums`` on XYB computed beforehand;
  * "blur-only (15 planes x 2 passes)": #19 ``blur_only`` on ``lin1``;

and beside them kernel 1 (``fused_scale0_yuv`` on a seeded 8-bit 4:2:0
pair), kernel 2 (``fused_pyramid_tail`` from #3's emitted level, one entry
per level), #10, #11 (with and without the next level), #12, #14, #15 and
#18 on the same inputs, #6 (``yuv420_to_linear_rgb_pair``) on kernel 1's
8-bit 4:2:0 pair, #5 (``yuv_to_linear_rgb``) on a seeded 10-bit 4:2:2
batch, XPSNR's #13 (``xpsnr_block_stats``) on the pair's luma and on
that 10-bit luma against the 8-bit one (path (c)'s instance), VMAF
motion's #16 (``motion_stats``, with the memset that zeroes its row sums)
on its reference luma and #17 (``integer_blur``) on one frame of it, the
fixed-point VIF and ADM kernels (``integer_vif_stats``, ``integer_adm_stats``;
no TPU kernel stands behind them) on the pair's 8-bit luma codes, one entry
per launch (launch 1 is scale or level 0), and #4 (``fused_tail``) on three levels from the pair's
level 2 (at 1080p the size of a 4K level 3) and on four levels of a seeded
pair at twice the batch and a third of the frame (at the defaults the
1440p chain: B=8, levels 2-5 from 360x640).  Each call is timed by CUDA
events after warm-up (the median of ``REPEATS`` runs of ``--iters`` calls:
a call's host time swings with the load on the host), and every CUDA
kernel it launches by torch.profiler, in launch order: the device time of
each pass without the wrapper's host time or the gaps between launches.
On the CPU the wrappers run their plain twins: the tool reports
host-clock times and no device times.  Run:

    python -m turbo_metrics_tpu_torch.tools.kernel_dissect                # on the card
    python -m turbo_metrics_tpu_torch.tools.kernel_dissect --device cpu \\
        --batch 1 --height 48 --width 64 --iters 1                        # the twins
    python -m turbo_metrics_tpu_torch.tools.kernel_dissect --batch 8 --only '#13'   # some entries

It prints a readable line per entry and, last, one JSON object
``{"dissect": [{"entry", "wrapper", "kernel", "device_ms",
"launches_per_call", "call_ms"}, ...]}``, one row per kernel of an entry
(``device_ms``: the sum over that kernel's launches in one call), which
``main`` also returns.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from collections import Counter
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

# The profiler reading and the timer live in utils/profiling.py; MEMSET names
# the memsets of the probes that list it (#16 zeroes its row sums before its
# kernel adds into them), left out of the others' readings.
from turbo_metrics_tpu_torch.utils.profiling import MEMSET, cuda_kernel_records, kernel_name, time_ms

# The kernels of one SSIMULACRA2 level after its conversion pass
# (csrc/ssimulacra2_scale.cu): the fused level pass, the f64 reduction.
LEVEL = ("level_tile_kernel", "reduce_parts_kernel")
# One SSIM level (csrc/windowed.cu) and one VIF scale (csrc/vif.cu): the
# fused tile kernel (both passes, the map, the next level), the reduction.
SSIM_LEVEL = ("ssim_tile_kernel", "reduce_parts_kernel")
VIF_LEVEL = ("vif_tile_kernel", "reduce_frames_kernel")
# One ADM level (csrc/adm.cu): the fused tile kernel (DWT, gate, CSF, mask,
# cubes, the next level's A bands), the reduction.
ADM_LEVEL = ("adm_tile_kernel", "reduce_frames_kernel")
# One scale of the fixed-point VIF (csrc/integer_vif.cu) and one level of the
# fixed-point ADM (csrc/integer_adm.cu): the tile kernel, the reduction.
INT_VIF_LEVEL = ("integer_vif_kernel", "reduce_frames_kernel")
INT_ADM_LEVEL = ("integer_adm_kernel", "reduce_frames_kernel")
# VMAF motion (csrc/motion.cu) and the small SSIMULACRA2 levels in one
# cooperative launch (csrc/ssimulacra2_tail.cu): one kernel each.
MOTION = ("motion_kernel",)
TAIL = ("fused_tail_kernel",)
# Timed runs of ``--iters`` calls per entry; the call time is their median.
REPEATS = 5
# Profiler readings of one entry that keep fewer than half their calls whole
# before that is an error.
PROFILE_ATTEMPTS = 3
# The mark before each profiled call: the kernel of torch.cuda._sleep
# (ATen's spin_kernel), named so that a reading finds its marks among its own
# records.
MARK_KERNEL = "spin_kernel"
# What opens a reading before its first call: marks of a few cycles, then one
# mark of this many cycles (~5 ms on an H100).  The profiler has lost the
# head of a reading, up to the records of eight calls; what it loses there
# falls on these instead.
PAD_MARKS, PAD_CYCLES = 16, 10_000_000

@dataclass(frozen=True)
class Probe:
    """One timed call.  ``entry`` names it; with ``parts`` > 1 the call's
    launches split, in launch order, into that many equal parts (levels
    1, 2, ...), each an entry of its own named ``entry.format(level)``.
    ``kernels``: (name, launches) of one part."""

    entry: str
    wrapper: str
    fn: Callable
    kernels: tuple
    parts: int = 1


def once(*names) -> tuple:
    return tuple((n, 1) for n in names)


def levels(count: int, names) -> tuple:
    """The kernels of ``count`` levels that each launch ``names``."""
    return tuple((n, count) for n in names)


def base_name(raw: str) -> str:
    return kernel_name(raw).split("<", 1)[0]


class ProfileMismatch(RuntimeError):
    """The profiler's kernel records of an entry's calls do not repeat."""


def split_calls(records: list, marks: set, expect: int | None = None) -> list:
    """The records [(kernel name, ms)] of one profiler reading, in launch
    order, split into calls at the marks (the records named in ``marks``):
    the calls that kept all ``expect`` records (where None, the most common
    count).  The profiler now and then drops a kernel record: a call that
    lost one is left out, and so are the two calls around a lost mark."""
    calls, call = [], []
    for rec in records + [None]:
        if rec is None or rec[0] in marks:
            calls.append(call)
            call = []
        else:
            call.append(rec)
    calls = [c for c in calls if c]
    if expect is None and calls:
        expect = Counter(len(c) for c in calls).most_common(1)[0][0]
    return [c for c in calls if len(c) == expect]


def kernel_device_ms(fn, iters: int, expect: int | None = None, memsets: bool = False) -> list:
    """Device time of each CUDA kernel that one fn() call launches, in launch
    order, as [(kernel name, ms)]: the mean over the whole calls of a
    torch.profiler reading of ``iters`` calls (``split_calls``; ``expect``:
    the launches of one call, where known), with its memsets as kernels
    named ``MEMSET`` where ``memsets``.  A reading that keeps fewer than
    half its calls is taken again, up to ``PROFILE_ATTEMPTS`` readings; then
    it raises, as where the calls launch different kernels."""
    for _ in range(PROFILE_ATTEMPTS):
        records, marks = _profile_calls(fn, iters)
        kept = [r for r in records if memsets or r[0] != MEMSET]
        calls = split_calls(kept, marks, expect)
        if 2 * len(calls) >= iters:
            break
        print(f"profiler reading taken again: {len(calls)} of {iters} calls kept all their kernel records: "
              + describe_reading(kept, marks, expect), file=sys.stderr, flush=True)
    else:
        raise ProfileMismatch(f"{len(calls)} of {iters} calls kept all their kernel records: "
                              + describe_reading(kept, marks, expect))
    first = [n for n, _ in calls[0]]
    for call in calls[1:]:
        if [n for n, _ in call] != first:
            raise ProfileMismatch(f"the calls launched different kernels: {[n for n, _ in call]} "
                                  f"where the first launched {first}")
    return [(n, sum(call[i][1] for call in calls) / len(calls)) for i, n in enumerate(first)]


def describe_reading(records: list, marks: set, expect) -> str:
    """What a reading that kept too few calls held: the marks, how many
    records each span between marks held, the names of the records, and
    the first span of another length than ``expect`` (where given)."""
    spans, span = [], []
    for rec in records:
        if rec[0] in marks:
            spans.append(span)
            span = []
        else:
            span.append(rec[0])
    spans.append(span)
    odd = next((s for s in spans[1:] if expect is not None and len(s) != expect), None)
    return (f"marks {sorted(marks)}, {len(records)} records, want {expect} per call; records between marks "
            f"{[len(s) for s in spans]}; names {dict(Counter(n for n, _ in records))}; first odd call {odd}")


def is_mark(name: str) -> bool:
    """Whether a profiler record's kernel name is the mark's."""
    return base_name(name).rsplit("::", 1)[-1] == MARK_KERNEL


def _profile_calls(fn, iters: int) -> tuple:
    """(the records of ``iters`` fn() calls, each after a mark: a spin
    kernel of a few cycles, the reading opened by the pad of marks
    ``PAD_MARKS`` and ``PAD_CYCLES``; the marks' names among the records,
    known by name: a reading of the marks alone, short as it is, can lose
    every record)."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(PAD_MARKS):
            torch.cuda._sleep(1)
        torch.cuda._sleep(PAD_CYCLES)
        for _ in range(iters):
            torch.cuda._sleep(1)
            fn()

    records = cuda_kernel_records(calls)
    return records, {n for n, _ in records if is_mark(n)}


def probes(batch: int, height: int, width: int, dev: torch.device) -> list:
    """The timed calls, on inputs made from seed 0 on ``dev``."""
    from turbo_metrics_tpu_torch.engine import vmaf_code_pair, vmaf_pair
    from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2
    from turbo_metrics_tpu_torch.ops import adm as adm_ops
    from turbo_metrics_tpu_torch.ops import quality
    from turbo_metrics_tpu_torch.ops import vif as vif_ops
    from turbo_metrics_tpu_torch.ops.downscale import downscale_by_2
    from turbo_metrics_tpu_torch.ops.kernels import (
        adm,
        blur_probe,
        convert,
        fused_tail,
        integer_adm,
        integer_vif,
        motion,
        scale_stats,
        scale_tail,
        vif,
        windowed,
        windowed_tail,
        xpsnr,
    )
    from turbo_metrics_tpu_torch.ops.xyb import linear_rgb_to_xyb

    b, h, w = batch, height, width
    rng = np.random.default_rng(0)
    lin1 = torch.from_numpy(rng.random((b, 3, h, w), dtype=np.float64).astype(np.float32)).to(dev)
    lin2 = lin1 * 0.99
    y2 = torch.from_numpy(rng.integers(16, 236, (2, b, h, w)).astype(np.uint8)).to(dev)
    uv2 = torch.from_numpy(
        rng.integers(16, 241, (2, b, (h + 1) // 2, (w + 1) // 2, 2)).astype(np.uint8)
    ).to(dev)
    model = Ssimulacra2(w, h, device=dev)
    qmod = quality.Quality(device=dev)
    taps, opsin, win = model.taps, model.opsin, qmod.window
    p12 = torch.stack([lin1, lin2])
    x1, x2 = (linear_rgb_to_xyb(x, opsin=opsin).contiguous() for x in (lin1, lin2))
    s2_lvl1 = scale_stats.fused_scale_rgb(p12, taps, opsin)[1]
    ms_lvl1 = windowed.ssim_sums(p12, win, quantize=True, emit_ds=True)[1]
    ms_levels = quality._clamp_levels(h, w, 5)[0] - 1
    pair = vmaf_pair(y2[0], y2[1], 8, 8)
    codes = vmaf_code_pair(y2[0], y2[1], 8, 8)
    vif_lvl1 = vif.vif_scale0(pair)[1]
    tail_levels = model.num_scales - 1
    rgb_level = once("rgb_to_xyb_kernel", *LEVEL)
    luma = y2[0]
    prev0 = motion.integer_blur(luma[:1])[0]
    s2_lvl2 = downscale_by_2(downscale_by_2(p12)).contiguous()
    # Twice the batch at a third of the frame: at the defaults 1440p's level
    # 2 (360x640) at its batch of 8, from which the level route sends four
    # levels to #4.
    p1440 = torch.from_numpy(
        rng.random((2, 2 * b, 3, -(-h // 3), -(-w // 3)), dtype=np.float64).astype(np.float32)).to(dev)
    # #5's input: a 10-bit 4:2:2 batch (the reference slot of a mezzanine
    # against its encode).
    y422 = torch.from_numpy(rng.integers(64, 941, (b, h, w)).astype(np.uint16)).to(dev)
    uv422 = torch.from_numpy(rng.integers(64, 961, (b, h, (w + 1) // 2, 2)).astype(np.uint16)).to(dev)
    return [
        Probe("scale0 full (with ds)", "fused_scale_rgb",
              lambda: scale_stats.fused_scale_rgb(p12, taps, opsin, emit_ds=True), rgb_level),
        Probe("scale0 no-ds", "fused_scale_rgb",
              lambda: scale_stats.fused_scale_rgb(p12, taps, opsin, emit_ds=False), rgb_level),
        Probe("scale0 v1 (xyb outside)", "scale_sums",
              lambda: scale_stats.scale_sums(x1, x2, taps), once(*LEVEL)),
        Probe("blur-only (15 planes x 2 passes)", "blur_only",
              lambda: blur_probe.blur_only(lin1, taps), once("blur_probe_kernel", "probe_reduce_kernel")),
        Probe("kernel 1 (4:2:0 pair)", "fused_scale0_yuv",
              lambda: scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin),
              once("yuv420_to_xyb_kernel", *LEVEL)),
        Probe("kernel 2 level {}", "fused_pyramid_tail",
              lambda: scale_tail.fused_pyramid_tail(s2_lvl1, tail_levels, taps, opsin), rgb_level,
              parts=tail_levels),
        Probe("#10 pair sums", "fused_scale_pair",
              lambda: scale_stats.fused_scale_pair(lin1, lin2, taps, opsin), rgb_level),
        Probe("#11 SSIM level 0", "ssim_sums",
              lambda: windowed.ssim_sums(p12, win, quantize=True, emit_ds=True), once(*SSIM_LEVEL)),
        Probe("#11 SSIM level 0 no-ds", "ssim_sums",
              lambda: windowed.ssim_sums(p12, win, quantize=True, emit_ds=False), once(*SSIM_LEVEL)),
        Probe("#12 MS-SSIM levels 1+", "msssim_tail",
              lambda: windowed_tail.msssim_tail(ms_lvl1, ms_levels, win),
              levels(ms_levels, SSIM_LEVEL)),
        Probe("#14 VIF scale 0", "vif_scale0", lambda: vif.vif_scale0(pair), once(*VIF_LEVEL)),
        Probe("#15 VIF scales 1-3", "vif_tail", lambda: vif.vif_tail(vif_lvl1),
              levels(vif_ops.NUM_SCALES - 1, VIF_LEVEL)),
        Probe("#18 ADM", "adm_stats", lambda: adm.adm_stats(pair), levels(adm_ops.NUM_LEVELS, ADM_LEVEL)),
        Probe("K-int-VIF launch {}", "integer_vif_stats", lambda: integer_vif.integer_vif_stats(codes),
              once(*INT_VIF_LEVEL), parts=vif_ops.NUM_SCALES),
        Probe("K-int-ADM launch {}", "integer_adm_stats", lambda: integer_adm.integer_adm_stats(codes),
              once(*INT_ADM_LEVEL), parts=adm_ops.NUM_LEVELS),
        Probe("#6 conversion (4:2:0 pair)", "yuv420_to_linear_rgb_pair",
              lambda: convert.yuv420_to_linear_rgb_pair(y2, uv2), once("yuv_to_rgb_kernel")),
        Probe("#5 conversion (10-bit 4:2:2)", "yuv_to_linear_rgb",
              lambda: convert.yuv_to_linear_rgb(y422, uv422, depth=10, chroma=422), once("yuv_to_rgb_kernel")),
        Probe("#13 XPSNR block stats (u8)", "xpsnr_block_stats",
              lambda: xpsnr.xpsnr_block_stats(luma, y2[1], luma[0]), once("xpsnr_kernel")),
        Probe("#13 XPSNR block stats (10-bit vs 8-bit)", "xpsnr_block_stats",
              lambda: xpsnr.xpsnr_block_stats(y422, luma, y422[0], dis_shift=2), once("xpsnr_kernel")),
        Probe("#16 motion (u8)", "motion_stats", lambda: motion.motion_stats(luma, prev0),
              once(MEMSET, *MOTION)),
        Probe("#17 motion blur (one frame)", "integer_blur", lambda: motion.integer_blur(luma[:1]),
              once(*MOTION)),
        Probe("#4 tail, 3 levels from level 2", "fused_tail",
              lambda: fused_tail.fused_tail(s2_lvl2, 3, taps, opsin), once(*TAIL)),
        Probe("#4 tail, 4 levels from a third of the frame (1440p levels 2-5)", "fused_tail",
              lambda: fused_tail.fused_tail(p1440, 4, taps, opsin), once(*TAIL)),
    ]


def dissect(probe: Probe, iters: int, dev: torch.device) -> list:
    """The rows of one probe: on the card each kernel's device time, checked
    against the kernels the probe expects; on the CPU none."""
    call_ms = statistics.median(time_ms(probe.fn, iters, dev) for _ in range(REPEATS))
    seq = None
    if dev.type == "cuda":
        try:
            seq = kernel_device_ms(probe.fn, iters, probe.parts * sum(c for _, c in probe.kernels),
                                   memsets=any(n == MEMSET for n, _ in probe.kernels))
        except ProfileMismatch as e:
            raise ProfileMismatch(f"{probe.entry}: {e}") from e
    if seq is not None and len(seq) % probe.parts:
        raise RuntimeError(f"{probe.entry}: {len(seq)} kernels in {probe.parts} equal parts")
    rows = []
    for part in range(probe.parts):
        entry = probe.entry.format(part + 1)
        chunk = None
        if seq is not None:
            size = len(seq) // probe.parts
            chunk = seq[part * size : (part + 1) * size]
            got = Counter(base_name(n) for n, _ in chunk)
            if got != Counter(dict(probe.kernels)):
                raise RuntimeError(f"{entry}: launched {dict(got)}, want {dict(probe.kernels)}")
        for name, count in probe.kernels:
            kernel, device_ms = name, None
            if chunk is not None:
                hits = [(n, t) for n, t in chunk if base_name(n) == name]
                instances = {n for n, _ in hits}
                kernel = instances.pop() if len(instances) == 1 else name
                device_ms = sum(t for _, t in hits)
            rows.append({"entry": entry, "wrapper": probe.wrapper, "kernel": kernel,
                         "device_ms": device_ms, "launches_per_call": count, "call_ms": call_ms})
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m turbo_metrics_tpu_torch.tools.kernel_dissect",
        description="Time the port's level kernels and each CUDA kernel they launch.",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain twins)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--iters", type=int, default=20, help=f"timed calls per run ({REPEATS} runs per entry)")
    ap.add_argument("--only", default="", metavar="TEXT",
                    help="time only the entries whose name contains TEXT (e.g. '#13')")
    return ap


def main(argv=None) -> dict:
    from turbo_metrics_tpu_torch.models.ssimulacra2 import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    where = (f"{torch.cuda.get_device_name(dev)} (CUDA events; device times by torch.profiler)"
             if dev.type == "cuda" else "the CPU (the plain twins, host clock; no device times)")
    print(f"kernel dissect at B={args.batch} {args.width}x{args.height} on {where}", flush=True)
    rows = []
    with torch.no_grad():
        for probe in probes(args.batch, args.height, args.width, dev):
            if args.only not in probe.entry:
                continue
            new = dissect(probe, args.iters, dev)
            for entry in dict.fromkeys(r["entry"] for r in new):
                mine = [r for r in new if r["entry"] == entry]
                total = sum(r["device_ms"] or 0.0 for r in mine)
                passes = ", ".join(
                    f"{r['kernel']} x{r['launches_per_call']} "
                    + ("n/a" if r["device_ms"] is None
                       else f"{r['device_ms']:.4f} ms ({100 * r['device_ms'] / total:.1f}%)")
                    for r in mine
                )
                device = "" if dev.type != "cuda" else f", {total:.4f} ms on the device"
                print(f"{entry} [{probe.wrapper}]: {mine[0]['call_ms']:.3f} ms per call{device}; {passes}",
                      flush=True)
            rows += new
    result = {"dissect": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
