"""Save, or compare, what the level wrappers return on the dissect tool's inputs.

A redesign of a level kernel that keeps its arithmetic returns the same bits
as the kernels it replaces.  ``save`` imports the port's package from a
given checkout of the repository (the working tree, or an older commit
unpacked beside it with ``git archive``), runs the probes of that
checkout's dissect tool (``kernel_dissect.probes`` at the tool's default
shape, B=4 1080x1920, inputs from seed 0) whose wrapper is one of
``WRAPPERS``, and the calls of ``own_calls`` (ADM, the two conversions,
VMAF motion, the SSIMULACRA2 tail, XPSNR and the fixed-point VIF and ADM
on seeded inputs built here, so that a
checkout whose tool lacks a probe is compared all the same), on the card,
and saves every tensor
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
import inspect
import json
import os
import sys

import numpy as np
import torch

# The dissect probes whose results are saved: SSIMULACRA2's level kernels
# (kernel 1, #3, kernel 2, #8, #10) and SSIM's, VIF's and ADM's levels.
WRAPPERS = ("fused_scale0_yuv", "fused_scale_rgb", "fused_pyramid_tail", "scale_sums", "fused_scale_pair",
            "ssim_sums", "msssim_tail", "vif_scale0", "vif_tail", "adm_stats")


def own_calls(batch: int, height: int, width: int, dev) -> list:
    """(entry, wrapper, call) of the kernels whose inputs are built here from
    seed 9: ADM on luma pairs at sizes whose mask halo leaves the band plane
    (13x21, 67x99), #6 on an 8-bit 4:2:0 pair at the given shape and at an
    odd size, #5 on 10-bit 4:2:2 at the given shape and on 12-bit 4:4:4 at
    an odd size, VMAF motion's #16 on 8-bit and 10-bit luma at the given
    shape and on 10-bit and int32 luma codes at an odd size (blurred planes
    and row SADs) and #17 on one frame, #4 on three levels of a linear-RGB pair at a
    quarter of the given shape (at 1080p the 4K level 3, 270x480) and on
    five levels from 67x99, kernel 1 (8-bit 4:2:0), #3 and kernel 2 (five
    levels) at 67x99, XPSNR's #13 (its three grids) on u8 luma
    and on a 10-bit reference against 8-bit luma at the given shape and on
    10-bit luma at an odd size, and the fixed-point K-int-VIF and K-int-ADM
    on u8 and 10-bit u16 luma pairs at the given shape, on 12-bit u16 and
    10-bit int32 pairs at 67x99 and on u8 and int32 pairs read at 10 bits
    at 96x128 (int_calls), SSIM's #11 and #12 with windows of owned
    columns that cut 32-column tiles mid-way (ssim_window_calls),
    VMAF's #14, #15, #16 and #18 likewise (vmaf_window_calls), and K-int-VIF
    and K-int-ADM likewise and #13 with every frame's previous plane
    (int_window_calls), and #16 with every frame's previous plane
    (motion_prev_calls)."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2
    from turbo_metrics_tpu_torch.ops.kernels import adm, convert, fused_tail, motion, scale_stats, scale_tail, xpsnr

    rng = np.random.default_rng(9)

    def planes(shape, depth):
        dt = np.uint8 if depth == 8 else np.uint16
        return torch.from_numpy(rng.integers(0, 1 << depth, shape).astype(dt)).to(dev)

    def luma_pair(h, w):
        ref = rng.integers(0, 256, (batch, h, w))
        dis = np.clip(ref + rng.integers(-12, 13, ref.shape), 0, 255)
        return torch.from_numpy(np.stack([ref, dis]).astype(np.float32)).to(dev)

    h2, w2 = (height + 1) // 2, (width + 1) // 2
    y8, uv8 = planes((2, batch, height, width), 8), planes((2, batch, h2, w2, 2), 8)
    y8o, uv8o = planes((2, 2, 67, 99), 8), planes((2, 2, 34, 50, 2), 8)
    y10, uv10 = planes((batch, height, width), 10), planes((batch, height, w2, 2), 10)
    y12, uv12 = planes((3, 35, 131), 12), planes((3, 35, 131, 2), 12)
    def luma(shape, depth, dtype):
        return torch.from_numpy(rng.integers(0, 1 << depth, shape).astype(dtype)).to(dev)

    def motion_call(y, depth):
        p0 = luma(y.shape[1:], 16, np.uint16)
        return lambda: tuple(motion.motion_stats(y, p0, depth=depth).values())

    def rgb_pair(b, h, w):
        return torch.from_numpy(rng.random((2, b, 3, h, w), dtype=np.float64).astype(np.float32)).to(dev)

    m = Ssimulacra2(64, 48, device=dev)
    ym = luma((batch, height, width), 8, np.uint8)
    p4k, p67 = rgb_pair(batch, height // 4, width // 4), rgb_pair(2, 67, 99)
    calls = [(f"#18 ADM {h}x{w}", "adm_stats", lambda p=luma_pair(h, w): adm.adm_stats(p))
             for h, w in ((13, 21), (67, 99))]
    calls += [
        (f"#16 motion u8 {width}x{height}", "motion_stats", motion_call(ym, 8)),
        ("#16 motion 10-bit 131x35", "motion_stats", motion_call(luma((3, 35, 131), 10, np.uint16), 10)),
        ("#16 motion int32 codes 131x35", "motion_stats", motion_call(luma((3, 35, 131), 10, np.int32), 10)),
        (f"#16 motion 10-bit {width}x{height}", "motion_stats",
         motion_call(luma((batch, height, width), 10, np.uint16), 10)),
        (f"#17 motion blur u8 {width}x{height}", "integer_blur", lambda: motion.integer_blur(ym[:1])),
        (f"#4 tail 3 levels from {width // 4}x{height // 4}", "fused_tail",
         lambda: fused_tail.fused_tail(p4k, 3, m.taps, m.opsin)),
        ("#4 tail 5 levels from 99x67", "fused_tail", lambda: fused_tail.fused_tail(p67, 5, m.taps, m.opsin)),
        ("kernel 1 99x67", "fused_scale0_yuv", lambda: scale_stats.fused_scale0_yuv(y8o, uv8o, m.taps, m.opsin)),
        ("#3 99x67", "fused_scale_rgb", lambda: scale_stats.fused_scale_rgb(p67, m.taps, m.opsin)),
        ("kernel 2 5 levels from 99x67", "fused_pyramid_tail",
         lambda: scale_tail.fused_pyramid_tail(p67, 5, m.taps, m.opsin)),
    ]
    calls += [
        (f"#6 conversion {width}x{height}", "yuv420_to_linear_rgb_pair",
         lambda: convert.yuv420_to_linear_rgb_pair(y8, uv8)),
        ("#6 conversion 99x67", "yuv420_to_linear_rgb_pair",
         lambda: convert.yuv420_to_linear_rgb_pair(y8o, uv8o)),
        (f"#5 4:2:2 10-bit {width}x{height}", "yuv_to_linear_rgb",
         lambda: convert.yuv_to_linear_rgb(y10, uv10, depth=10, chroma=422)),
        ("#5 4:4:4 12-bit PQ 131x35", "yuv_to_linear_rgb",
         lambda: convert.yuv_to_linear_rgb(y12, uv12, depth=12, chroma=444, matrix="bt2020",
                                           transfer="pq")),
    ]

    def xpsnr_call(ref, dis, depth):
        prev0 = luma(ref.shape[1:], depth, np.uint8 if depth == 8 else np.uint16)
        shift = depth - (8 if dis.dtype == torch.uint8 else depth)
        return lambda: tuple(xpsnr.xpsnr_block_stats(ref, dis, prev0, dis_shift=shift).values())

    x8 = (luma((batch, height, width), 8, np.uint8), luma((batch, height, width), 8, np.uint8))
    x10 = (luma((batch, height, width), 10, np.uint16), luma((batch, height, width), 8, np.uint8))
    calls += int_calls(rng, batch, height, width, dev)
    calls += [
        (f"#13 XPSNR u8 {width}x{height}", "xpsnr_block_stats", xpsnr_call(*x8, 8)),
        (f"#13 XPSNR 10-bit vs 8-bit {width}x{height}", "xpsnr_block_stats", xpsnr_call(*x10, 10)),
        ("#13 XPSNR 10-bit 131x35", "xpsnr_block_stats",
         xpsnr_call(luma((3, 35, 131), 10, np.uint16), luma((3, 35, 131), 10, np.uint16), 10)),
    ]
    # Last: a checkout without them draws the same inputs for every call above.
    calls += ssim_window_calls(rng, batch, height, width, dev)
    calls += vmaf_window_calls(rng, batch, height, width, dev)
    calls += int_window_calls(rng, batch, height, width, dev)
    return calls + motion_prev_calls(rng, batch, height, width, dev)


def ssim_window_calls(rng, batch: int, height: int, width: int, dev) -> list:
    """(entry, wrapper, call) of #11 and #12 with owned-column windows whose
    valid outputs start and end inside 32-column tiles: #11 quantizing and
    emitting on a 67x99 linear-RGB pair (B=2) and on 8-bit codes at the
    given shape, #12 three levels from 67x99 and up to four from half the
    given shape (at 1080p the MS-SSIM level 1, 540x960).  None where the
    checkout's wrappers take no window (before the window, the parent of an
    A/B)."""
    from turbo_metrics_tpu_torch.ops.kernels import windowed, windowed_tail
    from turbo_metrics_tpu_torch.ops.quality import Quality

    if "columns" not in inspect.signature(windowed.ssim_sums).parameters:
        return []
    win = Quality(device=dev).window

    def codes(b, h, w):
        ref = rng.integers(0, 256, (b, 3, h, w))
        dis = np.clip(ref + rng.integers(-20, 21, ref.shape), 0, 255)
        return torch.from_numpy(np.stack([ref, dis]).astype(np.float32)).to(dev)

    lin = torch.from_numpy(rng.random((2, 2, 3, 67, 99), dtype=np.float64).astype(np.float32)).to(dev)
    h2, w2 = height // 2, width // 2
    q67, qfull, qhalf = codes(2, 67, 99), codes(batch, height, width), codes(batch, h2, w2)
    # At 1080p (45, 1301) and (48, 912): valid outputs from column 40 and 43 on.
    cut, cut2 = (45, width * 2 // 3 + 21), (w2 // 20, w2 - w2 // 20)
    lv2 = min(4, (min(h2, w2) // 11).bit_length())
    return [
        ("#11 window (13, 77) quantize 99x67", "ssim_sums",
         lambda: windowed.ssim_sums(lin, win, quantize=True, emit_ds=True, columns=(13, 77))),
        (f"#11 window {cut} {width}x{height}", "ssim_sums",
         lambda: windowed.ssim_sums(qfull, win, emit_ds=True, columns=cut)),
        ("#12 window (13, 77) 3 levels from 99x67", "msssim_tail",
         lambda: windowed_tail.msssim_tail(q67, 3, win, columns=(13, 77))),
        (f"#12 window {cut2} {lv2} levels from {w2}x{h2}", "msssim_tail",
         lambda: windowed_tail.msssim_tail(qhalf, lv2, win, columns=cut2)),
    ]


def vmaf_window_calls(rng, batch: int, height: int, width: int, dev) -> list:
    """(entry, wrapper, call) of VMAF's windowed kernels on seeded inputs,
    each window cutting the unwindowed call's 32-column tiles (ADM's 32x32
    band tiles) mid-way: #14 and #15 (scale 1's input emitted by #14) on
    67x99 and given-shape luma pairs, #16 on u8 luma at both sizes (blurred
    planes and row SADs), #18 on the 67x99 pair and on the given shape, once
    whole with owned columns and once as the second of four column strips
    of it (``columns`` and ``frame``; at 1080p columns 448-991 owning
    480-959).  None where the checkout's wrappers take no window (before the
    window, the parent of an A/B)."""
    from turbo_metrics_tpu_torch.ops.kernels import adm, motion, vif
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh, spatial_sharding

    if "columns" not in inspect.signature(vif.vif_scale0).parameters:
        return []

    def luma_pair(b, h, w):
        ref = rng.integers(0, 256, (b, h, w))
        dis = np.clip(ref + rng.integers(-12, 13, ref.shape), 0, 255)
        return torch.from_numpy(np.stack([ref, dis]).astype(np.float32)).to(dev)

    def luma(b, h, w):
        return (torch.from_numpy(rng.integers(0, 256, (b, h, w)).astype(np.uint8)).to(dev),
                torch.from_numpy(rng.integers(0, 1 << 16, (h, w)).astype(np.uint16)).to(dev))

    p67, pfull = luma_pair(2, 67, 99), luma_pair(batch, height, width)
    y67, yfull = luma(3, 67, 99), luma(batch, height, width)
    # At 1080p (40, 1301): tiles [32, 64) and [1280, 1312) cut.
    cut = (40, width * 2 // 3 + 21)
    s = spatial_sharding(make_mesh(4, device="cpu"), width, alignment=adm.STRIP_ALIGNMENT,
                         halo=adm.STRIP_HALO)[1]
    s_lo, s_hi, s_cols = s.lo, s.hi, s.columns
    strip = pfull[..., s_lo:s_hi].contiguous()
    calls = []
    for what, p, cols in (("99x67", p67, (24, 77)), (f"{width}x{height}", pfull, cut)):
        cols1 = (-(-cols[0] // 2), -(-cols[1] // 2))
        calls += [
            (f"#14 window {cols} {what}", "vif_scale0", lambda p=p, c=cols: vif.vif_scale0(p, columns=c)),
            (f"#15 window {cols1} from {what} level 1", "vif_tail",
             lambda p=p, c=cols1: vif.vif_tail(vif.vif_scale0(p)[1], columns=c)),
            (f"#18 window {cols} {what}", "adm_stats", lambda p=p, c=cols: adm.adm_stats(p, columns=c)),
        ]
    calls.append((f"#18 strip [{s_lo}, {s_hi}) owning {s_cols} of {width}x{height}", "adm_stats",
                  lambda: adm.adm_stats(strip, columns=s_cols, frame=(s_lo, width))))
    for what, (y, p0), cols in (("u8 99x67", y67, (13, 77)), (f"u8 {width}x{height}", yfull, cut)):
        calls.append((f"#16 window {cols} {what}", "motion_stats",
                      lambda y=y, p0=p0, c=cols: tuple(motion.motion_stats(y, p0, columns=c).values())))
    return calls


# The integer surfaces saved per scale and per level, in this order (ADM's
# A bands where the checkout's integer_adm_levels returns them).
IVIF_KEYS = ("s11", "s22", "s12", "mu1", "mu2", "ref", "dis")
IADM_KEYS = ("o_h", "o_v", "o_d", "t_h", "t_v", "t_d", "angle_ok", "a_ref", "a_dis")


def int_calls(rng, batch: int, height: int, width: int, dev) -> list:
    """(entry, wrapper, call) of K-int-VIF and K-int-ADM on seeded luma
    pairs (the distorted image the reference plus noise): u8 and 10-bit u16
    at the given shape, 12-bit u16 and 10-bit int32 codes at 67x99, B=2,
    and, at 96x128 (rows of whole 16-byte chunks, interior tiles), u8 codes
    read at 10 bits and 10-bit int32 codes, B=2.
    Per pair the per-scale and per-level sums, and per scale and per level
    the check surfaces of integer_vif_planes and integer_adm_levels."""
    from turbo_metrics_tpu_torch.ops.kernels import integer_adm, integer_vif

    def pair(b, h, w, depth, dtype):
        ref = rng.integers(0, 1 << depth, (b, h, w))
        dis = np.clip(ref + rng.integers(-(1 << (depth - 4)), 1 << (depth - 4), ref.shape), 0, (1 << depth) - 1)
        return torch.from_numpy(np.stack([ref, dis]).astype(dtype)).to(dev)

    calls = []
    for what, p, depth in ((f"u8 {width}x{height}", pair(batch, height, width, 8, np.uint8), 8),
                           (f"10-bit u16 {width}x{height}", pair(batch, height, width, 10, np.uint16), 10),
                           ("12-bit u16 99x67", pair(2, 67, 99, 12, np.uint16), 12),
                           ("10-bit int32 99x67", pair(2, 67, 99, 10, np.int32), 10),
                           ("u8 read at 10 bits 128x96", pair(2, 96, 128, 8, np.uint8), 10),
                           ("10-bit int32 128x96", pair(2, 96, 128, 10, np.int32), 10)):
        calls += [
            (f"K-int-VIF sums {what}", "integer_vif_stats",
             lambda p=p, d=depth: integer_vif.integer_vif_stats(p, depth=d)),
            (f"K-int-ADM sums {what}", "integer_adm_stats",
             lambda p=p, d=depth: integer_adm.integer_adm_stats(p, depth=d)),
        ]
        for k in range(4):
            calls.append((f"K-int-VIF scale {k} {what}", "integer_vif_stats",
                          lambda p=p, d=depth, k=k: tuple(integer_vif.integer_vif_planes(p, depth=d)[k].get(key)
                                                          for key in IVIF_KEYS)))
            calls.append((f"K-int-ADM level {k} {what}", "integer_adm_stats",
                          lambda p=p, d=depth, k=k: tuple(integer_adm.integer_adm_levels(p, depth=d)[k].get(key)
                                                          for key in IADM_KEYS)))
    return calls


def int_window_calls(rng, batch: int, height: int, width: int, dev) -> list:
    """(entry, wrapper, call) of K-int-VIF and K-int-ADM with owned-column
    windows that cut 32-column tiles (K-int-ADM's 32x32 band tiles)
    mid-way, on u8 and 10-bit u16 luma-code pairs at 67x99 (B=2) and at the
    given shape, each also as the second of four column strips of the given
    shape (``columns``, and K-int-ADM's ``frame``); then #13 with every
    frame's previous plane (``prev``) on u8 luma at the given shape and on
    10-bit luma at an odd size.  Each part is left out where the checkout's
    wrappers do not take its argument (the parent of an A/B)."""
    from turbo_metrics_tpu_torch.ops.kernels import adm, integer_adm, integer_vif, xpsnr
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh, spatial_sharding

    calls = []
    if "columns" in inspect.signature(integer_vif.integer_vif_stats).parameters:
        def pair(b, h, w, depth, dtype):
            ref = rng.integers(0, 1 << depth, (b, h, w))
            dis = np.clip(ref + rng.integers(-(1 << (depth - 4)), 1 << (depth - 4), ref.shape), 0,
                          (1 << depth) - 1)
            return torch.from_numpy(np.stack([ref, dis]).astype(dtype)).to(dev)

        # At 1080p (40, 1301): tiles [32, 64) and [1280, 1312) cut.
        cut = (40, width * 2 // 3 + 21)
        s = spatial_sharding(make_mesh(4, device="cpu"), width, alignment=adm.STRIP_ALIGNMENT,
                             halo=adm.STRIP_HALO)[1]
        for what, p, depth, cols in (("u8 99x67", pair(2, 67, 99, 8, np.uint8), 8, (24, 77)),
                                     ("10-bit u16 99x67", pair(2, 67, 99, 10, np.uint16), 10, (24, 77)),
                                     (f"u8 {width}x{height}", pair(batch, height, width, 8, np.uint8), 8, cut),
                                     (f"10-bit u16 {width}x{height}",
                                      pair(batch, height, width, 10, np.uint16), 10, cut)):
            calls += [
                (f"K-int-VIF window {cols} {what}", "integer_vif_stats",
                 lambda p=p, d=depth, c=cols: integer_vif.integer_vif_stats(p, depth=d, columns=c)),
                (f"K-int-ADM window {cols} {what}", "integer_adm_stats",
                 lambda p=p, d=depth, c=cols: integer_adm.integer_adm_stats(p, depth=d, columns=c)),
            ]
            if p.shape[-1] == width:
                strip = p[..., s.lo:s.hi].contiguous()
                calls += [
                    (f"K-int-VIF strip [{s.lo}, {s.hi}) owning {s.columns} {what}", "integer_vif_stats",
                     lambda t=strip, d=depth: integer_vif.integer_vif_stats(t, depth=d, columns=s.columns)),
                    (f"K-int-ADM strip [{s.lo}, {s.hi}) owning {s.columns} {what}", "integer_adm_stats",
                     lambda t=strip, d=depth: integer_adm.integer_adm_stats(t, depth=d, columns=s.columns,
                                                                            frame=(s.lo, width))),
                ]
    if "prev" in inspect.signature(xpsnr.xpsnr_block_stats).parameters:
        def luma(shape, depth):
            dt = np.uint8 if depth == 8 else np.uint16
            return torch.from_numpy(rng.integers(0, 1 << depth, shape).astype(dt)).to(dev)

        for what, shape, depth in ((f"u8 {width}x{height}", (batch, height, width), 8),
                                   ("10-bit 131x35", (3, 35, 131), 10)):
            ref, dis, prev = (luma(shape, depth) for _ in range(3))
            calls.append((f"#13 XPSNR per-frame prev {what}", "xpsnr_block_stats",
                          lambda r=ref, d=dis, p=prev: tuple(xpsnr.xpsnr_block_stats(r, d, prev=p).values())))
    return calls


def motion_prev_calls(rng, batch: int, height: int, width: int, dev) -> list:
    """(entry, wrapper, call) of #16 with every frame's own previous blurred
    plane (``prev``, seeded planes, none the blur of the frame before) on u8
    luma at the given shape and on 10-bit luma at an odd size, and with one
    plane for every frame (a batch stride of 0); none where the checkout's
    ``motion_stats`` does not take ``prev`` (the parent of an A/B)."""
    from turbo_metrics_tpu_torch.ops.kernels import motion

    if "prev" not in inspect.signature(motion.motion_stats).parameters:
        return []

    def planes(shape, depth, dtype):
        return torch.from_numpy(rng.integers(0, 1 << depth, shape).astype(dtype)).to(dev)

    calls = []
    for what, shape, depth, dt in ((f"u8 {width}x{height}", (batch, height, width), 8, np.uint8),
                                   ("10-bit 131x35", (3, 35, 131), 10, np.uint16)):
        y, prev = planes(shape, depth, dt), planes(shape, 16, np.uint16)
        calls.append((f"#16 motion per-frame prev {what}", "motion_stats",
                      lambda y=y, p=prev, d=depth: tuple(motion.motion_stats(y, prev=p, depth=d).values())))
        calls.append((f"#16 motion one prev for every frame {what}", "motion_stats",
                      lambda y=y, p=prev[0], d=depth: tuple(motion.motion_stats(y, prev=p.expand(y.shape),
                                                                                depth=d).values())))
    return calls


def save(root: str, out: str) -> dict:
    """Run the probes of the checkout at ``root`` whose wrapper is in
    ``WRAPPERS`` and the calls of ``own_calls`` once each on the card, at its
    dissect tool's default shape; save {"results": {"<entry> [i]": the
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
    dev = torch.device("cuda")
    results, peak_mib = {}, {}
    with torch.no_grad():
        calls = [(p.entry, p.wrapper, p.fn)
                 for p in kernel_dissect.probes(shape.batch, shape.height, shape.width, dev)
                 if p.wrapper in WRAPPERS]
        for entry, wrapper, fn in calls + own_calls(shape.batch, shape.height, shape.width, dev):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = fn()
            torch.cuda.synchronize()
            peak_mib[entry] = (torch.cuda.max_memory_allocated() - base) / 2**20
            print(f"{entry} [{wrapper}]: peak device memory above its inputs "
                  f"{peak_mib[entry]:.1f} MiB ({torch.cuda.get_device_name()})", flush=True)
            for i, t in enumerate(got if isinstance(got, tuple) else (got,)):
                if t is not None:
                    results[f"{entry} [{i}]"] = t.cpu()
    saved = {"results": results, "peak_mib": peak_mib}
    torch.save(saved, out)
    print(f"saved {len(results)} results from {root} to {out}", flush=True)
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
