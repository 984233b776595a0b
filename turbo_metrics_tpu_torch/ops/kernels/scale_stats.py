"""Kernels 1 and #3: one SSIMULACRA2 pyramid level, from YUV, packed sRGB
codes or linear RGB.

``fused_scale0_yuv`` (kernel 1) launches the CUDA kernels of
csrc/ssimulacra2_scale.cu (``tm_yuv420_to_xyb`` + ``tm_level_sums``) on a
CUDA tensor, and runs its plain twin ``fused_scale0_yuv_ref`` on a CPU
tensor.  It replaces the JAX package's ``fused_scale0_yuv_pallas``
(turbo_metrics_tpu/ops/pallas/scale_stats.py:1985).

``fused_scale_rgb`` (kernel #3) is one level from a linear-RGB pair buffer
with the next level emitted (``tm_rgb_to_xyb`` + ``tm_level_sums``, twin
``fused_scale_rgb_ref``): scale 0 of the multi-metric path, replacing
``fused_scale_pallas_v4`` (turbo_metrics_tpu/ops/pallas/scale_stats.py:2552).

``fused_scale_srgb`` is scale 0 straight from two inputs' packed integer
sRGB codes (``tm_srgb_pair_to_xyb`` + ``tm_level_sums``, twin
``fused_scale_srgb_ref``), kernel 1's sibling for sRGB sources, with the
next level emitted and no linear-RGB pair buffer.  It replaces no TPU
kernel: the JAX package converts packed sRGB with jnp.  The kernel maps
each code through ``code_table``, the plain conversion of every code of the
type computed on the device, so its results equal the plain route's
(``colorspace.srgb_pair_to_linear``, then ``fused_scale_rgb``)
bit for bit.

``scale_sums`` (kernel #8) is one level's sums from two XYB tensors
(``tm_level_sums_pair``, twin ``level_sums_ref``), replacing
``scale_sums_pallas`` (turbo_metrics_tpu/ops/pallas/scale_stats_legacy.py:172);
``fused_scale_pair`` (kernel #10) one level's sums from two linear-RGB
tensors (``tm_rgb_pair_to_xyb`` + ``tm_level_sums``, twin
``fused_scale_pair_ref``), replacing ``fused_scale_pallas_v3``
(scale_stats_legacy.py:644) and, computing the same function,
``fused_scale_pallas`` (v2, scale_stats_legacy.py:367).  Both serve the
legacy backends of models/ssimulacra2.ssimulacra2_subscores.

The level helpers (``level_sums_ref``, ``norms_from_sums``, ``window``) are
shared with kernels 2 and #4.  Kernels 1, #3, #10, the sRGB pass and kernel 2
issue each level through one body, ``launch_level`` (the conversion pass,
then ``tm_level_sums``, on one stream); the four one-level wrappers allocate
through ``launch_first_level``.

Every level wrapper takes ``columns=(clo, chi)``, the window of owned
columns whose pixels its sums add (None: the whole width).  A column strip
of a frame cut with a halo (parallel/mesh.py ``spatial_sharding``) blurs
and emits every column it holds but sums only its own; where a wrapper runs
several levels, ``columns`` is the first level's window and each next
level's is ``next_window`` of it.
"""

from __future__ import annotations

import torch

from turbo_metrics_tpu_torch.ops import colorspace
from turbo_metrics_tpu_torch.ops.downscale import downscale_by_2
from turbo_metrics_tpu_torch.ops.gaussian import blur_2d
from turbo_metrics_tpu_torch.ops.kernels._build import LIBRARY, check, launch_stream
from turbo_metrics_tpu_torch.ops.ssim_maps import edge_maps, ssim_map
from turbo_metrics_tpu_torch.ops.xyb import linear_rgb_to_xyb

TRANSFER_CODES = {"bt709": 0, "srgb": 1, "pq": 2, "hlg": 3, "linear": 4}


def norms_from_sums(sums: torch.Tensor, npx: int) -> torch.Tensor:
    """(..., 3, 6) sums -> (..., 3, 2, 3) norms matching ``scale_norms``."""
    inv = 1.0 / npx
    n1 = sums[..., 0::2] * inv  # d, art, det 1-norms
    n4 = torch.sqrt(torch.sqrt(sums[..., 1::2] * inv))
    return torch.stack([n1, n4], dim=-2)


def window(columns, w: int) -> tuple[int, int]:
    """The owned columns ``columns`` = (clo, chi) of a level w wide as
    ints, (0, w) for None; 0 <= clo < chi <= w, else ValueError."""
    if columns is None:
        return 0, w
    clo, chi = (int(c) for c in columns)
    if not 0 <= clo < chi <= w:
        raise ValueError(f"columns must satisfy 0 <= lo < hi <= {w}, got {tuple(columns)}")
    return clo, chi


def next_window(clo: int, chi: int) -> tuple[int, int]:
    """The next level's window: the columns whose 2x2 quads the window
    covers (lo halved down, hi halved up)."""
    return clo // 2, (chi + 1) // 2


def level_sums_ref(x1: torch.Tensor, x2: torch.Tensor, taps, columns=None) -> torch.Tensor:
    """Plain per-level sums from XYB planes (B, 3, h, w) -> (B, 3, 6) f32.

    Blurs the 4 quantities the maps need (x1, x2, (x1-x2)^2, x1*x2: see
    ``ssim_map``), builds the maps and sums (d, d^4, art, art^4, det, det^4)
    in f64, like the kernel's final reduction, over the owned columns
    ``columns`` (``window``; every column blurred, the window's summed).
    """
    diff = x1 - x2
    mu1, mu2, sdd, s12 = blur_2d(
        torch.stack([x1, x2, diff * diff, x1 * x2]), taps=taps
    ).unbind(0)
    d = ssim_map(mu1, mu2, sdd, s12)
    art, det = edge_maps(x1, x2, mu1, mu2)
    quantities = []
    for m in (d, art, det):
        m2 = m * m
        quantities += [m, m2 * m2]
    if columns is not None:
        clo, chi = window(columns, x1.shape[-1])
        quantities = [q[..., clo:chi] for q in quantities]
    return torch.stack(
        [q.double().sum(dim=(-2, -1)) for q in quantities], dim=-1
    ).float()


def check_level_consts(taps: torch.Tensor, opsin: torch.Tensor, device) -> None:
    for name, t in (("taps", taps), ("opsin", opsin)):
        if (
            t.shape != (11,) or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()
        ):
            raise ValueError(f"{name} must be a contiguous (11,) float32 tensor on {device}")


def check_yuv(
    y2: torch.Tensor, uv2: torch.Tensor, depth: int, transfer: str, *, pair: bool = True,
    chroma: int = 420,
) -> None:
    """Planes of a pair, (2, B, h, w) + (2, B, ch, cw, 2), or with ``pair``
    false of one image per frame, (B, h, w) + (B, ch, cw, 2); (ch, cw) the
    ``chroma`` subsampling's grid."""
    if pair and (y2.ndim != 4 or y2.shape[0] != 2):
        raise ValueError(f"y2 must be (2, B, h, w), got {tuple(y2.shape)}")
    if not pair and y2.ndim != 3:
        raise ValueError(f"y must be (B, h, w), got {tuple(y2.shape)}")
    h, w = y2.shape[-2], y2.shape[-1]
    want_uv = (*y2.shape[:-2], *colorspace.chroma_dims(chroma, h, w), 2)
    if tuple(uv2.shape) != want_uv:
        raise ValueError(f"uv2 must be {want_uv} for {chroma}, got {tuple(uv2.shape)}")
    want_dt = torch.uint8 if depth == 8 else torch.uint16
    if not 8 <= depth <= 16 or y2.dtype != want_dt or uv2.dtype != want_dt:
        raise ValueError(
            f"{depth}-bit planes must be {want_dt}, got {y2.dtype}/{uv2.dtype}"
        )
    if y2.device != uv2.device:
        raise ValueError("y2 and uv2 must be on one device")
    if not (y2.is_contiguous() and uv2.is_contiguous()):
        raise ValueError("y2 and uv2 must be contiguous")
    if transfer not in TRANSFER_CODES:
        raise ValueError(f"unknown transfer {transfer!r}")


def check_level(p12: torch.Tensor) -> None:
    if p12.ndim != 5 or p12.shape[0] != 2 or p12.shape[2] != 3:
        raise ValueError(f"p12 must be (2, B, 3, h, w), got {tuple(p12.shape)}")
    if p12.dtype != torch.float32 or not p12.is_contiguous():
        raise ValueError("p12 must be contiguous float32")


# The partials' tile: the level kernels reduce each 32x8 tile of a plane to
# f32 partials, six in SSIMULACRA2's, two in SSIM's and VIF's
# (csrc/level.cuh pixel_grid, tile_partials).
PART_W, PART_H = 32, 8


def level_blocks(h: int, w: int) -> int:
    """Partial tiles per (batch, channel) plane of an h x w level: the count
    of ``tm_level_blocks`` (csrc/ssimulacra2_scale.cu)."""
    return -(-w // PART_W) * -(-h // PART_H)


def level_parts(bsz: int, h: int, w: int, dev) -> torch.Tensor:
    """The six partials of every 32x8 tile of B*3 planes of an h x w level."""
    return torch.empty(bsz * 3 * level_blocks(h, w) * 6, dtype=torch.float32, device=dev)


def s2_level_scratch(bsz: int, h: int, w: int, dev):
    """(XYB pair, partials) of an h x w level: the level pass keeps its
    row-blurred planes in shared memory, so they take no device memory."""
    return (
        torch.empty(2 * bsz * 3 * h * w, dtype=torch.float32, device=dev),
        level_parts(bsz, h, w, dev),
    )


def launch_level(lib, dev, taps, scratch, sums, sums_bstride, nxt, bsz, h, w, clo, chi, convert, head) -> None:
    """One level on ``dev``'s stream: the conversion pass, the library's
    entry point ``convert`` called with the arguments ``head`` (a tuple),
    then the XYB pair's and the next level's pointers (the next level into
    ``nxt`` unless it is None) and the stream; then ``tm_level_sums`` on
    the B x h x w XYB pair, its sums over the columns [clo, chi) into
    ``sums[b * sums_bstride + ch * 6 + k]``.  ``scratch``:
    ``s2_level_scratch`` of a level at least this large."""
    xyb, parts = scratch
    with launch_stream(dev) as stream:
        check(getattr(lib, convert)(*head, xyb.data_ptr(), None if nxt is None else nxt.data_ptr(), stream), convert)
        check(
            lib.tm_level_sums(
                xyb.data_ptr(), bsz, h, w, clo, chi, taps.data_ptr(), parts.data_ptr(),
                sums.data_ptr(), sums_bstride, stream,
            ),
            "tm_level_sums",
        )


def launch_first_level(name, dev, taps, bsz, h, w, clo, chi, emit_ds, convert, head):
    """The card's part of the first-level wrapper ``name``, once its checks
    passed and its CPU twin was not taken: on any device but CUDA it
    raises; else it allocates the level's scratch, the next level (None
    without ``emit_ds``) and the (B, 3, 6) sums, and runs ``launch_level``
    with ``convert`` and ``head``.  Returns (sums, next level)."""
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    lib = LIBRARY.get()
    scratch = s2_level_scratch(bsz, h, w, dev)
    ds = (
        torch.empty((2, bsz, 3, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=dev)
        if emit_ds else None
    )
    sums = torch.empty((bsz, 3, 6), dtype=torch.float32, device=dev)
    launch_level(lib, dev, taps, scratch, sums, 18, ds, bsz, h, w, clo, chi, convert, head)
    return sums, ds


def fused_scale0_yuv_ref(
    y2, uv2, taps, opsin, *, depth=8, matrix="bt709", transfer="bt709",
    full_range=False, emit_ds=True, kr_kb=None, columns=None,
):
    """Plain twin of ``fused_scale0_yuv`` (same arguments and results)."""
    lin = colorspace.yuv420_to_linear_rgb(
        y2, uv2, depth=depth, matrix=matrix, transfer=transfer,
        full_range=full_range, kr_kb=kr_kb, backend="jnp",
    )  # (2, B, 3, h, w)
    xyb = linear_rgb_to_xyb(lin, opsin=opsin)
    sums = level_sums_ref(xyb[0], xyb[1], taps, columns)
    return sums, (downscale_by_2(lin) if emit_ds else None)


def fused_scale0_yuv(
    y2: torch.Tensor,
    uv2: torch.Tensor,
    taps: torch.Tensor,
    opsin: torch.Tensor,
    *,
    depth: int = 8,
    matrix: str = "bt709",
    transfer: str = "bt709",
    full_range: bool = False,
    emit_ds: bool = True,
    kr_kb=None,
    columns=None,
):
    """Scale 0 of the pyramid from YUV 4:2:0 — conversion fused.

    ``y2``: (2, B, h, w) luma (reference, distorted), uint8 at 8 bits else
    uint16; ``uv2``: (2, B, ceil(h/2), ceil(w/2), 2) chroma.  ``taps`` and
    ``opsin``: (11,) f32 constants on the same device (the ``Ssimulacra2``
    module's buffers).  Returns (sums (B, 3, 6) f32 over the owned columns
    ``columns`` (module docstring), level 1 as contiguous (2, B, 3,
    ceil(h/2), ceil(w/2)) f32 linear RGB, or None without ``emit_ds``).
    Full-resolution linear RGB is never stored.
    """
    check_yuv(y2, uv2, depth, transfer)
    check_level_consts(taps, opsin, y2.device)
    clo, chi = window(columns, y2.shape[-1])
    if y2.device.type == "cpu":
        return fused_scale0_yuv_ref(
            y2, uv2, taps, opsin, depth=depth, matrix=matrix, transfer=transfer,
            full_range=full_range, emit_ds=emit_ds, kr_kb=kr_kb, columns=columns,
        )
    _, bsz, h, w = y2.shape
    rng = colorspace.sample_range(depth, full_range)
    coeffs = colorspace.conversion_coeffs(depth, matrix, full_range, kr_kb)
    out = launch_first_level(
        "fused_scale0_yuv", y2.device, taps, bsz, h, w, clo, chi, emit_ds, "tm_yuv420_to_xyb",
        (y2.data_ptr(), uv2.data_ptr(), int(depth > 8), bsz, h, w, *coeffs, float(rng.minimum),
         float(rng.neutral), TRANSFER_CODES[transfer], opsin.data_ptr()),
    )
    fused_scale0_yuv.launches += 1
    return out


fused_scale0_yuv.launches = 0


def fused_scale_rgb_ref(p12, taps, opsin, *, emit_ds=True, columns=None):
    """Plain twin of ``fused_scale_rgb`` (same arguments and results)."""
    xyb = linear_rgb_to_xyb(p12, opsin=opsin)
    sums = level_sums_ref(xyb[0], xyb[1], taps, columns)
    return sums, (downscale_by_2(p12) if emit_ds else None)


def fused_scale_rgb(
    p12: torch.Tensor, taps: torch.Tensor, opsin: torch.Tensor, *, emit_ds: bool = True,
    columns=None,
):
    """One pyramid level from linear RGB, the next level emitted.

    ``p12``: contiguous (2, B, 3, h, w) f32 linear RGB (reference,
    distorted), e.g. the conversion kernel's pair buffer.  Returns (sums (B,
    3, 6) f32 over the owned columns ``columns`` (module docstring), the
    edge-replicated 2x2 mean as (2, B, 3, ceil(h/2), ceil(w/2)) f32, or None
    without ``emit_ds``).
    """
    check_level(p12)
    check_level_consts(taps, opsin, p12.device)
    clo, chi = window(columns, p12.shape[-1])
    if p12.device.type == "cpu":
        return fused_scale_rgb_ref(p12, taps, opsin, emit_ds=emit_ds, columns=columns)
    _, bsz, _, h, w = p12.shape
    out = launch_first_level(
        "fused_scale_rgb", p12.device, taps, bsz, h, w, clo, chi, emit_ds, "tm_rgb_to_xyb",
        (p12.data_ptr(), bsz, h, w, opsin.data_ptr()),
    )
    fused_scale_rgb.launches += 1
    return out


fused_scale_rgb.launches = 0


# The packed integer RGB types the sRGB conversion pass takes, and the
# entries of their code tables.
CODE_TABLE_SIZES = {torch.uint8: 1 << 8, torch.uint16: 1 << 16}


def code_table(dtype: torch.dtype, depth: int, device) -> torch.Tensor:
    """The (2^8 or 2^16,) f32 linear light of every sRGB code of ``dtype``:
    ``colorspace.srgb_to_linear`` of ``torch.arange`` on ``device``, the same
    torch operations the plain route runs on a frame's codes, so each entry
    is the value that route gives its code, bit for bit."""
    if dtype not in CODE_TABLE_SIZES:
        raise ValueError(f"code tables are for uint8 or uint16 codes, not {dtype}")
    codes = torch.arange(CODE_TABLE_SIZES[dtype], dtype=torch.int32, device=device)
    return colorspace.srgb_to_linear(codes, depth=depth).contiguous()


def check_codes(ref: torch.Tensor, dis: torch.Tensor, depth: int) -> None:
    """Two contiguous (B, h, w, 3) packed-RGB code tensors of one shape and
    one integer type (uint8 or uint16) on one device, at 1-16 bits."""
    if ref.ndim != 4 or ref.shape[-1] != 3 or ref.shape != dis.shape:
        raise ValueError(f"want two (B, h, w, 3) tensors, got {tuple(ref.shape)} and {tuple(dis.shape)}")
    if ref.dtype not in CODE_TABLE_SIZES or dis.dtype != ref.dtype:
        raise ValueError(f"want uint8 or uint16 codes of one type, got {ref.dtype} and {dis.dtype}")
    if not (ref.is_contiguous() and dis.is_contiguous()) or ref.device != dis.device:
        raise ValueError("the two tensors must be contiguous and on one device")
    if not 1 <= depth <= 16:
        raise ValueError(f"depth must be 1-16 bits, got {depth}")


def fused_scale_srgb_ref(ref, dis, taps, opsin, *, depth=8, emit_ds=True):
    """Plain twin of ``fused_scale_srgb`` (same results; no table): the plain
    route itself, ``colorspace.srgb_pair_to_linear`` then
    ``fused_scale_rgb_ref``."""
    return fused_scale_rgb_ref(colorspace.srgb_pair_to_linear(ref, dis, depth=depth), taps, opsin, emit_ds=emit_ds)


def fused_scale_srgb(
    ref: torch.Tensor, dis: torch.Tensor, taps: torch.Tensor, opsin: torch.Tensor, table: torch.Tensor, *,
    depth: int = 8, emit_ds: bool = True,
):
    """Scale 0 of the pyramid from packed integer sRGB — conversion fused.

    ``ref``, ``dis``: the reference's and the distorted input's contiguous
    (B, h, w, 3) codes, both uint8 or both uint16, at ``depth`` bits.
    ``taps`` and ``opsin`` as for ``fused_scale0_yuv``; ``table``:
    ``code_table(ref.dtype, depth, ref.device)``, which the caller keeps
    across calls (``Ssimulacra2.code_table``; not read on the CPU).  Returns
    (sums (B, 3, 6) f32, level 1 as contiguous (2, B, 3, ceil(h/2),
    ceil(w/2)) f32 linear RGB, or None without ``emit_ds``).
    Full-resolution linear RGB is never stored.
    """
    check_codes(ref, dis, depth)
    check_level_consts(taps, opsin, ref.device)
    if ref.device.type == "cpu":
        return fused_scale_srgb_ref(ref, dis, taps, opsin, depth=depth, emit_ds=emit_ds)
    n = CODE_TABLE_SIZES[ref.dtype]
    if not (
        isinstance(table, torch.Tensor) and table.shape == (n,) and table.dtype == torch.float32
        and table.device == ref.device and table.is_contiguous()
    ):
        raise ValueError(f"table must be a contiguous ({n},) float32 tensor on {ref.device}")
    bsz, h, w, _ = ref.shape
    out = launch_first_level(
        "fused_scale_srgb", ref.device, taps, bsz, h, w, 0, w, emit_ds, "tm_srgb_pair_to_xyb",
        (ref.data_ptr(), dis.data_ptr(), int(ref.dtype == torch.uint16), bsz, h, w, table.data_ptr(), opsin.data_ptr()),
    )
    fused_scale_srgb.launches += 1
    return out


fused_scale_srgb.launches = 0


def check_image_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    """Two (B, 3, h, w) contiguous f32 tensors of one shape on one device."""
    if a.ndim != 4 or a.shape[1] != 3 or a.shape != b.shape:
        raise ValueError(f"want two (B, 3, h, w) tensors, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"want float32 tensors, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()) or a.device != b.device:
        raise ValueError("the two tensors must be contiguous and on one device")


def scale_sums(
    xyb1: torch.Tensor, xyb2: torch.Tensor, taps: torch.Tensor, *, columns=None
) -> torch.Tensor:
    """One level's sums from the reference's and the distorted image's
    positive-shifted XYB, (B, 3, h, w) f32 each, without stacking them.
    Returns (B, 3, 6) f32 in ``norms_from_sums`` order, over the owned
    columns ``columns`` (module docstring)."""
    check_image_pair(xyb1, xyb2)
    if taps.shape != (11,) or taps.dtype != torch.float32 or taps.device != xyb1.device:
        raise ValueError(f"taps must be an (11,) float32 tensor on {xyb1.device}")
    clo, chi = window(columns, xyb1.shape[-1])
    if xyb1.device.type == "cpu":
        return level_sums_ref(xyb1, xyb2, taps, columns)
    if xyb1.device.type != "cuda":
        raise ValueError(f"scale_sums runs on cuda or cpu, not {xyb1.device}")
    lib = LIBRARY.get()
    bsz, _, h, w = xyb1.shape
    dev = xyb1.device
    parts = level_parts(bsz, h, w, dev)
    sums = torch.empty((bsz, 3, 6), dtype=torch.float32, device=dev)
    with launch_stream(dev) as stream:
        check(
            lib.tm_level_sums_pair(
                xyb1.data_ptr(), xyb2.data_ptr(), bsz, h, w, clo, chi, taps.data_ptr(),
                parts.data_ptr(), sums.data_ptr(), 18, stream,
            ),
            "tm_level_sums_pair",
        )
    scale_sums.launches += 1
    return sums


scale_sums.launches = 0


def fused_scale_pair_ref(lin_ref, lin_dis, taps, opsin, *, columns=None):
    """Plain twin of ``fused_scale_pair`` (same arguments and result)."""
    return fused_scale_rgb_ref(
        torch.stack([lin_ref, lin_dis]), taps, opsin, emit_ds=False, columns=columns
    )[0]


def fused_scale_pair(
    lin_ref: torch.Tensor, lin_dis: torch.Tensor, taps: torch.Tensor, opsin: torch.Tensor, *,
    columns=None,
) -> torch.Tensor:
    """One level's sums from the reference's and the distorted image's
    linear RGB, (B, 3, h, w) f32 each, no next level.  Returns (B, 3, 6) f32
    in ``norms_from_sums`` order, over the owned columns ``columns`` (module
    docstring)."""
    check_image_pair(lin_ref, lin_dis)
    check_level_consts(taps, opsin, lin_ref.device)
    clo, chi = window(columns, lin_ref.shape[-1])
    if lin_ref.device.type == "cpu":
        return fused_scale_pair_ref(lin_ref, lin_dis, taps, opsin, columns=columns)
    bsz, _, h, w = lin_ref.shape
    sums, _ = launch_first_level(
        "fused_scale_pair", lin_ref.device, taps, bsz, h, w, clo, chi, False, "tm_rgb_pair_to_xyb",
        (lin_ref.data_ptr(), lin_dis.data_ptr(), bsz, h, w, opsin.data_ptr()),
    )
    fused_scale_pair.launches += 1
    return sums


fused_scale_pair.launches = 0
