"""SSIMULACRA2 in PyTorch: the plain chain, the kernel paths and the module.

Routes to the (B, 3, S, 2, 3) sub-scores (channel, scale, norm, map):
  * ``ssimulacra2_subscores``: the JAX package's backend switch.  ``jnp`` is
    the plain torch chain (downscale, XYB, five blurs, maps, means), the
    counterpart of the JAX jnp path and the reference the kernels are held
    against; ``jnp_iir`` the same with the recursive blur; ``pallas`` plain
    downscale and XYB, then kernel #8 per level; ``pallas2`` kernel #10 per
    level and kernel #7 between levels; ``pallas3`` the level chain from
    level 0; ``auto`` the level chain on cuda, ``jnp`` on the CPU;
  * ``ssimulacra2_subscores_from_yuv``: the kernel path of the
    SSIMULACRA2-only route, scale 0 from YUV 4:2:0 (kernel 1,
    ops/kernels/scale_stats.py), then the level chain from its emitted
    level 1;
  * ``ssimulacra2_subscores_from_srgb``: the kernel path of the
    SSIMULACRA2-only route for packed integer RGB (sRGB images), scale 0
    straight from the two inputs' codes (``fused_scale_srgb``, kernel 1's
    sibling, through the code table ``Ssimulacra2.code_table`` keeps), then
    the level chain from its emitted level 1; no linear-RGB pair buffer;
  * ``ssimulacra2_subscores_from_rgb``: the kernel path from a linear-RGB
    pair buffer (the multi-metric route, float RGB, and
    ``Ssimulacra2.forward``), scale 0 through kernel #3
    (``fused_scale_rgb``), then the level chain.
The three kernel entries share one body (``_subscores``): the first-level
pass, the level chain from its level 1, the norms.  The model picks the
first-level pass for the engine's SSIMULACRA2-only step from the inputs'
specs (``Ssimulacra2.subscores_direct``): kernel 1, the sRGB pass, or None,
and the engine builds the pair buffer for #3.
The level chain (``level_sums_chain``, the JAX package's
``ssimulacra2_subscores_from_padded`` loop) picks per level, by
``level_route``: kernel 2 for five levels that fit its geometry, kernel #4
for every remaining level once a level is small, else kernel #3 with the next
level emitted.  The final 108-weight score runs on the host in f64
(models/ssimulacra2_score.py).  Layout: (B, 3, H, W) planar f32.

Width sharding (``subscores_width_sharded``, parallel/mesh.py
``shard_over_width``): ``ssimulacra2_level_sums`` and
``ssimulacra2_level_sums_from_yuv`` return the per-level (B, 3, 6) sums of
the first two entries over ``columns=(own_lo, own_hi)``, a window of owned
level-0 columns (None: the whole width).  Every column is converted,
downscaled and blurred; only the window's pixels are summed, on level l the
columns [own_lo >> l, ceil(own_hi / 2^l)).  The column strips of one frame
add their windows' sums, normalised by the whole frame's level sizes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from turbo_metrics_tpu_torch.models.ssimulacra2_score import (
    WEIGHTS,
    postprocess_score,
    weight_needs,
)
from turbo_metrics_tpu_torch.ops import colorspace
from turbo_metrics_tpu_torch.ops.downscale import downscale_by_2, scale_dims
from turbo_metrics_tpu_torch.ops.gaussian import blur_2d, blur_2d_iir, gaussian_taps, taps_f32
from turbo_metrics_tpu_torch.ops.kernels import downscale as downscale_kernel
from turbo_metrics_tpu_torch.ops.kernels.fused_tail import fused_tail
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import (
    CODE_TABLE_SIZES,
    code_table,
    fused_scale0_yuv,
    fused_scale_pair,
    fused_scale_rgb,
    fused_scale_srgb,
    next_window,
    scale_sums,
    window,
)
from turbo_metrics_tpu_torch.ops.kernels.scale_tail import fused_pyramid_tail
from turbo_metrics_tpu_torch.ops.ssim_maps import plain_maps, scale_norms
from turbo_metrics_tpu_torch.ops.xyb import (
    OPSIN_ABSORBANCE_BIAS,
    OPSIN_ABSORBANCE_BIAS_ROOT,
    OPSIN_ABSORBANCE_MATRIX,
    linear_rgb_to_xyb,
    opsin_vector,
)
from turbo_metrics_tpu_torch.parallel.mesh import (
    add_strips,
    check_inputs,
    launch_shards,
    partial_keywords,
    spatial_sharding,
    strip_input,
    upload,
)
from turbo_metrics_tpu_torch.utils.profiling import count, span, to_host

NUM_SCALES = 6
MATRIX_NAMES = ("bt709", "bt601_525", "bt601_625", "bt2020")
BACKENDS = ("jnp", "jnp_iir", "pallas", "pallas2", "pallas3")

# The level chain's rule, copied from the JAX package
# (turbo_metrics_tpu/models/ssimulacra2.py:39, ops/pallas/scale_tail.py
# tail2_ok, ops/pallas/scale_stats.py tail_plane_bytes) so that each kernel
# runs on the levels its TPU counterpart runs on: kernel #4 takes every
# remaining level once a level's padded TPU plane would fit in this many
# bytes.  A routing choice, not math; a rule tuned for the H100 is
# ROADMAP work.
TAIL_MAX_BYTES = 8 * 1024 * 1024


# Per kernel of the level route: the span around each of its calls and the
# counter that adds the levels it took (read by the CLI's ``--trace`` and
# portbench/span_account.py).
ROUTE_RECORDS = {
    "fused_scale_rgb": ("tm.step.ssimulacra2.levels.scale", "levels.scale"),
    "fused_tail": ("tm.step.ssimulacra2.levels.tail", "levels.tail"),
    "fused_pyramid_tail": ("tm.step.ssimulacra2.levels.pyramid", "levels.pyramid"),
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tail_plane_bytes(h: int, w: int) -> int:
    """Bytes of one batch element's (2, 3, ph, pw) padded level plane in the
    TPU kernel's layout (the JAX package's ``tail_plane_bytes``)."""
    return 2 * 3 * (16 + _round_up(h, 8)) * (256 + _round_up(w, 128)) * 4


def tail2_engages(remaining: int, h: int, w: int) -> bool:
    """Whether kernel 2 takes the five remaining levels from an h x w level:
    the JAX package's ``tail2_ok`` geometry gate without its padded-buffer
    clause, which the port's unpadded planes always meet."""
    return remaining == 5 and min(h, w) >= 48 and w <= 1024


def level_route(h: int, w: int, num_scales: int, first_level: int = 0) -> list:
    """The kernels the level chain runs from an h x w level ``first_level``
    of a ``num_scales`` pyramid: a list of (kernel, levels), the kernel named
    by its wrapper (``fused_pyramid_tail``, kernel 2; ``fused_tail``, #4;
    ``fused_scale_rgb``, #3 with the next level emitted)."""
    route = []
    s = first_level
    while s < num_scales:
        rest = tuple(range(s, num_scales))
        if tail2_engages(len(rest), h, w):
            return route + [("fused_pyramid_tail", rest)]
        if len(rest) >= 2 and tail_plane_bytes(h, w) <= TAIL_MAX_BYTES:
            return route + [("fused_tail", rest)]
        route.append(("fused_scale_rgb", (s,)))
        h, w = (h + 1) // 2, (w + 1) // 2
        s += 1
    return route


def _whole(columns, w: int):
    """``columns`` as a checked (lo, hi) window of a w wide level, None
    where it is the whole width."""
    if columns is None:
        return None
    win = window(columns, w)
    return None if win == (0, w) else win


def _next(win):
    return None if win is None else next_window(*win)


def level_sums_chain(p12, first_level: int, taps, opsin, *, num_scales: int, columns=None) -> list:
    """(B, 3, 6) sums of levels ``first_level`` .. ``num_scales - 1`` from
    the contiguous (2, B, 3, h, w) f32 linear-RGB plane of level
    ``first_level``, through the kernels ``level_route`` picks (the JAX
    package's ``ssimulacra2_subscores_from_padded`` loop on the unpadded
    layout), each level's sums over the owned columns ``columns`` of this
    first level (None: the whole width) and their ``next_window`` on each
    next one.  The route is the plane's own: a column strip may take
    another than its frame, and every route computes the same pixels.
    Each kernel's call is a span of its own, and its levels are counted
    (``ROUTE_RECORDS``)."""
    win = _whole(columns, p12.shape[-1])
    out = []
    for kernel, levels in level_route(p12.shape[-2], p12.shape[-1], num_scales, first_level):
        name, counter = ROUTE_RECORDS[kernel]
        with span(name):
            if kernel == "fused_scale_rgb":
                sums, p12 = fused_scale_rgb(p12, taps, opsin, emit_ds=levels[0] + 1 < num_scales, columns=win)
                out.append(sums)
                win = _next(win)
            else:
                run = fused_pyramid_tail if kernel == "fused_pyramid_tail" else fused_tail
                out += list(run(p12, len(levels), taps, opsin, columns=win).unbind(1))
        count(counter, len(levels))
    return out


def default_backend(device) -> str:
    """The level chain on cuda, the plain chain on the CPU (the JAX
    package's ``default_backend``: Pallas on the TPU, jnp elsewhere)."""
    return "pallas3" if torch.device(device).type == "cuda" else "jnp"


# The zero-weight masks on their devices, by (device, needs): ``_needs_mask``.
_MASKS: dict = {}


def _needs_mask(needs, device) -> torch.Tensor:
    """The (3, S, 2, 3) f32 0/1 mask of ``needs`` on ``device``, built and
    uploaded at the first call for its key and kept: the upload from
    pageable host memory waits for all the work queued on the device, so a
    step that made it on every batch would wait for its own kernels.  Each
    upload counts one ``consts.uploads``."""
    try:
        key = (device, needs)
        mask = _MASKS.get(key)
    except TypeError:
        # Flags given as lists: the same flags as nested tuples.
        key = (device, tuple(tuple(tuple(per_c) for per_c in per_s) for per_s in needs))
        mask = _MASKS.get(key)
    if mask is None:
        m = np.zeros((3, len(needs), 2, 3), np.float32)
        for s, per_ch in enumerate(needs):
            for c in range(3):
                for k in range(6):
                    if per_ch[c][k]:
                        m[c, s, k % 2, k // 2] = 1.0
        mask = _MASKS[key] = torch.from_numpy(m).to(device)
        count("consts.uploads")
    return mask


def _apply_needs_mask(out: torch.Tensor, needs) -> torch.Tensor:
    """Zero the (..., 3, S, 2, 3) sub-scores whose weight is zero, so every
    route emits the same zero pattern as the JAX package
    (``weight_needs``: 56 of the 108 weights are zero); ``needs``: per
    scale, per channel, the six flags of ``weight_needs``, or None for no
    mask."""
    if needs is None:
        return out
    return out * _needs_mask(needs, out.device)


def _on(t, device) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.device == device


def _level_consts(taps, opsin, device):
    """The kernels' (11,) f32 taps and opsin vector on ``device``: f32
    tensors already there pass through, None takes the built-in constants."""
    if not _on(taps, device):
        taps = torch.tensor(taps_f32(taps), dtype=torch.float32, device=device)
    if not _on(opsin, device):
        opsin = torch.as_tensor(opsin_vector() if opsin is None else opsin, dtype=torch.float32).to(device)
    return taps.contiguous(), opsin.contiguous()


def _plain_levels(lin_ref, lin_dis, num_scales: int, blur, opsin):
    """The plain chain, level by level: (xyb1, xyb2, mu1, mu2, s11, s22,
    s12), the XYB pair and its five blurs, like the reference's fused blur
    launch (ssimulacra2-cuda/src/kernel.rs:219-277)."""
    for s in range(num_scales):
        if s:
            lin_ref, lin_dis = downscale_by_2(lin_ref), downscale_by_2(lin_dis)
        xyb1 = linear_rgb_to_xyb(lin_ref, opsin=opsin)
        xyb2 = linear_rgb_to_xyb(lin_dis, opsin=opsin)
        stacked = torch.cat([xyb1, xyb2, xyb1 * xyb1, xyb2 * xyb2, xyb1 * xyb2], dim=1)
        yield (xyb1, xyb2, *torch.chunk(blur(stacked), 5, dim=1))


def _plain_level_sums(lin_ref, lin_dis, num_scales: int, blur, opsin, win) -> list:
    """The plain chain's per-level (B, 3, 6) f64 sums over the window
    ``win`` of owned level-0 columns (None: every column): ``scale_norms``'
    maps, summed instead of averaged."""
    out = []
    for level in _plain_levels(lin_ref, lin_dis, num_scales, blur, opsin):
        quantities = []
        for m in plain_maps(*level):
            m2 = m * m
            quantities += [m, m2 * m2]
        if win is not None:
            quantities = [q[..., win[0]:win[1]] for q in quantities]
        out.append(torch.stack([q.double().sum(dim=(-2, -1)) for q in quantities], dim=-1))
        win = _next(win)
    return out


def _resolve_backend(backend: str, device) -> str:
    if backend == "auto":
        backend = default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {('auto',) + BACKENDS}")
    return backend


def ssimulacra2_level_sums(
    lin_ref: torch.Tensor,
    lin_dis: torch.Tensor,
    *,
    num_scales: int,
    backend: str = "jnp",
    taps=None,
    opsin=None,
    columns=None,
) -> list:
    """Per-level (B, 3, 6) sums (d, d^4, art, art^4, det, det^4) of (B, 3,
    H, W) linear-RGB pairs over the owned columns ``columns`` (module
    docstring), by ``backend`` as ``ssimulacra2_subscores`` routes it: f32
    from the kernel routes, f64 from the plain ones.  ``jnp_iir`` takes no
    window narrower than the frame: its recursive blur reaches the whole
    row, so no finite halo makes a strip's pixels the frame's."""
    backend = _resolve_backend(backend, lin_ref.device)
    win = _whole(columns, lin_ref.shape[-1])
    if backend in ("jnp", "jnp_iir"):
        if backend == "jnp_iir" and win is not None:
            raise ValueError(
                "backend 'jnp_iir' takes no window of owned columns: its recursive blur reaches "
                "the whole row, so no finite halo serves a column strip"
            )
        blur = blur_2d_iir if backend == "jnp_iir" else functools.partial(blur_2d, taps=taps)
        return _plain_level_sums(lin_ref, lin_dis, num_scales, blur, opsin, win)

    taps, opsin = _level_consts(taps, opsin, lin_ref.device)
    lin_ref, lin_dis = lin_ref.to(torch.float32), lin_dis.to(torch.float32)
    if backend == "pallas3":
        # One copy into the pair buffer, also from a column strip's views.
        p12 = torch.stack([lin_ref, lin_dis])
        return level_sums_chain(p12, 0, taps, opsin, num_scales=num_scales, columns=win)
    lin_ref, lin_dis = lin_ref.contiguous(), lin_dis.contiguous()
    sums = []
    for s in range(num_scales):
        if s:
            win = _next(win)
        if backend == "pallas":
            # Plain downscale and XYB (the JAX route's jnp), then kernel #8.
            if s:
                lin_ref, lin_dis = downscale_by_2(lin_ref), downscale_by_2(lin_dis)
            sums.append(scale_sums(
                linear_rgb_to_xyb(lin_ref, opsin=opsin), linear_rgb_to_xyb(lin_dis, opsin=opsin), taps,
                columns=win,
            ))
        else:
            # Kernel #10 per level, kernel #7 on each image between levels.
            if s:
                lin_ref = downscale_kernel.downscale_by_2(lin_ref)
                lin_dis = downscale_kernel.downscale_by_2(lin_dis)
            sums.append(fused_scale_pair(lin_ref, lin_dis, taps, opsin, columns=win))
    return sums


def ssimulacra2_subscores(
    lin_ref: torch.Tensor,
    lin_dis: torch.Tensor,
    *,
    num_scales: int,
    backend: str = "jnp",
    taps=None,
    opsin=None,
) -> torch.Tensor:
    """Sub-scores for (B, 3, H, W) f32 linear-RGB frame pairs.

    Output: (B, 3, num_scales, 2, 3) f32.  ``backend`` takes the JAX
    package's names for its routes (module docstring; ``auto`` is
    ``default_backend`` of the inputs' device); on a CPU tensor every kernel
    runs its plain twin, as the JAX package's ``interpret*`` routes run
    theirs.  The plain chains blur
    five quantities per level (``_plain_levels``).
    """
    backend = _resolve_backend(backend, lin_ref.device)
    if backend in ("jnp", "jnp_iir"):
        blur = blur_2d_iir if backend == "jnp_iir" else functools.partial(blur_2d, taps=taps)
        per_scale = [scale_norms(*q) for q in _plain_levels(lin_ref, lin_dis, num_scales, blur, opsin)]
        return _apply_needs_mask(torch.stack(per_scale, dim=2), weight_needs(num_scales))
    sums = ssimulacra2_level_sums(lin_ref, lin_dis, num_scales=num_scales, backend=backend, taps=taps, opsin=opsin)
    return subscores_from_sums(sums, scale_dims(lin_ref.shape[-2], lin_ref.shape[-1], num_scales))


def resolve_needs(needs, num_scales: int):
    """The JAX package's ``needs`` argument as masks: "auto" the zero
    weights of a ``num_scales`` pyramid (``weight_needs``), None no mask,
    else the per-scale masks given."""
    return weight_needs(num_scales) if isinstance(needs, str) and needs == "auto" else needs


# The levels' 1 / (level pixels) factors on their devices, by (device, dtype,
# dims): ``_inv_pixels``.
_INV_PIXELS: dict = {}


def _inv_pixels(dims, dtype: torch.dtype, device) -> torch.Tensor:
    """(S, 1) factors 1 / (h * w) of the levels ``dims`` at ``dtype`` on
    ``device``: ``norms_from_sums``' Python-float factor, which torch takes
    at the sums' type, kept on the device like ``_needs_mask`` (each upload
    counts one ``consts.uploads``)."""
    key = (device, dtype, tuple(dims))
    inv = _INV_PIXELS.get(key)
    if inv is None:
        inv = _INV_PIXELS[key] = torch.tensor([[1.0 / (h * w)] for h, w in dims], dtype=dtype).to(device)
        count("consts.uploads")
    return inv


def subscores_from_sums(sums_per_level: list, dims, needs="auto") -> torch.Tensor:
    """Per-level (B, 3, 6) sums at pyramid ``dims`` -> masked (B, 3, S, 2, 3)
    f32 sub-scores (norms taken at the sums' precision, which the levels
    share; ``needs`` as ``resolve_needs`` takes it).  The sums of a frame's
    column strips, added, take the whole frame's ``scale_dims``; levels past
    ``dims`` (a chain run on past a short pyramid's end) are left out.
    Every level's norms in one pass: the operations of ``norms_from_sums``
    on the stacked levels, each level by its own factor, so the same bits
    in a few launches where a pass per level made five each."""
    levels = sums_per_level[:len(dims)]
    if len({s.dtype for s in levels}) != 1:
        raise ValueError(f"the levels' sums must share one dtype, got {[s.dtype for s in levels]}")
    sums = torch.stack(levels, dim=-2)
    inv = _inv_pixels(dims[:len(levels)], sums.dtype, sums.device)
    n1 = sums[..., 0::2] * inv
    n4 = torch.sqrt(torch.sqrt(sums[..., 1::2] * inv))
    return _apply_needs_mask(torch.stack([n1, n4], dim=-2), resolve_needs(needs, len(dims))).float()


def _subscores(first, h: int, w: int, taps, opsin, num_scales: int, needs) -> torch.Tensor:
    """The kernel entries' one body: in the span ``.levels`` the first-level
    pass ``first(emit_ds=...)`` -> (level 0's sums, level 1), then the level
    chain from level 1; in the span ``.norms`` the h x w frame's masked
    sub-scores."""
    with span("tm.step.ssimulacra2.levels"):
        sums0, level1 = first(emit_ds=num_scales > 1)
        levels = [sums0]
        if num_scales > 1:
            levels += level_sums_chain(level1, 1, taps, opsin, num_scales=num_scales)
    with span("tm.step.ssimulacra2.norms"):
        return subscores_from_sums(levels, scale_dims(h, w, num_scales), needs)


def ssimulacra2_level_sums_from_yuv(
    y2: torch.Tensor,
    uv2: torch.Tensor,
    taps: torch.Tensor,
    opsin: torch.Tensor,
    *,
    num_scales: int,
    depth: int = 8,
    matrix: str = "bt709",
    transfer: str = "bt709",
    full_range: bool = False,
    kr_kb=None,
    columns=None,
) -> list:
    """Per-level (B, 3, 6) f32 sums of ``ssimulacra2_subscores_from_yuv``
    over the owned columns ``columns`` (module docstring)."""
    win = _whole(columns, y2.shape[-1])
    sums0, level1 = fused_scale0_yuv(
        y2, uv2, taps, opsin, depth=depth, matrix=matrix, transfer=transfer,
        full_range=full_range, emit_ds=num_scales > 1, kr_kb=kr_kb, columns=win,
    )
    levels = [sums0]
    if num_scales > 1:
        levels += level_sums_chain(level1, 1, taps, opsin, num_scales=num_scales, columns=_next(win))
    return levels


def ssimulacra2_subscores_from_yuv(
    y2: torch.Tensor,
    uv2: torch.Tensor,
    taps: torch.Tensor,
    opsin: torch.Tensor,
    *,
    num_scales: int,
    depth: int = 8,
    matrix: str = "bt709",
    transfer: str = "bt709",
    full_range: bool = False,
    kr_kb=None,
    needs="auto",
) -> torch.Tensor:
    """Sub-scores straight from (2, B, h, w) luma + (2, B, ch, cw, 2) chroma.

    Scale 0 runs conversion-fused (kernel 1, full-resolution linear RGB never
    stored); the remaining ``num_scales - 1`` levels run from its emitted
    level 1 through the level chain (kernel 2 at 1080p and 720p; #3 twice,
    then #4, at 3840x2160).  Returns (B, 3, num_scales, 2, 3) f32.
    ``needs``: the JAX package's zero-weight masks ("auto", None or per
    scale, ``resolve_needs``).  JAX's kernels skip the masked work; the
    port computes every sub-score and zeroes the masked ones, so None only
    keeps them.
    """
    first = functools.partial(
        fused_scale0_yuv, y2, uv2, taps, opsin, depth=depth, matrix=matrix, transfer=transfer,
        full_range=full_range, kr_kb=kr_kb,
    )
    return _subscores(first, y2.shape[-2], y2.shape[-1], taps, opsin, num_scales, needs)


def _scale_rgb_recorded(p12, taps, opsin, *, emit_ds: bool):
    """Kernel #3, recorded as the level chain records its #3 calls."""
    name, counter = ROUTE_RECORDS["fused_scale_rgb"]
    with span(name):
        out = fused_scale_rgb(p12, taps, opsin, emit_ds=emit_ds)
    count(counter)
    return out


def ssimulacra2_subscores_from_rgb(
    p12: torch.Tensor, taps: torch.Tensor, opsin: torch.Tensor, *, num_scales: int, needs="auto"
) -> torch.Tensor:
    """Sub-scores from a contiguous (2, B, 3, h, w) f32 linear-RGB pair
    buffer (the counterpart of the JAX package's
    ``ssimulacra2_subscores_from_padded``): scale 0 through kernel #3 with
    level 1 emitted (recorded as the chain records its #3 calls), the
    remaining ``num_scales - 1`` levels through the level chain.  Returns
    (B, 3, num_scales, 2, 3) f32; ``needs`` as for
    ``ssimulacra2_subscores_from_yuv``."""
    first = functools.partial(_scale_rgb_recorded, p12, taps, opsin)
    return _subscores(first, p12.shape[-2], p12.shape[-1], taps, opsin, num_scales, needs)


def ssimulacra2_subscores_from_srgb(
    ref: torch.Tensor,
    dis: torch.Tensor,
    taps: torch.Tensor,
    opsin: torch.Tensor,
    table: torch.Tensor,
    *,
    num_scales: int,
    depth: int = 8,
    needs="auto",
) -> torch.Tensor:
    """Sub-scores straight from the reference's and the distorted input's
    (B, h, w, 3) packed integer sRGB codes (uint8 or uint16 both).

    Scale 0 runs conversion-fused (``fused_scale_srgb`` through ``table``,
    ``Ssimulacra2.code_table``; full-resolution linear RGB never stored);
    the remaining ``num_scales - 1`` levels run from its emitted level 1
    through the level chain.  Returns (B, 3, num_scales, 2, 3) f32, equal
    bit for bit to ``ssimulacra2_subscores_from_rgb`` on the pair buffer of
    ``colorspace.srgb_pair_to_linear``; ``needs`` as for
    ``ssimulacra2_subscores_from_yuv``."""
    first = functools.partial(fused_scale_srgb, ref, dis, taps, opsin, table, depth=depth)
    return _subscores(first, ref.shape[1], ref.shape[2], taps, opsin, num_scales, needs)


def _width_entry(fn):
    """(the per-strip sums function of the entry ``fn`` calls, whether it
    is the YUV entry, its keywords): ``fn`` is ``ssimulacra2_subscores`` or
    ``ssimulacra2_subscores_from_yuv``, bare or through functools.partial
    with keywords only (parallel/mesh.py ``shard_over_width`` picks this
    module's strip loop for them)."""
    base, kw = partial_keywords(fn)
    if base is ssimulacra2_subscores:
        return ssimulacra2_level_sums, False, kw
    if base is ssimulacra2_subscores_from_yuv:
        return ssimulacra2_level_sums_from_yuv, True, kw
    raise TypeError(f"subscores_width_sharded takes the SSIMULACRA2 sub-scores entries, not {fn!r}")


def _pyramid(h: int, w: int, num_scales: int) -> list:
    """Every level's dims of a ``num_scales`` chain, whatever their size:
    the plain chains compute and average all of them, where ``scale_dims``
    stops below 8."""
    out = [(h, w)]
    for _ in range(num_scales - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w))
    return out


def subscores_width_sharded(fn, mesh, *, in_ndims):
    """``fn`` with one frame's columns split over ``mesh`` (parallel/mesh.py
    module docstring).  ``fn``: ``ssimulacra2_subscores`` (inputs the (B, 3,
    H, W) linear-RGB pair, ``in_ndims`` (4, 4); ``backend`` any but
    ``jnp_iir``, whose recursive blur reaches the whole row) or
    ``ssimulacra2_subscores_from_yuv`` (inputs (2, B, h, w) luma and (2, B,
    ch, cw, 2) 4:2:0 chroma, ``in_ndims`` (4, 5); ``taps`` and ``opsin``
    among its keywords, ``needs`` applied to the joined sums), bare or
    through functools.partial.  Each call plans
    the strips (``spatial_sharding``), and each strip, under its device and
    its stream (``launch_shards``), takes its columns of the inputs
    (``strip_input``: a view of an RGB input already on its device, else a
    contiguous cut uploaded there) and runs its per-level sums over its
    owned window; the strips' sums add in f64 on ``mesh.devices[0]``, where
    the sub-scores are returned, normalised by the whole frame's level
    sizes as the unsharded ``fn`` normalises them.  A mesh of one runs
    ``fn`` unchanged on its device.  Any other ``fn`` raises
    ``TypeError``."""
    sums_fn, yuv, kw = _width_entry(fn)
    want = (4, 5) if yuv else (4, 4)
    if tuple(in_ndims) != want:
        raise ValueError(f"{fn!r} takes inputs of {want} dims, got in_ndims={tuple(in_ndims)}")
    if "num_scales" not in kw:
        raise TypeError("width sharding needs fn's num_scales (functools.partial(fn, num_scales=...))")
    if not yuv and kw.get("backend", "jnp") == "jnp_iir":
        raise ValueError(
            "backend 'jnp_iir' does not shard over the width: its recursive blur reaches the whole row, "
            "so no finite halo serves a column strip"
        )
    if yuv and ("taps" not in kw or "opsin" not in kw):
        raise TypeError("width sharding of ssimulacra2_subscores_from_yuv needs its taps and opsin as keywords")
    num_scales = int(kw["num_scales"])
    needs = kw.pop("needs", "auto") if yuv else "auto"
    dest = mesh.devices[0]
    plain = not yuv and _resolve_backend(kw.get("backend", "jnp"), dest) == "jnp"

    def sharded(*args):
        check_inputs(args, in_ndims)
        if mesh.size == 1:
            return fn(*(upload(a, dest) for a in args))
        h, w = args[0].shape[-2], args[0].shape[-1]
        plan = spatial_sharding(mesh, w, num_scales=num_scales, chroma=yuv)

        def strip_sums(k, dev):
            kwk = dict(kw)
            if yuv:
                kwk["taps"], kwk["opsin"] = _level_consts(kw["taps"], kw["opsin"], dev)
            parts = [strip_input(a, plan[k], dev, chroma=yuv and i == 1, view=not yuv) for i, a in enumerate(args)]
            return torch.stack(sums_fn(*parts, **kwk, columns=plan[k].columns), dim=1)

        total = add_strips(launch_shards(strip_sums, mesh), dest)
        dims = _pyramid(h, w, num_scales) if plain else scale_dims(h, w, num_scales)
        return subscores_from_sums(list(total.unbind(1)), dims, needs)

    return sharded


def builtin_constants() -> dict:
    """The constants that stand in for weights, as numpy arrays: the 108
    score weights, the 11 blur taps (f64), the opsin matrix, bias and bias
    root, and the (kr, kb) pair of each YCbCr matrix (``MATRIX_NAMES``)."""
    return {
        "weights": WEIGHTS.copy(),
        "taps": gaussian_taps().copy(),
        "opsin_matrix": OPSIN_ABSORBANCE_MATRIX.copy(),
        "opsin_bias": np.float32(OPSIN_ABSORBANCE_BIAS),
        "opsin_bias_root": np.float32(OPSIN_ABSORBANCE_BIAS_ROOT),
        "matrix_kr_kb": np.array(
            [colorspace.MATRIX_KR_KB[m] for m in MATRIX_NAMES], dtype=np.float64
        ),
    }


def resolve_device(device) -> torch.device:
    """An explicit device; CUDA must be present when asked for.

    On CUDA, TF32 is switched off for matmul and cuDNN: the blur's tap sums
    must stay exact in f32 (a 1.3e-6 tap-sum error moves the score ~0.05).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but CUDA is not available "
                "(pass device='cpu' / --device cpu to run the plain path)"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class Ssimulacra2(nn.Module):
    """Per-resolution SSIMULACRA2 scorer on an explicit device.

    Buffers ``taps`` and ``opsin`` hold the blur taps and the opsin matrix
    (9 entries, bias, bias root) as f32 on the device, where the kernels read
    them; the f64 score weights and the YCbCr (kr, kb) pairs stay on the host,
    where they are used.  ``constants_from_numpy`` installs replacements.

    ``backend`` (``auto`` or a name of ``BACKENDS``), resolved once here
    (``auto``: ``default_backend`` of the device): ``pallas3`` keeps
    ``forward`` on the kernel path of ``subscores_from_rgb``; any other name
    routes it through ``ssimulacra2_subscores``.
    """

    def __init__(self, width: int, height: int, *, batch: int = 1, backend: str = "auto", device="cuda"):
        super().__init__()
        if backend != "auto" and backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {('auto',) + BACKENDS}")
        dev = resolve_device(device)
        self.backend = default_backend(dev) if backend == "auto" else backend
        self.width = int(width)
        self.height = int(height)
        # The JAX class's batch, the B its jitted program is compiled for;
        # the port runs eagerly, at any B.
        self.batch = int(batch)
        self.dims = scale_dims(self.height, self.width, NUM_SCALES)
        self.num_scales = len(self.dims)
        if self.num_scales == 0:
            raise ValueError("image must be at least 8x8")
        self.register_buffer("taps", torch.empty(11, dtype=torch.float32, device=dev))
        self.register_buffer("opsin", torch.empty(11, dtype=torch.float32, device=dev))
        self.constants_from_numpy(builtin_constants())
        self._code_tables: dict = {}

    @property
    def device(self) -> torch.device:
        return self.taps.device

    def constants_from_numpy(self, d: dict) -> None:
        """Install constants given as numpy arrays (``builtin_constants``
        keys), e.g. the JAX package's, into the module."""
        taps = np.asarray(d["taps"], dtype=np.float64).astype(np.float32)
        opsin = opsin_vector(d["opsin_matrix"], d["opsin_bias"], d["opsin_bias_root"])
        with torch.no_grad():
            self.taps.copy_(torch.from_numpy(taps))
            self.opsin.copy_(torch.from_numpy(opsin))
        self.weights = np.asarray(d["weights"], dtype=np.float64).copy()
        kr_kb = np.asarray(d["matrix_kr_kb"], dtype=np.float64)
        self.kr_kb = {m: (float(kr_kb[i, 0]), float(kr_kb[i, 1])) for i, m in enumerate(MATRIX_NAMES)}

    @torch.no_grad()
    def forward(self, lin_ref: torch.Tensor, lin_dis: torch.Tensor) -> torch.Tensor:
        """Sub-scores of (B, 3, H, W) linear-RGB pairs by the module's
        backend."""
        if self.backend == "pallas3":
            p12 = torch.stack([lin_ref, lin_dis]).to(self.device, torch.float32).contiguous()
            return self.subscores_from_rgb(p12)
        return ssimulacra2_subscores(
            lin_ref.to(self.device, torch.float32), lin_dis.to(self.device, torch.float32),
            num_scales=self.num_scales, backend=self.backend, taps=self.taps, opsin=self.opsin,
        )

    def subscores_device(self, lin_ref: torch.Tensor, lin_dis: torch.Tensor) -> torch.Tensor:
        """The JAX class's name for ``forward``: sub-scores of (B, 3, H, W)
        f32 linear-RGB pairs, on the module's device."""
        return self(lin_ref, lin_dis)

    @torch.no_grad()
    def subscores_from_rgb(self, p12: torch.Tensor) -> torch.Tensor:
        return ssimulacra2_subscores_from_rgb(
            p12, self.taps, self.opsin, num_scales=self.num_scales
        )

    def code_table(self, dtype: torch.dtype, depth: int) -> torch.Tensor:
        """``scale_stats.code_table`` on the module's device, built at the
        first call for its (type, depth) and kept.  On a card the build is
        waited for once, so that a shard stream of the same card may read
        the table at once; that wait counts one ``consts.uploads``."""
        key = (dtype, int(depth))
        table = self._code_tables.get(key)
        if table is None:
            table = code_table(dtype, depth, self.device)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self._code_tables[key] = table
            count("consts.uploads")
        return table

    @torch.no_grad()
    def subscores_from_srgb(self, ref, dis, *, depth=8) -> torch.Tensor:
        return ssimulacra2_subscores_from_srgb(
            ref, dis, self.taps, self.opsin, self.code_table(ref.dtype, depth), num_scales=self.num_scales,
            depth=depth,
        )

    @torch.no_grad()
    def subscores_from_yuv(
        self, y2, uv2, *, depth=8, matrix="bt709", transfer="bt709", full_range=False
    ) -> torch.Tensor:
        return ssimulacra2_subscores_from_yuv(
            y2, uv2, self.taps, self.opsin, num_scales=self.num_scales,
            depth=depth, matrix=matrix, transfer=transfer, full_range=full_range,
            kr_kb=self.kr_kb[matrix],
        )

    def subscores_direct(self, spec_ref, spec_dis, arr_ref: tuple, arr_dis: tuple, pair):
        """Sub-scores straight from the inputs' planes where a first-level
        pass takes them (the span ``tm.step.ssimulacra2``), else None, and
        the caller builds the pair buffer for ``subscores_from_rgb``: kernel
        1 from ``pair``, both inputs' planes stacked as uploaded for two
        inputs of one planar YUV spec (else None), at 4:2:0; the sRGB pass
        from the packed codes ``arr_*[0]`` of one sRGB spec and one type of
        ``CODE_TABLE_SIZES``.  ``spec_*``: the inputs' conversion specs (the
        engine's ``ConvertSpec``)."""
        if pair is not None and spec_ref.chroma == 420:
            with span("tm.step.ssimulacra2"):
                return self.subscores_from_yuv(
                    *pair, depth=spec_ref.depth, matrix=spec_ref.matrix, transfer=spec_ref.transfer,
                    full_range=spec_ref.full_range,
                )
        ref, dis = arr_ref[0], arr_dis[0]
        if (
            spec_ref.kind == "rgb" and spec_ref.transfer == "srgb" and spec_ref == spec_dis
            and ref.dtype == dis.dtype and ref.dtype in CODE_TABLE_SIZES
        ):
            with span("tm.step.ssimulacra2"):
                return self.subscores_from_srgb(ref, dis, depth=spec_ref.depth)
        return None

    def score(self, subscores) -> np.ndarray:
        """(B, 3, S, 2, 3) sub-scores, a tensor or its values on the host ->
        (B,) f64 scores on the host."""
        if torch.is_tensor(subscores):
            subscores = to_host(subscores)
        return postprocess_score(subscores.astype(np.float64), self.weights)

    def score_batch(self, lin_ref, lin_dis) -> np.ndarray:
        """Scores for a batch of (B, 3, H, W) frame pairs -> (B,) f64."""
        return self.score(self(torch.as_tensor(lin_ref), torch.as_tensor(lin_dis)))

    def score_pair(self, lin_ref, lin_dis) -> float:
        """Score a single (3, H, W) or (H, W, 3) linear-RGB pair."""
        return float(self.score_batch(_to_planar_batch(lin_ref), _to_planar_batch(lin_dis))[0])


def _to_planar_batch(img) -> torch.Tensor:
    img = torch.as_tensor(np.asarray(img, dtype=np.float32))
    if img.ndim == 3 and img.shape[-1] == 3 and img.shape[0] != 3:
        img = img.permute(2, 0, 1)
    if img.ndim == 3:
        img = img[None]
    return img
