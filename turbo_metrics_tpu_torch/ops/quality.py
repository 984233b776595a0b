"""Classic quality metrics: PSNR, SSIM, MS-SSIM on 8-bit-quantized RGB.

Counterpart of the JAX package's ops/quality.py (itself standing in for the
NPP primitives the reference calls, turbo-metrics/src/lib.rs:296-339).  Like
the reference, these operate on linear-RGB frames quantized to 8 bits;
inputs of ``psnr``/``ssim``/``msssim``/``ssim_msssim`` are f32 tensors
holding code values in [0, 255], layout (..., 3, H, W).  SSIM is Wang et al.
2004 with an 11x11 sigma=1.5 Gaussian window on the valid region; MS-SSIM
Wang et al. 2003 with the standard five scale weights.

Two routes, as for SSIMULACRA2:
  * the plain functions here (``_ssim_parts`` and what builds on it), the
    counterpart of the JAX jnp path and the twins the kernels are held
    against;
  * the kernels of ops/kernels/windowed.py (#11: level 0, quantized at load
    in the multi-metric path) and ops/kernels/windowed_tail.py (#12: the
    MS-SSIM levels after it), which run their CUDA kernels on CUDA tensors
    and the plain functions on CPU tensors.  ``quality_from_rgb``, the
    multi-metric path on the converted linear-RGB pair buffer, takes them
    always; ``ssim``, ``msssim`` and ``ssim_msssim`` on code values take
    them as their JAX namesakes take the Pallas kernels, by ``backend``
    (``resolve_backend``; JAX's gate ``kernel_ok``: three channels and both
    dims at least 11, else the plain chain).
PSNR stays a plain torch expression, as in the JAX package.
``quality_from_rgb`` is per-frame sums first (``quality_sums``: PSNR's
exact squared-difference sum and each SSIM level's per-channel sums, over a
window of owned columns where one is given), scores second
(``quality_from_sums``), so that the column strips of one frame
(``quality_width_sharded``, parallel/mesh.py ``shard_over_width``) add
their sums before the frame is scored.  ``plain_width_sharded`` does the
same for ``ssim``, ``msssim`` and ``ssim_msssim`` on code values.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from turbo_metrics_tpu_torch.models.ssimulacra2 import resolve_device
from turbo_metrics_tpu_torch.ops.colorspace import f32_to_uint8
from turbo_metrics_tpu_torch.ops.gaussian import gaussian_window
from turbo_metrics_tpu_torch.parallel.mesh import (
    add_strips,
    check_inputs,
    launch_shards,
    partial_keywords,
    spatial_sharding,
    strip_input,
    upload,
)

RADIUS = 5  # gaussian_window(11, 1.5)
C1 = float(np.float32((0.01 * 255.0) ** 2))
C2 = float(np.float32((0.03 * 255.0) ** 2))

MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], dtype=np.float64)

# The ``backend`` names of the JAX package's ssim / msssim / ssim_msssim
# that the port honours: "auto" (the kernels on a CUDA tensor, the plain
# chain on a CPU tensor, as JAX takes Pallas on the TPU and jnp elsewhere),
# "jnp" (the plain chain anywhere) and "pallas" (the kernels, which run
# their plain twins on a CPU tensor).  JAX's "interpret" runs the Pallas
# interpreter, which the port has no counterpart of.
BACKENDS = ("auto", "jnp", "pallas")


# Squared differences of 8-bit codes summed per run of PSNR_RUN in f32: each
# run's sum stays below 2**24 (256 * 255**2), so it is exact in any order.
PSNR_RUN = 256


def psnr_sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The sum of squared differences over all channels, f64; (..., C, H,
    W) -> (...,).  Summed in runs of PSNR_RUN in f32, the runs' sums in
    f64: for 8-bit codes every sum is exact, so the sums of a frame's column
    strips add to the frame's bit for bit."""
    diff = a - b
    sq = (diff * diff).flatten(-3)
    n = sq.shape[-1]
    if n % PSNR_RUN:
        sq = torch.nn.functional.pad(sq, (0, PSNR_RUN - n % PSNR_RUN))
    runs = sq.unflatten(-1, (-1, PSNR_RUN)).sum(dim=-1)
    return torch.sum(runs, dim=-1, dtype=torch.float64)


def psnr_from_sse(sse: torch.Tensor, n: int, *, peak: float = 255.0) -> torch.Tensor:
    """PSNR in dB, f32, from ``psnr_sse`` over ``n`` samples: the mean
    rounded once to f32."""
    mse = (sse / n).to(torch.float32)
    return 10.0 * torch.log10(float(np.float32(peak * peak)) / mse)


def psnr(a: torch.Tensor, b: torch.Tensor, *, peak: float = 255.0) -> torch.Tensor:
    """PSNR in dB over all channels, f32; (..., C, H, W) -> (...,).  An
    identical pair gives inf.

    The squared differences are summed exactly (``psnr_sse``) and the mean
    rounded once to f32.  For 8-bit codes (the engine's quantized pairs) a
    frame's PSNR does not depend on the batch or the shard it is scored in;
    an f32 mean does (torch splits its reduction by the number of frames,
    which at 1080p moves the dB by ~2e-6)."""
    return psnr_from_sse(psnr_sse(a, b), a.shape[-3] * a.shape[-2] * a.shape[-1], peak=peak)


def _window_list(win) -> list[float]:
    """The window taps as f32-exact Python floats (default: the 11-tap
    sigma=1.5 window)."""
    if win is None:
        win = gaussian_window(11, 1.5)
    if isinstance(win, torch.Tensor):
        win = win.detach().cpu().numpy()
    return [float(v) for v in np.asarray(win).astype(np.float32)]


def _filter_valid(x: torch.Tensor, win) -> torch.Tensor:
    """Separable 'valid' correlation with a 1D window over the last two axes,
    a sum of shifted products in tap order (the JAX package's order)."""
    w = _window_list(win)
    n = len(w)
    wdim = x.shape[-1] - n + 1
    x = sum(w[k] * x[..., k : k + wdim] for k in range(n))
    hdim = x.shape[-2] - n + 1
    return sum(w[k] * x[..., k : k + hdim, :] for k in range(n))


def _ssim_parts(a, b, win=None, c1: float = C1, c2: float = C2):
    """Per-pixel (luminance, cs) maps over the valid grid, five blurs (the
    jnp formulation)."""
    mu1 = _filter_valid(a, win)
    mu2 = _filter_valid(b, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s11 = _filter_valid(a * a, win) - mu1_sq
    s22 = _filter_valid(b * b, win) - mu2_sq
    s12 = _filter_valid(a * b, win) - mu12
    luminance = (2.0 * mu12 + c1) / (mu1_sq + mu2_sq + c1)
    cs = (2.0 * s12 + c2) / (s11 + s22 + c2)
    return luminance, cs


def _level_means(a, b):
    luminance, cs = _ssim_parts(a, b)
    return (
        torch.mean(luminance * cs, dim=(-3, -2, -1)),
        torch.mean(cs, dim=(-3, -2, -1)),
    )


def resolve_backend(backend: str, device) -> str:
    """``backend`` as the route it names: "jnp" (the plain chain) or
    "pallas" (the kernels); "auto" is "pallas" on cuda and "jnp" elsewhere.
    ``ValueError`` for any other name, listing those the port takes."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "jnp"
    return backend


def kernel_ok(a: torch.Tensor, backend: str) -> bool:
    """Whether ``a`` (..., C, H, W) takes the kernels: JAX's gate
    (ops/quality.py ``_pallas_ok``), three channels and both dims at least
    the window's 11, under the resolved ``backend``."""
    return (resolve_backend(backend, a.device) == "pallas" and a.shape[-3] == 3
            and min(a.shape[-2], a.shape[-1]) >= 2 * RADIUS + 1)


_WINDOWS: dict = {}


def _window(device) -> torch.Tensor:
    """The 11 f32 taps of the SSIM window on ``device`` (made once)."""
    key = str(device)
    if key not in _WINDOWS:
        _WINDOWS[key] = torch.tensor(_window_list(None), dtype=torch.float32, device=device)
    return _WINDOWS[key]


def level_sums(p12: torch.Tensor, window: torch.Tensor, num_levels: int, *, quantize: bool, c1: float = C1,
               c2: float = C2, columns=None, plain: bool = False) -> list:
    """Per level its (B, 3, 2) f32 per-channel sums (``ssim_sums``), of a
    (2, B, 3, h, w) pair: level 0 by #11 (quantized at load with
    ``quantize``), levels 1 .. num_levels - 1 by #12 from the level #11
    emits; ``columns``: the owned columns of a column strip (None: the whole
    width); ``plain``: the kernels' plain twins in their place."""
    # Imported here: the kernel modules import this one for their twins.
    from turbo_metrics_tpu_torch.ops.kernels import windowed, windowed_tail

    sums_fn = windowed.ssim_sums_ref if plain else windowed.ssim_sums
    tail_fn = windowed_tail.msssim_tail_ref if plain else windowed_tail.msssim_tail
    sums0, ds = sums_fn(p12, window, quantize=quantize, emit_ds=num_levels > 1, c1=c1, c2=c2, columns=columns)
    out = [sums0]
    if num_levels > 1:
        cols1 = None if columns is None else (columns[0] // 2, columns[1] // 2)  # level 1's
        out += list(tail_fn(ds, num_levels - 1, window, c1=c1, c2=c2, columns=cols1).unbind(1))
    return out


def _kernel_level_means(a, b, num_levels: int) -> list:
    """Per level (mean(luminance*cs), mean(cs)) of (..., 3, h, w) code
    values by the kernels: the leading dims flattened to B, a and b stacked
    once into the (2, B, 3, h, w) pair #11 reads."""
    lead, (h, w) = a.shape[:-3], a.shape[-2:]
    p12 = torch.stack([a.reshape(-1, 3, h, w), b.reshape(-1, 3, h, w)]).to(torch.float32)
    sums = level_sums(p12, _window(p12.device), num_levels, quantize=False)
    return [tuple(m.reshape(lead) for m in means_from_sums(s, h >> li, w >> li)) for li, s in enumerate(sums)]


def ssim(a: torch.Tensor, b: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """Mean SSIM index; (..., C, H, W) -> (...,); ``backend``: the route
    (``resolve_backend``; the kernels where ``kernel_ok``)."""
    if kernel_ok(a, backend):
        return _kernel_level_means(a, b, 1)[0][0]
    return _level_means(a, b)[0]


def _downsample_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool with stride 2, truncating odd edges (MS-SSIM step)."""
    h, w = x.shape[-2] & ~1, x.shape[-1] & ~1
    x = x[..., :h, :w]
    x = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
    return x.mean(dim=(-3, -1))


def _clamp_levels(h: int, w: int, levels: int, weights=MSSSIM_WEIGHTS):
    """Clamp MS-SSIM levels so the 11x11 window still fits after
    downsampling (min dim >= 11 * 2^(levels-1)); renormalise the clamped
    weights to sum 1."""
    fit = max(1, (min(h, w) // 11).bit_length())
    levels = min(levels, fit)
    w_ = np.asarray(weights, dtype=np.float64)[:levels]
    if levels < len(weights):
        w_ = w_ / w_.sum()
    return levels, w_


def _msssim_levels(a, b, levels: int, backend: str):
    """Per-level (mean(luminance*cs), mean(cs)) plus the clamped weights, by
    the kernels where ``kernel_ok`` (one #11 launch and, past one level, one
    #12 launch, which takes any level count), else the plain chain.
    Level 0's first mean IS the single-scale SSIM index."""
    levels, weights = _clamp_levels(a.shape[-2], a.shape[-1], levels)
    if kernel_ok(a, backend):
        return _kernel_level_means(a, b, levels), weights
    per_level = []
    for lvl in range(levels):
        per_level.append(_level_means(a, b))
        if lvl < levels - 1:
            a = _downsample_2x2(a)
            b = _downsample_2x2(b)
    return per_level, weights


def _msssim_combine(per_level, weights) -> torch.Tensor:
    levels = len(per_level)
    result = None
    for lvl, (ml, mcs) in enumerate(per_level):
        base = ml if lvl == levels - 1 else mcs
        term = torch.pow(torch.clamp_min(base, 0.0), float(np.float32(weights[lvl])))
        result = term if result is None else result * term
    return result


def msssim(a: torch.Tensor, b: torch.Tensor, *, levels: int = 5, backend: str = "auto") -> torch.Tensor:
    """Multi-scale SSIM (Wang 2003); (..., C, H, W) -> (...,); ``backend``
    as for ``ssim``."""
    return _msssim_combine(*_msssim_levels(a, b, levels, backend))


def ssim_msssim(a, b, *, levels: int = 5, backend: str = "auto"):
    """(SSIM, MS-SSIM) sharing one level-0 pass: MS-SSIM's level 0 computes
    exactly the statistics SSIM needs; ``backend`` as for ``ssim``."""
    per_level, weights = _msssim_levels(a, b, levels, backend)
    return per_level[0][0], _msssim_combine(per_level, weights)


def means_from_sums(sums: torch.Tensor, h: int, w: int):
    """(B, 3, 2) per-channel sums of one h x w level -> (mean(luminance*cs),
    mean(cs)) over channels and the valid grid, each (B,)."""
    count = float(3 * (h - 2 * RADIUS) * (w - 2 * RADIUS))
    return sums[:, :, 0].sum(dim=-1) / count, sums[:, :, 1].sum(dim=-1) / count


def builtin_constants() -> dict:
    """The constants of the SSIM family as numpy arrays: the 11 window taps
    (f64), the stabilisers C1 and C2 (f32) and the five MS-SSIM weights."""
    return {
        "ssim_window": gaussian_window(11, 1.5),
        "c1": np.float32(C1),
        "c2": np.float32(C2),
        "msssim_weights": MSSSIM_WEIGHTS.copy(),
    }


def quality_sums(
    p12: torch.Tensor,
    window: torch.Tensor,
    *,
    want_psnr: bool = False,
    want_ssim: bool = False,
    want_msssim: bool = False,
    num_levels: int = 1,
    c1: float = C1,
    c2: float = C2,
    columns=None,
) -> dict:
    """The per-frame sums that ``quality_from_rgb`` scores, of a (2, B, 3,
    h, w) linear-RGB pair buffer: {"sse": (B,) f64 ``psnr_sse`` of the
    quantized pair (with ``want_psnr``), "levels": per SSIM level its (B,
    3, 2) f32 per-channel sums (``ssim_sums``, then ``msssim_tail`` for
    levels 1 .. num_levels - 1 with ``want_msssim``; level 0 alone with
    ``want_ssim``)}.  ``columns``: the owned columns (lo, hi) of a column
    strip of a frame (None: the whole width), whose samples PSNR sums and on
    which the SSIM levels' valid outputs are centred; ``num_levels`` is the
    whole frame's clamped MS-SSIM level count."""
    out = {}
    if want_psnr:
        q = f32_to_uint8(p12 if columns is None else p12[..., columns[0]:columns[1]], torch.float32)
        out["sse"] = psnr_sse(q[0], q[1])
    if want_msssim or want_ssim:
        out["levels"] = level_sums(p12, window, num_levels if want_msssim else 1, quantize=True, c1=c1, c2=c2,
                                   columns=columns)
    return out


def quality_from_sums(
    sums: dict,
    h: int,
    w: int,
    *,
    want_psnr: bool = False,
    want_ssim: bool = False,
    want_msssim: bool = False,
    weights=None,
) -> dict:
    """PSNR/SSIM/MS-SSIM, each (B,) f32, from ``quality_sums``' sums of an h
    x w frame: every level's means over the whole frame's valid grid (level
    l is (h >> l) x (w >> l)); ``weights``: the frame's clamped MS-SSIM
    weights (``_clamp_levels``)."""
    out = {}
    if want_psnr:
        out["psnr"] = psnr_from_sse(sums["sse"], 3 * h * w)
    if want_msssim or want_ssim:
        per_level = [means_from_sums(s, h >> li, w >> li) for li, s in enumerate(sums["levels"])]
        if want_msssim:
            out["msssim"] = _msssim_combine(per_level, weights)
        if want_ssim:
            out["ssim"] = per_level[0][0]
    return out


def quality_from_rgb(
    p12: torch.Tensor,
    window: torch.Tensor,
    *,
    want_psnr: bool = False,
    want_ssim: bool = False,
    want_msssim: bool = False,
    levels: int = 5,
    c1: float = C1,
    c2: float = C2,
    weights=MSSSIM_WEIGHTS,
) -> dict:
    """PSNR/SSIM/MS-SSIM straight from a (2, B, 3, h, w) linear-RGB pair
    buffer (the conversion kernel's output), each (B,) f32.

    The 8-bit quantization (clip(round(lin*255)), the reference's
    f32_to_8bit before NPP) happens at load inside the level-0 SSIM kernel;
    SSIM and MS-SSIM share that level.  ``window``: the (11,) f32 taps on
    ``p12``'s device.
    """
    h, w = p12.shape[-2], p12.shape[-1]
    flags = dict(want_psnr=want_psnr, want_ssim=want_ssim, want_msssim=want_msssim)
    lv, wts = _clamp_levels(h, w, levels, weights)
    sums = quality_sums(p12, window, **flags, num_levels=lv, c1=c1, c2=c2)
    return quality_from_sums(sums, h, w, **flags, weights=wts)


_QUALITY_KEYWORDS = {"window", "want_psnr", "want_ssim", "want_msssim", "levels", "c1", "c2", "weights"}


def quality_width_sharded(fn, mesh, *, in_ndims):
    """``quality_from_rgb`` with one frame's columns split over ``mesh``
    (parallel/mesh.py module docstring; ``shard_over_width`` calls this).
    ``fn``: ``quality_from_rgb`` through functools.partial, ``window`` and
    any other of its options as keywords; its input, the (2, B, 3, h, w)
    pair buffer, ``in_ndims`` (5,).  Each call plans the strips
    (``spatial_sharding`` of the frame's clamped MS-SSIM level count L:
    owned edges on multiples of 2^(L-1), a halo of 5 * 2^(L-1); one level
    without MS-SSIM, no halo for PSNR alone), and each strip, under its
    device and its stream (``launch_shards``), cuts its columns of the
    buffer (``strip_input``) and takes ``quality_sums`` over its owned
    columns; the strips' sums add in f64 on ``mesh.devices[0]`` and are
    scored there by ``quality_from_sums`` with the whole frame's level
    sizes and weights.  PSNR is the unsharded call's bit for bit; SSIM and
    MS-SSIM differ by the rounding of the strips' f32 sums.  A mesh of one
    runs ``fn`` unchanged on its device."""
    base, kw = partial_keywords(fn)
    if base is not quality_from_rgb:
        raise TypeError(f"quality_width_sharded takes ops.quality.quality_from_rgb, not {fn!r}")
    if tuple(in_ndims) != (5,):
        raise ValueError(f"{fn!r} takes one input of 5 dims, got in_ndims={tuple(in_ndims)}")
    if "window" not in kw:
        raise TypeError("width sharding of quality_from_rgb needs its window as a keyword "
                        "(functools.partial(quality_from_rgb, window=...))")
    unknown = set(kw) - _QUALITY_KEYWORDS
    if unknown:
        raise TypeError(f"quality_from_rgb takes no keywords {sorted(unknown)}")
    flags = {k: bool(kw.get(k, False)) for k in ("want_psnr", "want_ssim", "want_msssim")}
    consts = dict(c1=kw.get("c1", C1), c2=kw.get("c2", C2))
    dest = mesh.devices[0]

    def sharded(*args):
        check_inputs(args, in_ndims)
        (p12,) = args
        if mesh.size == 1:
            return fn(upload(p12, dest))
        h, w = p12.shape[-2], p12.shape[-1]
        lv, wts = _clamp_levels(h, w, kw.get("levels", 5), kw.get("weights", MSSSIM_WEIGHTS))
        windowed = flags["want_ssim"] or flags["want_msssim"]
        plan = spatial_sharding(mesh, w, num_scales=lv if flags["want_msssim"] else 1,
                                halo=None if windowed else 0)

        def strip_sums(k, dev):
            part = strip_input(p12, plan[k], dev)
            return quality_sums(part, kw["window"].to(dev), **flags, num_levels=lv, **consts,
                                columns=plan[k].columns)

        total = add_strips(launch_shards(strip_sums, mesh), dest)
        if "levels" in total:
            total["levels"] = [s.to(torch.float32) for s in total["levels"]]
        return quality_from_sums(total, h, w, **flags, weights=wts)

    return sharded


def plain_width_sharded(fn, mesh, *, in_ndims):
    """``ssim``, ``msssim`` or ``ssim_msssim`` with one frame's columns split
    over ``mesh`` (``shard_over_width`` calls this): ``quality_width_sharded``'s
    plan on code values.  ``fn``: one of them, bare or through
    functools.partial with its keywords (``backend``; ``levels`` but for
    ``ssim``); its inputs (B, 3, h, w) ``a`` and ``b``, ``in_ndims`` (4, 4).
    Each call plans the strips (``spatial_sharding`` of the frame's clamped
    MS-SSIM level count L, 1 for ``ssim``: owned edges on multiples of 2^(L-1),
    a halo of 5 * 2^(L-1)), and each strip, under its device and its stream
    (``launch_shards``), stacks its columns of a and b into one pair and
    takes ``level_sums`` over its owned columns (#11 and #12, or with
    backend "jnp" their plain twins); the strips' per-level sums add in f64
    on ``mesh.devices[0]``, round once to f32 and are scored there with the
    whole frame's level sizes and weights.  ``ValueError`` for a frame off
    JAX's kernel gate (three channels, both dims at least 11) and where a
    strip would own fewer than A columns.  A mesh of one runs ``fn``
    unchanged on its device."""
    base, kw = partial_keywords(fn)
    entries = {ssim: {"backend"}, msssim: {"backend", "levels"}, ssim_msssim: {"backend", "levels"}}
    if base not in entries:
        raise TypeError(f"plain_width_sharded takes ops.quality.ssim, msssim or ssim_msssim, not {fn!r}")
    if tuple(in_ndims) != (4, 4):
        raise ValueError(f"{fn!r} takes inputs of (4, 4) dims, got in_ndims={tuple(in_ndims)}")
    unknown = set(kw) - entries[base]
    if unknown:
        raise TypeError(f"{base.__name__} takes no keywords {sorted(unknown)}")
    dest = mesh.devices[0]
    plain = resolve_backend(kw.get("backend", "auto"), dest) == "jnp"

    def sharded(*args):
        check_inputs(args, in_ndims)
        if mesh.size == 1:
            return fn(*(upload(t, dest) for t in args))
        a, b = args
        h, w = a.shape[-2], a.shape[-1]
        if a.shape[-3] != 3 or min(h, w) < 2 * RADIUS + 1 or b.shape != a.shape:
            raise ValueError(f"width sharding of {base.__name__} takes two (B, 3, h, w) inputs with h and w at "
                             f"least {2 * RADIUS + 1}, got {tuple(a.shape)} and {tuple(b.shape)}")
        lv, wts = _clamp_levels(h, w, 1 if base is ssim else kw.get("levels", 5))
        plan = spatial_sharding(mesh, w, num_scales=lv)

        def strip_sums(k, dev):
            s = plan[k]
            p12 = torch.stack([strip_input(t, s, dev, view=True) for t in (a, b)]).to(torch.float32)
            return level_sums(p12, _window(dev), lv, quantize=False, columns=s.columns, plain=plain)

        total = add_strips(launch_shards(strip_sums, mesh), dest)
        per_level = [means_from_sums(t.to(torch.float32), h >> li, w >> li) for li, t in enumerate(total)]
        if base is ssim:
            return per_level[0][0]
        if base is msssim:
            return _msssim_combine(per_level, wts)
        return per_level[0][0], _msssim_combine(per_level, wts)

    return sharded


class Quality(nn.Module):
    """PSNR/SSIM/MS-SSIM on an explicit device.

    Buffer ``window`` holds the SSIM window taps as f32 on the device, where
    the kernels read them; ``c1``, ``c2`` (floats) and ``msssim_weights``
    (f64) stay on the host.  ``constants_from_numpy`` installs replacements.
    """

    def __init__(self, *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.register_buffer("window", torch.empty(11, dtype=torch.float32, device=dev))
        self.constants_from_numpy(builtin_constants())

    def constants_from_numpy(self, d: dict) -> None:
        """Install constants given as numpy arrays (``builtin_constants``
        keys), e.g. the JAX package's, into the module."""
        win = np.asarray(d["ssim_window"], dtype=np.float64).astype(np.float32)
        with torch.no_grad():
            self.window.copy_(torch.from_numpy(win))
        self.c1 = float(np.float32(d["c1"]))
        self.c2 = float(np.float32(d["c2"]))
        self.msssim_weights = np.asarray(d["msssim_weights"], dtype=np.float64).copy()

    @torch.no_grad()
    def from_rgb(self, p12: torch.Tensor, *, psnr=False, ssim=False, msssim=False) -> dict:
        return quality_from_rgb(
            p12, self.window, want_psnr=psnr, want_ssim=ssim, want_msssim=msssim,
            c1=self.c1, c2=self.c2, weights=self.msssim_weights,
        )
