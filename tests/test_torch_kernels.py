"""The port's kernel modules (ops/kernels) vs the JAX package.

On the CPU each kernel wrapper runs its plain twin (a CUDA kernel has no
interpret mode; the kernels themselves are compared with the twins on the
card by chip_smoke.py).  The SSIMULACRA2 reference is the JAX chain
``colorspace.yuv420_to_linear_rgb`` -> ``ssimulacra2_subscores(backend=
"jnp")``, which blurs five quantities where the port blurs four, at the JAX
package's kernel-vs-jnp tolerance rtol 2e-5 / atol 2e-6
(tests/test_pallas_kernels.py).  The conversion and SSIM twins are held
against the Pallas kernels they replace in interpret mode (over the padded
layout's interior), the MS-SSIM tail against the jnp levels.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from turbo_metrics_tpu.models.ssimulacra2 import ssimulacra2_subscores as jax_subscores
from turbo_metrics_tpu.ops import colorspace as j_cs
from turbo_metrics_tpu.ops import quality as jq
from turbo_metrics_tpu.ops.downscale import downscale_by_2 as jax_downscale
from turbo_metrics_tpu.ops.gaussian import gaussian_window as j_window
from turbo_metrics_tpu.ops.pallas.convert import yuv420_pair_to_linear_rgb_padded
from turbo_metrics_tpu.ops.pallas.scale_stats import COL_HALO4, ROW_HALO4, pad_to_layout4
from turbo_metrics_tpu.ops.pallas.windowed import ssim_sums_pallas

from turbo_metrics_tpu_torch.models.ssimulacra2 import (
    Ssimulacra2,
    subscores_from_sums,
    ssimulacra2_subscores_from_rgb,
    ssimulacra2_subscores_from_yuv,
)
from turbo_metrics_tpu_torch.ops import quality as tq
from turbo_metrics_tpu_torch.ops.downscale import scale_dims
from turbo_metrics_tpu_torch.ops.kernels import (
    _build,
    adm,
    convert,
    motion,
    scale_stats,
    scale_tail,
    vif,
    windowed,
    windowed_tail,
)

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
SHAPES = [(48, 64), (67, 99)]  # even; odd (edge-replicated downscales)


def _yuv_pair(rng, bsz, h, w, depth=8):
    """Seeded (y2, uv2) numpy planes: independent, uniformly random
    legal-range reference and distorted images.

    Where the two images are close, the SSIM quotient of the deep scales is
    ill-conditioned in f32: there every f32 implementation, the JAX jnp path
    included, is ~1e-3 relative from the f64 value, and two of them differ
    by as much.  Independent images keep it well conditioned, so that these
    tests see the port's own error; close pairs are held to the score
    tolerance in tests/test_torch_slice.py."""
    s = 1 << (depth - 8)
    dt = np.uint8 if depth == 8 else np.uint16
    ch, cw = (h + 1) // 2, (w + 1) // 2
    y2 = rng.integers(16 * s, 235 * s + 1, (2, bsz, h, w))
    uv2 = rng.integers(16 * s, 240 * s + 1, (2, bsz, ch, cw, 2))
    return y2.astype(dt), uv2.astype(dt)


def _jax_lin(y2, uv2, depth=8):
    return np.asarray(j_cs.yuv420_to_linear_rgb(jnp.asarray(y2), jnp.asarray(uv2), depth=depth))


def _consts():
    m = Ssimulacra2(64, 48, device="cpu")
    return m.taps, m.opsin


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", SHAPES)
def test_scale0_twin_matches_jax(rng, hw):
    """Kernel 1's twin: scale-0 sub-scores and the emitted level 1."""
    h, w = hw
    y2, uv2 = _yuv_pair(rng, 2, h, w)
    lin = _jax_lin(y2, uv2)
    want = np.asarray(jax_subscores(lin[0], lin[1], num_scales=1, backend="jnp"))
    taps, opsin = _consts()
    sums, level1 = scale_stats.fused_scale0_yuv(
        torch.from_numpy(y2), torch.from_numpy(uv2), taps, opsin
    )
    assert sums.shape == (2, 3, 6) and sums.dtype == torch.float32
    _close(subscores_from_sums([sums], [(h, w)]), want)
    assert level1.shape == (2, 2, 3, (h + 1) // 2, (w + 1) // 2)
    _close(level1, jax_downscale(jnp.asarray(lin)))


@pytest.mark.parametrize("hw", SHAPES)
def test_tail_twin_matches_jax(rng, hw):
    """Kernel 2's twin on linear RGB: every level of the pyramid."""
    h, w = hw
    y2, uv2 = _yuv_pair(rng, 2, h, w)
    lin = _jax_lin(y2, uv2)
    dims = scale_dims(h, w)
    want = np.asarray(jax_subscores(lin[0], lin[1], num_scales=len(dims), backend="jnp"))
    taps, opsin = _consts()
    sums = scale_tail.fused_pyramid_tail(torch.from_numpy(lin.copy()), len(dims), taps, opsin)
    assert sums.shape == (2, len(dims), 3, 6)
    _close(subscores_from_sums(list(sums.unbind(1)), dims), want)


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("hw", SHAPES)
def test_kernel_path_matches_jax(rng, hw, depth):
    """Kernels 1 + 2 as the main path chains them, 8- and 10-bit."""
    h, w = hw
    y2, uv2 = _yuv_pair(rng, 2, h, w, depth=depth)
    lin = _jax_lin(y2, uv2, depth=depth)
    ns = len(scale_dims(h, w))
    want = np.asarray(jax_subscores(lin[0], lin[1], num_scales=ns, backend="jnp"))
    taps, opsin = _consts()
    got = ssimulacra2_subscores_from_yuv(
        torch.from_numpy(y2), torch.from_numpy(uv2), taps, opsin,
        num_scales=ns, depth=depth,
    )
    assert got.shape == (2, 3, ns, 2, 3)
    _close(got, want)


@pytest.mark.parametrize("hw", SHAPES)
def test_scale_rgb_twin_matches_jax(rng, hw):
    """Kernel #3's twin: one level from linear RGB, the emitted level 1; and
    the from-RGB route (#3 then kernel 2) over the whole pyramid."""
    h, w = hw
    y2, uv2 = _yuv_pair(rng, 2, h, w)
    lin = _jax_lin(y2, uv2)
    taps, opsin = _consts()
    p12 = torch.from_numpy(lin.copy())
    sums, level1 = scale_stats.fused_scale_rgb(p12, taps, opsin)
    assert sums.shape == (2, 3, 6) and level1.shape == (2, 2, 3, (h + 1) // 2, (w + 1) // 2)
    want0 = np.asarray(jax_subscores(lin[0], lin[1], num_scales=1, backend="jnp"))
    _close(subscores_from_sums([sums], [(h, w)]), want0)
    _close(level1, jax_downscale(jnp.asarray(lin)))
    ns = len(scale_dims(h, w))
    want = np.asarray(jax_subscores(lin[0], lin[1], num_scales=ns, backend="jnp"))
    _close(ssimulacra2_subscores_from_rgb(p12, taps, opsin, num_scales=ns), want)


@pytest.mark.parametrize(
    "depth,matrix,transfer", [(8, "bt709", "bt709"), (10, "bt2020", "pq")]
)
def test_convert_twin_matches_pallas(rng, depth, matrix, transfer):
    """Kernel #6's twin against the padded pair conversion it replaces, in
    interpret mode, over the padded layout's interior; converting each image
    into its slot gives the same buffer as the pair call."""
    h, w = 64, 256
    y2, uv2 = _yuv_pair(rng, 1, h, w, depth=depth)
    kw = dict(depth=depth, matrix=matrix, transfer=transfer)
    want = np.asarray(
        yuv420_pair_to_linear_rgb_padded(jnp.asarray(y2), jnp.asarray(uv2), None, interpret=True, **kw)
    )[..., ROW_HALO4 : ROW_HALO4 + h, COL_HALO4 : COL_HALO4 + w]
    got = convert.yuv420_to_linear_rgb_pair(torch.from_numpy(y2), torch.from_numpy(uv2), **kw)
    assert got.shape == (2, 1, 3, h, w) and got.dtype == torch.float32
    # PQ: the JAX package's own PQ conversion tolerance (atol 1e-4,
    # tests/test_pallas_kernels.py:107; see tests/test_torch_ops.py).
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4 if transfer == "pq" else ATOL)
    slots = torch.zeros_like(got)
    for slot in (0, 1):
        convert.yuv420_to_linear_rgb_pair(
            torch.from_numpy(y2[slot]), torch.from_numpy(uv2[slot]), slots, slot, **kw
        )
    assert torch.equal(slots, got)


def _ssim_window():
    return torch.from_numpy(j_window(11, 1.5).astype(np.float32))


def test_ssim_sums_twin_matches_pallas(rng):
    """Kernel #11's twin against ssim_sums_pallas in interpret mode, level 0
    of the multi-metric path (linear RGB in, quantized at load, level 1
    emitted), at the size tests/test_quality_oracle.py uses: sums within
    rtol 1e-5, the emitted level exactly equal over the interior."""
    h, w = 96, 160
    lin = rng.uniform(0.0, 1.0, (2, 1, 3, h, w)).astype(np.float32)
    lin[1] = np.clip(lin[0] + rng.normal(0, 0.03, lin[1].shape), 0, 1)
    sums_j, ds_j = ssim_sums_pallas(
        pad_to_layout4(jnp.asarray(lin), h, w), h, w, quantize=True, emit_ds=True, interpret=True
    )
    sums, ds = windowed.ssim_sums(torch.from_numpy(lin), _ssim_window(), quantize=True, emit_ds=True)
    assert sums.shape == (1, 3, 2) and ds.shape == (2, 1, 3, h // 2, w // 2)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(
        ds.numpy(),
        np.asarray(ds_j)[..., ROW_HALO4 : ROW_HALO4 + h // 2, COL_HALO4 : COL_HALO4 + w // 2],
    )


def test_msssim_tail_twin_matches_jax(rng):
    """Kernel #12's twin: levels 1-4 from the emitted level 1 against the
    JAX jnp per-level means (the JAX package's own interpret test of the
    Pallas tail is in its slow tier), within 1e-5 relative."""
    h, w = 192, 256
    lin = rng.uniform(0.0, 1.0, (2, 2, 3, h, w)).astype(np.float32)
    lin[1] = np.clip(lin[0] + rng.normal(0, 0.05, lin[1].shape), 0, 1)
    q = np.asarray(j_cs.f32_to_uint8(lin)).astype(np.float32)
    levels, _ = jax.jit(lambda a, b: jq._msssim_levels(a, b, 5, "jnp"))(q[0], q[1])
    win = _ssim_window()
    _, level1 = windowed.ssim_sums(torch.from_numpy(lin), win, quantize=True, emit_ds=True)
    tail = windowed_tail.msssim_tail(level1, 4, win)
    assert tail.shape == (2, 4, 3, 2)
    lh, lw = h // 2, w // 2
    for li in range(4):
        got = tq.means_from_sums(tail[:, li], lh, lw)
        for g, want in zip(got, levels[li + 1]):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5, atol=0)
        lh, lw = lh // 2, lw // 2


def test_build_key_covers_every_csrc_file(tmp_path):
    """The library's build key changes when any file under csrc/ changes,
    headers included, and when a file is added (no nvcc needed)."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    files = sorted(p for p in csrc.iterdir() if p.is_file())
    assert {p.name for p in files} >= set(_build.SOURCES) | {"colorspace.cuh", "level.cuh"}
    assert _build.source_key(csrc) == _build.source_key(_build.CSRC)
    seen = {_build.source_key(csrc)}
    for p in files:
        data = p.read_bytes()
        p.write_bytes(data + b" ")
        seen.add(_build.source_key(csrc))
        p.write_bytes(data)
        assert _build.source_key(csrc) == _build.source_key(_build.CSRC)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    seen.add(_build.source_key(csrc))
    assert len(seen) == len(files) + 2


def _c_entry_params(name: str) -> list[str]:
    """The parameter declarations of the C entry point ``name`` in csrc/."""
    import re

    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        m = re.search(r"^int " + name + r"\(([^)]*)\)\s*\{", text, re.M)
        if m:
            return [p.strip() for p in m.group(1).split(",") if p.strip() not in ("", "void")]
    raise AssertionError(f"{name} is defined in no source of csrc/")


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_entry_point_bindings_match_the_sources(name):
    """Each ctypes binding of _build has the C entry point's parameters, one
    for one: a pointer for a pointer (device or host), a float for a float,
    an int for an int (no nvcc needed; a mismatch passes a wrong argument
    silently on the card)."""
    import ctypes

    params = _c_entry_params(name)
    argtypes = _build._SIGNATURES[name]
    assert len(params) == len(argtypes), (params, argtypes)
    for decl, kind in zip(params, argtypes):
        if "*" in decl:
            assert kind in (ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)), decl
            if kind is not ctypes.c_void_p:
                assert decl.startswith(("float", "const float") if kind._type_ is ctypes.c_float
                                       else ("int", "const int")), decl
        else:
            assert kind is (ctypes.c_float if decl.startswith("float") else ctypes.c_int), decl


@pytest.mark.parametrize("hw", [(1, 1), (33, 65), (67, 99), (1080, 1920)])
def test_level_scratch_holds_xyb_and_partials_only(hw):
    """The SSIMULACRA2 level pass keeps its four row-blurred planes in shared
    memory: a level's device scratch is the XYB pair and six f32 partials per
    32x8 tile of each (batch, channel) plane, ceil(w/32) * ceil(h/8) tiles
    (the library's tm_level_blocks; chip_smoke.py holds the two equal), and
    sizing it needs no library.  Sizes cross the 32x32 tile's edges."""
    h, w = hw
    bsz = 2
    nblk = math.ceil(w / 32) * math.ceil(h / 8)
    assert scale_stats.level_blocks(h, w) == nblk
    scratch = scale_stats.s2_level_scratch(bsz, h, w, "meta")
    assert [t.numel() for t in scratch] == [2 * bsz * 3 * h * w, bsz * 3 * nblk * 6]
    assert all(t.dtype == torch.float32 for t in scratch)
    assert scale_stats.level_parts(bsz, h, w, "meta").numel() == bsz * 3 * nblk * 6


@pytest.mark.parametrize("hw", [(11, 11), (42, 43), (67, 99), (1080, 1920)])
def test_ssim_level_scratch_holds_partials_only(hw):
    """The SSIM tile kernel keeps its four row-correlated planes in shared
    memory and emits the next level from its input tile: a level's device
    scratch is two f32 partials per 32x8 tile of the (h-10) x (w-10) valid
    grid of each (batch, channel) plane, ceil((w-10)/32) * ceil((h-10)/8)
    tiles (the library's tm_ssim_blocks; chip_smoke.py holds the two equal),
    and sizing it needs no library.  Sizes cross the 32x32 tile's edges;
    11x11 has one valid pixel."""
    h, w = hw
    bsz = 2
    nblk = math.ceil((w - 10) / 32) * math.ceil((h - 10) / 8)
    assert windowed.ssim_blocks(h, w) == nblk
    parts = windowed.level_scratch(bsz, h, w, "meta")
    assert parts.numel() == bsz * 3 * nblk * 2
    assert parts.dtype == torch.float32


def test_launches_stay_zero_on_cpu(rng):
    """On CPU tensors the wrappers run their plain twins: no launch counted."""
    counted = (
        scale_stats.fused_scale0_yuv, scale_stats.fused_scale_rgb, scale_tail.fused_pyramid_tail,
        convert.yuv420_to_linear_rgb_pair, windowed.ssim_sums, windowed_tail.msssim_tail,
        convert.yuv_to_linear_rgb, motion.integer_blur, motion.motion_stats, vif.vif_scale0,
        vif.vif_tail, adm.adm_stats,
    )
    for fn in counted:
        fn.launches = 0
    y2, uv2 = _yuv_pair(rng, 1, 24, 32)
    taps, opsin = _consts()
    ssimulacra2_subscores_from_yuv(
        torch.from_numpy(y2), torch.from_numpy(uv2), taps, opsin, num_scales=3
    )
    convert.yuv_to_linear_rgb(torch.from_numpy(y2), torch.from_numpy(uv2))
    p12 = convert.yuv420_to_linear_rgb_pair(torch.from_numpy(y2), torch.from_numpy(uv2))
    ssimulacra2_subscores_from_rgb(p12, taps, opsin, num_scales=3)
    tq.quality_from_rgb(p12, _ssim_window(), want_psnr=True, want_ssim=True, want_msssim=True)
    y = torch.from_numpy(y2[0])
    motion.motion_stats(y, motion.integer_blur(y)[0])
    luma = torch.from_numpy(y2[:, :, :, :].astype(np.float32))
    vif.vif_scale_stats(luma)
    adm.adm_stats(luma)
    assert [fn.launches for fn in counted] == [0] * len(counted)


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "device", "layout"],
)
def test_wrappers_reject_bad_inputs(rng, bad):
    """Shape, type, device and contiguity are checked before any launch; a
    tensor on neither the CPU nor CUDA raises instead of falling back."""
    y2, uv2 = _yuv_pair(rng, 1, 16, 20)
    y2, uv2 = torch.from_numpy(y2), torch.from_numpy(uv2)
    taps, opsin = _consts()
    p12 = torch.zeros(2, 1, 3, 16, 20)
    if bad == "dtype":
        y2, uv2, p12 = y2.to(torch.uint16), uv2.to(torch.uint16), p12.double()
    elif bad == "shape":
        uv2, p12 = uv2[:, :, :-1].contiguous(), p12[:, :, :2].contiguous()
    elif bad == "device":
        y2, uv2, p12 = y2.to("meta"), uv2.to("meta"), p12.to("meta")
        taps, opsin = taps.to("meta"), opsin.to("meta")
    else:
        y2, p12 = y2.transpose(-1, -2), p12.transpose(-1, -2)
    win = _ssim_window().to(p12.device)
    # The VMAF kernels: (B, h, w) luma, (2, B, h, w) f32 pairs.
    luma = y2[0]
    pair = p12[:, :, 0].contiguous()
    prev0 = torch.zeros(tuple(luma.shape[1:]), dtype=torch.uint16, device=luma.device)
    if bad == "dtype":
        luma, prev0 = luma.to(torch.int16), prev0.to(torch.int32)
    elif bad == "shape":
        luma, prev0 = luma[:, :2].contiguous(), prev0[:, :-1].contiguous()
        pair = pair[:1].contiguous()
    elif bad == "layout":
        pair = pair.transpose(-1, -2)
    for fn, args in (
        (motion.integer_blur, (luma,)),
        (motion.motion_stats, (luma, prev0)),
        (vif.vif_scale0, (pair,)),
        (vif.vif_tail, (pair,)),
        (adm.adm_stats, (pair,)),
    ):
        with pytest.raises(ValueError):
            fn(*args)
    with pytest.raises(ValueError):
        scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin)
    with pytest.raises(ValueError):
        scale_tail.fused_pyramid_tail(p12, 2, taps, opsin)
    with pytest.raises(ValueError):
        scale_stats.fused_scale_rgb(p12, taps, opsin)
    with pytest.raises(ValueError):
        convert.yuv420_to_linear_rgb_pair(y2, uv2)
    with pytest.raises(ValueError):
        convert.yuv_to_linear_rgb(y2, uv2)
    with pytest.raises(ValueError):
        windowed.ssim_sums(p12, win)
    with pytest.raises(ValueError):
        windowed_tail.msssim_tail(p12, 1, win)
