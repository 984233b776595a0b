"""The port's level chain and its kernels vs the JAX package, on the CPU.

``level_route`` against the route the JAX package's own loop takes
(``ssimulacra2_subscores_from_padded``, traced with its kernels replaced by
recorders, at no cost: ``jax.eval_shape``); the twins of kernels #7, #8,
#10 (and #9, whose function #10's entry computes) against the Pallas
kernels they replace in interpret mode (#4's, through the JAX pallas3
route, in tests/test_torch_backends.py, which compiles that route once);
``blur_2d_iir`` against the JAX recursion.  On the CPU each wrapper runs its twin; the kernels themselves
are held against the twins on the card by chip_smoke.py.  Sub-scores of
independent images are compared at the JAX kernel tests' rtol 2e-5 / atol
2e-6; close pairs, whose deep-scale SSIM quotient is ill-conditioned in f32
(ROADMAP Queue 3), at score level within 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from turbo_metrics_tpu.models import ssimulacra2 as jax_s2
from turbo_metrics_tpu.ops import gaussian as jax_gaussian
from turbo_metrics_tpu.ops.pallas import scale_stats as jax_ss
from turbo_metrics_tpu.ops.pallas import scale_tail as jax_tail
from turbo_metrics_tpu.ops.pallas.convert import downscale_by_2_pallas
from turbo_metrics_tpu.ops.pallas.scale_stats_legacy import (
    fused_scale_pallas,
    fused_scale_pallas_v3,
    scale_sums_pallas,
)
from turbo_metrics_tpu.ops.xyb import linear_rgb_to_xyb as jax_xyb

from turbo_metrics_tpu_torch.models import ssimulacra2 as s2
from turbo_metrics_tpu_torch.ops.downscale import scale_dims
from turbo_metrics_tpu_torch.ops.gaussian import blur_2d_iir
from turbo_metrics_tpu_torch.ops.kernels import downscale, fused_tail, scale_stats

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6


def _consts():
    m = s2.Ssimulacra2(64, 48, device="cpu")
    return m.taps, m.opsin


def _jax_route(monkeypatch, h0, w0, num_scales, first_level):
    """The kernels the JAX package's level loop runs, as (kernel, levels)
    named like the port's wrappers: ``ssimulacra2_subscores_from_padded``
    traced abstractly on the padded buffer it gets at ``first_level`` (the
    layout of ``pad_to_layout4`` at level 0, the emitted ``ds_buffer_hw`` at
    level 1), its three kernels replaced by recorders."""
    calls = []

    def v4(p12, h, w, *, emit_ds, **_):
        calls.append(("fused_scale_rgb", h, w, 1))
        ds = jnp.zeros((2, p12.shape[1], 3) + jax_ss.ds_buffer_hw(h, w)) if emit_ds else None
        return jnp.zeros((p12.shape[1], 3, 6)), ds

    def tail(p12, dims, **_):
        calls.append(("fused_tail", *dims[0], len(dims)))
        return jnp.zeros((p12.shape[1], len(dims), 3, 6))

    def tail2(p12, h, w, **_):
        calls.append(("fused_pyramid_tail", h, w, 5))
        return jnp.zeros((p12.shape[1], 5, 3, 8))

    monkeypatch.setattr(jax_ss, "fused_scale_pallas_v4", v4)
    monkeypatch.setattr(jax_ss, "fused_tail_pallas", tail)
    monkeypatch.setattr(jax_tail, "fused_pyramid_tail_pallas", tail2)
    h, w = h0, w0
    if first_level == 0:
        hp, wp = jax_ss.pad_geom4(h, w)[4:]
    else:
        hp, wp = jax_ss.ds_buffer_hw(h, w)
        h, w = (h + 1) // 2, (w + 1) // 2
    buf = jax.ShapeDtypeStruct((2, 1, 3, hp, wp), jnp.float32)
    n = num_scales - first_level
    jax.eval_shape(lambda p: jax_s2.ssimulacra2_subscores_from_padded(p, h, w, num_scales=n), buf)
    route, s = [], first_level
    for kernel, *_, count in calls:
        route.append((kernel, tuple(range(s, s + count))))
        s += count
    return route


@pytest.mark.parametrize("first_level", [0, 1])
@pytest.mark.parametrize(
    "hw", [(2160, 3840), (1440, 2560), (1080, 1920), (720, 1280), (4320, 7680), (120, 160),
           (64, 48), (48, 64)],
)
def test_level_route_matches_jax(monkeypatch, hw, first_level):
    """The port's copied rule picks, level by level, the kernel the JAX loop
    picks (kernel 2, #4, or #3 with the next level emitted)."""
    h, w = hw
    ns = len(scale_dims(h, w))
    want = _jax_route(monkeypatch, h, w, ns, first_level)
    if first_level:
        h, w = (h + 1) // 2, (w + 1) // 2
    got = s2.level_route(h, w, ns, first_level)
    assert got == want
    assert sum(len(levels) for _, levels in got) == ns - first_level


def test_level_route_at_4k():
    """3840x2160 after kernel 1: #3 on levels 1 and 2, then #4 on 3-5."""
    assert s2.level_route(1080, 1920, 6, 1) == [
        ("fused_scale_rgb", (1,)), ("fused_scale_rgb", (2,)), ("fused_tail", (3, 4, 5)),
    ]


def _pair(rng, h, w):
    """Two independent seeded (2, 3, h, w) linear-RGB images."""
    return tuple(rng.random((2, 3, h, w), dtype=np.float64).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("hw", [(48, 64), (33, 61), (480, 640)])
def test_downscale_twin_matches_pallas(rng, hw):
    """Kernel #7's twin against downscale_by_2_pallas in interpret mode."""
    x = rng.random((1, 3, *hw), dtype=np.float64).astype(np.float32)
    want = np.asarray(downscale_by_2_pallas(jnp.asarray(x), interpret=True))
    got = downscale.downscale_by_2(torch.from_numpy(x))
    assert got.shape == (1, 3, (hw[0] + 1) // 2, (hw[1] + 1) // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-7)


def _norms(sums, h, w):
    return np.asarray(jax_ss.norms_from_sums(jnp.asarray(np.asarray(sums)), h * w))


@pytest.mark.parametrize("hw", [(32, 48), (40, 130), (24, 128), (34, 60)])
def test_scale_sums_twin_matches_pallas(rng, hw):
    """Kernel #8's twin against scale_sums_pallas in interpret mode, on the
    JAX package's XYB of independent images (the sizes of the JAX package's
    own test of that kernel)."""
    h, w = hw
    x1, x2 = (np.array(jax_xyb(jnp.asarray(rng.random((2, 3, h, w), dtype=np.float64)
                                           .astype(np.float32)))) for _ in range(2))
    want = scale_sums_pallas(jnp.asarray(x1), jnp.asarray(x2), interpret=True)
    taps, _ = _consts()
    got = scale_stats.scale_sums(torch.from_numpy(x1), torch.from_numpy(x2), taps)
    assert got.shape == (2, 3, 6)
    np.testing.assert_allclose(_norms(got, h, w), _norms(want, h, w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("version", ["v3", "v2"])
@pytest.mark.parametrize("hw", [(48, 64), (35, 61)])
def test_fused_scale_pair_twin_matches_pallas(rng, hw, version):
    """Kernel #10's twin against fused_scale_pallas_v3 in interpret mode (the
    configuration of the JAX pallas2 route), and against fused_scale_pallas
    (v2, kernel #9), which computes the same function: #10's entry covers
    both."""
    h, w = hw
    a, b = _pair(rng, h, w)
    if version == "v3":
        want = fused_scale_pallas_v3(
            jnp.asarray(a), jnp.asarray(b), tile_h=64, tile_w=1024, h_pass="mxu",
            double_buffer=True, interpret=True,
        )
    else:
        want = fused_scale_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)[0]
    taps, opsin = _consts()
    got = scale_stats.fused_scale_pair(torch.from_numpy(a), torch.from_numpy(b), taps, opsin)
    assert got.shape == (2, 3, 6)
    np.testing.assert_allclose(_norms(got, h, w), _norms(want, h, w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 5, 17, 23), (1, 3, 24, 9)])
def test_blur_2d_iir_matches_jax(rng, shape):
    """The recursive blur of the jnp_iir parity mode, in the JAX recursion's
    operation order, f32."""
    x = rng.random(shape, dtype=np.float64).astype(np.float32)
    want = np.asarray(jax.jit(jax_gaussian.blur_2d_iir)(jnp.asarray(x)))
    got = blur_2d_iir(torch.from_numpy(x))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_chain_runs_the_routed_kernels(rng, monkeypatch):
    """level_sums_chain calls the wrappers level_route names: on a 100x2800
    level 1 (its TPU plane above TAIL_MAX_BYTES, wider than kernel 2 takes)
    #3 with level 2 emitted, then #4 on levels 2-5; level 1's sums equal the
    twin's."""
    calls = []
    for name in ("fused_scale_rgb", "fused_tail", "fused_pyramid_tail"):
        fn = getattr(s2, name)

        def rec(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)

        monkeypatch.setattr(s2, name, rec)
    h, w, ns = 100, 2800, 6
    assert s2.level_route(h, w, ns, 1) == [("fused_scale_rgb", (1,)), ("fused_tail", (2, 3, 4, 5))]
    p12 = torch.from_numpy(rng.random((2, 1, 3, h, w), dtype=np.float64).astype(np.float32))
    taps, opsin = _consts()
    got = s2.level_sums_chain(p12, 1, taps, opsin, num_scales=ns)
    assert calls == [k for k, _ in s2.level_route(h, w, ns, 1)]
    want = scale_stats.fused_scale_rgb_ref(p12, taps, opsin)[0]
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-6, atol=0)
    assert len(got) == ns - 1


def test_new_wrappers_count_no_launch_on_cpu(rng):
    """On CPU tensors the new wrappers run their twins and count nothing;
    shapes, types and devices are checked first."""
    counted = (fused_tail.fused_tail, downscale.downscale_by_2, scale_stats.scale_sums,
               scale_stats.fused_scale_pair)
    for fn in counted:
        fn.launches = 0
    taps, opsin = _consts()
    a, b = (torch.from_numpy(x) for x in _pair(rng, 24, 32))
    fused_tail.fused_tail(torch.stack([a, b]), 3, taps, opsin)
    downscale.downscale_by_2(a)
    scale_stats.scale_sums(a, b, taps)
    scale_stats.fused_scale_pair(a, b, taps, opsin)
    assert [fn.launches for fn in counted] == [0] * len(counted)
    with pytest.raises(ValueError):
        fused_tail.fused_tail(torch.stack([a, b]), 7, taps, opsin)
    with pytest.raises(ValueError):
        fused_tail.fused_tail(torch.stack([a, b]).double(), 2, taps, opsin)
    with pytest.raises(ValueError):
        downscale.downscale_by_2(a[0])
    with pytest.raises(ValueError):
        downscale.downscale_by_2(a.to("meta"))
    with pytest.raises(ValueError):
        scale_stats.scale_sums(a, b[:, :, :-1].contiguous(), taps)
    with pytest.raises(ValueError):
        scale_stats.fused_scale_pair(a, b.transpose(-1, -2), taps, opsin)


@pytest.mark.parametrize("levels", [1, 3, 6])
@pytest.mark.parametrize("hw", [(270, 480), (360, 640), (67, 99), (23, 29)])
def test_fused_tail_scratch_has_no_row_planes(hw, levels):
    """Kernel #4's one scratch allocation: the XYB pair of the even levels,
    the next level's size for the odd ones and for two linear-RGB planes,
    and six f32 partials per 32x8 tile of every level, each part whole
    16-byte chunks; the four row-blurred planes the two-pass design kept
    (4 * B * 3 * h * w floats, 25 MB at the 4K level 3) are gone.  Sizing
    it needs no library."""
    h, w = hw
    bsz = 4
    sizes = fused_tail.scratch_floats(bsz, h, w, levels)
    assert list(sizes) == ["xyb_even", "xyb_odd", "lvl_a", "lvl_b", "parts"]
    n = 2 * bsz * 3 * h * w
    n_next = 2 * bsz * 3 * -(-h // 2) * -(-w // 2) if levels > 1 else 0
    parts, lh, lw = 0, h, w
    for _ in range(levels):
        parts += bsz * 3 * -(-lw // 32) * -(-lh // 8) * 6
        lh, lw = -(-lh // 2), -(-lw // 2)
    up = lambda v: -(-v // 4) * 4  # noqa: E731
    assert sizes == {"xyb_even": up(n), "xyb_odd": up(n_next), "lvl_a": up(n_next),
                     "lvl_b": up(n_next), "parts": up(parts)}
    if (hw, levels) == ((270, 480), 3):
        assert sum(sizes.values()) == 5492304

