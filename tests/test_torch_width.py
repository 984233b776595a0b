"""Width sharding in the port (parallel/mesh.py ``spatial_sharding``,
``split_columns``, ``shard_over_width``; the owned-column window of
models/ssimulacra2.py and the level wrappers) vs the JAX package's
``shard_over_width`` and the port's unsharded SSIMULACRA2, on the CPU.

On the CPU every level kernel runs its plain twin; the strips are entries
of ``make_mesh(n, device="cpu")``.  Against the JAX package (its
tests/test_parallel.py::test_width_sharded_scores_match: (1, 3, 64, 512),
three scales, four strips) the sub-scores are held to the bar that
tests/test_torch_backends.py holds the unsharded port's ``jnp`` route to
against the JAX ``jnp`` route (rtol 2e-5, atol 2e-6) and the scores to
tests/test_torch_slice.py's 1e-3.  Against the port's unsharded sub-scores
the bar is the JAX test's own, atol/rtol 2e-5; the strips' maps of every
owned pixel equal the frame's bit for bit, on every level.  The JAX
reference is computed once, in a module fixture.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from turbo_metrics_tpu.models.ssimulacra2 import ssimulacra2_subscores as jax_subscores
from turbo_metrics_tpu.parallel import mesh as jax_mesh

from turbo_metrics_tpu_torch.models import ssimulacra2 as s2
from turbo_metrics_tpu_torch.models.ssimulacra2_score import postprocess_score
from turbo_metrics_tpu_torch.ops import colorspace
from turbo_metrics_tpu_torch.ops.downscale import downscale_by_2, scale_dims
from turbo_metrics_tpu_torch.ops.gaussian import blur_2d
from turbo_metrics_tpu_torch.ops.kernels import fused_tail, scale_stats, scale_tail
from turbo_metrics_tpu_torch.ops.ssim_maps import edge_maps, plain_maps, ssim_map
from turbo_metrics_tpu_torch.ops.xyb import linear_rgb_to_xyb, opsin_vector
from turbo_metrics_tpu_torch.parallel import mesh

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

# tests/test_torch_backends.py AGAINST["jnp"]: the port's jnp sub-scores vs
# the JAX jnp route's; tests/test_torch_slice.py: scores within 1e-3.
JAX_RTOL, JAX_ATOL, JAX_SCORE_ATOL = 2e-5, 2e-6, 1e-3
# tests/test_parallel.py::test_width_sharded_scores_match: sharded vs single.
SHARD_TOL = 2e-5


def _rgb_pair(seed, b, h, w):
    """test_width_sharded_scores_match's pair: uniform linear RGB and a
    noisy copy, (B, 3, h, w) f32 each."""
    rng = np.random.default_rng(seed)
    ref = rng.random((b, 3, h, w), dtype=np.float64).astype(np.float32)
    dis = np.clip(ref + rng.normal(0, 0.05, ref.shape).astype(np.float32), 0, 1)
    return torch.from_numpy(ref), torch.from_numpy(dis)


def _yuv_pair(seed, b, h, w):
    """A smooth 8-bit 4:2:0 reference with seeded noise and a distorted copy
    within +-6: (2, B, h, w) luma, (2, B, ceil(h/2), ceil(w/2), 2) chroma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = np.mgrid[0:(h + 1) // 2, 0:(w + 1) // 2]
    y = 128 + 70 * np.sin(xx / 9.0) * np.cos(yy / 7.0) + rng.normal(0, 3, (b, h, w))
    uv = np.stack([128 + 40 * np.sin(cx / 5.0), 128 + 40 * np.cos(cy / 4.0)], -1) + rng.normal(
        0, 3, (b, *cx.shape, 2))
    y2 = np.stack([y, y + rng.integers(-6, 7, y.shape)])
    uv2 = np.stack([uv, uv + rng.integers(-6, 7, uv.shape)])
    return (torch.from_numpy(np.clip(np.round(y2), 0, 255).astype(np.uint8)),
            torch.from_numpy(np.clip(np.round(uv2), 0, 255).astype(np.uint8)))


def _consts():
    m = s2.Ssimulacra2(64, 48, device="cpu")
    return m.taps, m.opsin


def _strip_routes(plan, h, num_scales, entry):
    """The kernels the strips' level chains take (``level_route`` of each
    strip's own h x w), from level 0 (RGB entry, ``pallas3``) or level 1
    (YUV entry, after kernel 1)."""
    first = 0 if entry == "rgb" else 1
    return {k for s in plan
            for k, _ in s2.level_route(-(-h >> first), -(-s.width >> first), num_scales, first)}


@pytest.fixture(scope="module")
def jax_width_sharded():
    """The JAX package's width-sharded and single-device sub-scores of
    test_width_sharded_scores_match's pair, over four virtual devices."""
    ref, dis = (t.numpy() for t in _rgb_pair(1234, 1, 64, 512))
    fn = functools.partial(jax_subscores, num_scales=3, backend="jnp")
    sharded = jax_mesh.shard_over_width(fn, jax_mesh.make_mesh(4), in_ndims=(4, 4))(ref, dis)
    return np.asarray(sharded), np.asarray(jax.jit(fn)(ref, dis))


def test_shard_over_width_matches_jax(jax_width_sharded):
    """The port's shard_over_width against the JAX package's, four strips."""
    want, want_single = jax_width_sharded
    np.testing.assert_allclose(want, want_single, rtol=SHARD_TOL, atol=SHARD_TOL)
    ref, dis = _rgb_pair(1234, 1, 64, 512)
    fn = functools.partial(s2.ssimulacra2_subscores, num_scales=3, backend="jnp")
    got = mesh.shard_over_width(fn, mesh.make_mesh(4, device="cpu"), in_ndims=(4, 4))(ref, dis)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=JAX_RTOL, atol=JAX_ATOL)
    np.testing.assert_allclose(postprocess_score(got.numpy().astype(np.float64)),
                               postprocess_score(want.astype(np.float64)), rtol=0, atol=JAX_SCORE_ATOL)


# (entry, backend, B, h, w, scales, strips, the kernels the strips' chains
# take): kernel 2 (fused_pyramid_tail), #4 (fused_tail) and #3
# (fused_scale_rgb) as twins, the plain routes, odd widths, 2-4 strips.
SHARD_CASES = [
    ("rgb", "jnp", 1, 64, 512, 3, 4, None),
    ("rgb", "jnp", 2, 120, 1001, 6, 3, None),
    ("rgb", "pallas3", 2, 64, 515, 3, 3, {"fused_tail"}),
    ("rgb", "pallas3", 1, 120, 1001, 6, 2, {"fused_tail"}),
    ("rgb", "pallas3", 1, 400, 1001, 3, 2, {"fused_scale_rgb", "fused_tail"}),
    ("rgb", "pallas3", 1, 120, 512, 6, 4, {"fused_tail"}),
    ("rgb", "pallas", 1, 48, 515, 3, 3, None),
    ("rgb", "pallas2", 2, 120, 512, 6, 4, None),
    ("yuv", None, 1, 120, 1001, 6, 2, {"fused_pyramid_tail"}),
    ("yuv", None, 1, 336, 1001, 6, 4, {"fused_pyramid_tail"}),
    ("yuv", None, 2, 64, 515, 3, 2, {"fused_tail"}),
    ("yuv", None, 2, 120, 515, 6, 3, {"fused_pyramid_tail"}),
    ("yuv", None, 1, 48, 512, 3, 4, {"fused_tail"}),
]


@pytest.mark.parametrize("entry,backend,b,h,w,ns,n,routes", SHARD_CASES)
def test_sharded_matches_unsharded(entry, backend, b, h, w, ns, n, routes):
    """Width-sharded sub-scores against the port's unsharded ones."""
    taps, opsin = _consts()
    if entry == "rgb":
        args = _rgb_pair(w + n, b, h, w)
        fn = functools.partial(s2.ssimulacra2_subscores, num_scales=ns, backend=backend)
        in_ndims = (4, 4)
    else:
        args = _yuv_pair(w + n, b, h, w)
        fn = functools.partial(s2.ssimulacra2_subscores_from_yuv, num_scales=ns, taps=taps, opsin=opsin)
        in_ndims = (4, 5)
    plan = mesh.spatial_sharding(mesh.make_mesh(n, device="cpu"), w, num_scales=ns, chroma=entry == "yuv")
    if routes is not None:
        assert _strip_routes(plan, h, ns, entry) == routes
    want = fn(*args)
    got = mesh.shard_over_width(fn, mesh.make_mesh(n, device="cpu"), in_ndims=in_ndims)(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SHARD_TOL, atol=SHARD_TOL)


def _f64_pow(monkeypatch):
    """torch.pow of f32 tensors evaluated in f64 and rounded.  torch's CPU
    pow rounds its vectorised body and its scalar tail differently (by an
    ulp on ~1.5% of inputs), so an f32 pow depends on where a pixel falls in
    its tensor and not only on its inputs; in f64, rounded, it depends on
    its inputs alone (the card's kernels compute every pixel alike)."""
    f32_pow = torch.pow

    def pow_(x, e, *a, **k):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return f32_pow(x.double(), e, *a, **k).float()
        return f32_pow(x, e, *a, **k)

    monkeypatch.setattr(torch, "pow", pow_)


def _level_maps(lin, num_scales, taps, opsin):
    """Per level of a (2, B, 3, h, w) linear-RGB pair: (linear RGB, XYB, the
    kernels' maps d, art, det and the plain chain's five-blur SSIM map)."""
    out = []
    for s in range(num_scales):
        if s:
            lin = downscale_by_2(lin)
        xyb = linear_rgb_to_xyb(lin, opsin=opsin)
        x1, x2 = xyb[0], xyb[1]
        diff = x1 - x2
        mu1, mu2, sdd, s12 = blur_2d(torch.stack([x1, x2, diff * diff, x1 * x2]), taps=taps).unbind(0)
        b1, b2, s11, s22, b12 = blur_2d(torch.stack([x1, x2, x1 * x1, x2 * x2, x1 * x2]), taps=taps).unbind(0)
        maps = torch.stack([ssim_map(mu1, mu2, sdd, s12), *edge_maps(x1, x2, mu1, mu2),
                            plain_maps(x1, x2, b1, b2, s11, s22, b12)[0]])
        out.append((lin, xyb, maps))
    return out


def _owned_mismatches(frame, strip_levels, strip):
    """Per level, the count of owned pixels whose linear RGB, XYB or maps
    differ from the frame's (its columns lo >> l + c)."""
    bad = []
    win = strip.columns
    for lvl, (f, g) in enumerate(zip(frame, strip_levels)):
        base = strip.lo >> lvl
        n = 0
        for ft, gt in zip(f, g):
            n += int((ft[..., base + win[0]:base + win[1]] != gt[..., win[0]:win[1]]).sum())
        bad.append(n)
        win = scale_stats.next_window(*win)
    return bad


@pytest.mark.parametrize("entry,h,w,ns,n", [
    ("rgb", 40, 515, 3, 3), ("rgb", 33, 1001, 6, 4), ("yuv", 35, 1001, 6, 2), ("yuv", 24, 515, 3, 4),
])
def test_owned_pixels_bit_equal(monkeypatch, entry, h, w, ns, n):
    """Every owned pixel's linear RGB, XYB and maps equal the unsharded
    frame's bit for bit on every level (the halo is wide enough); a halo one
    alignment step narrower changes some."""
    _f64_pow(monkeypatch)
    taps, opsin = _consts()
    chroma = entry == "yuv"
    if chroma:
        y2, uv2 = _yuv_pair(w, 2, h, w)

        def lin_of(strip):
            return colorspace.yuv420_to_linear_rgb(mesh._cut(y2, strip, False), mesh._cut(uv2, strip, True))
    else:
        pair = torch.stack(_rgb_pair(w, 2, h, w))

        def lin_of(strip):
            return mesh._cut(pair, strip, False)
    whole = mesh.Strip(0, w, 0, w)
    frame = _level_maps(lin_of(whole), ns, taps, opsin)
    plan = mesh.spatial_sharding(mesh.make_mesh(n, device="cpu"), w, num_scales=ns, chroma=chroma)
    for strip in plan:
        assert _owned_mismatches(frame, _level_maps(lin_of(strip), ns, taps, opsin), strip) == [0] * ns
    # The right halo one alignment step narrower: 4 columns on the last
    # level, where the blur's last tap (1.4e-7) reaches 5.  (Its first tap
    # is 0 in f32: on the left 4 would do.)
    first = plan[0]
    narrow = mesh.Strip(first.lo, first.hi - mesh.strip_alignment(ns, chroma), first.own_lo, first.own_hi)
    assert sum(_owned_mismatches(frame, _level_maps(lin_of(narrow), ns, taps, opsin), narrow)) > 0


@pytest.mark.parametrize("w,ns,n,chroma", [
    (7680, 6, 4, False), (7680, 6, 2, True), (515, 3, 3, False), (1001, 6, 4, True), (64, 1, 3, True),
    (1001, 6, 2, False), (4096, 6, 8, False),
])
def test_spatial_sharding_plan(w, ns, n, chroma):
    """Owned edges on multiples of A, the last at w; the halo clipped at the
    frame's edges; the windows cover the frame once; widths as even as A
    allows."""
    plan = mesh.spatial_sharding(mesh.make_mesh(n, device="cpu"), w, num_scales=ns, chroma=chroma)
    a, halo = mesh.strip_alignment(ns, chroma), mesh.strip_halo(ns, chroma)
    assert a == max(2 if chroma else 1, 1 << (ns - 1)) and halo % a == 0 and halo >= 5 << (ns - 1)
    assert len(plan) == n
    owned = [(s.lo + s.own_lo, s.lo + s.own_hi) for s in plan]
    assert owned[0][0] == 0 and owned[-1][1] == w
    assert all(hi == lo for (_, hi), (lo, _) in zip(owned, owned[1:]))
    assert all(lo % a == 0 for lo, _ in owned) and all(hi % a == 0 for _, hi in owned[:-1])
    widths = [hi - lo for lo, hi in owned]
    assert max(widths[:-1] or [0]) - min(widths[:-1] or [0]) <= a and min(widths) >= a
    for s, (lo, hi) in zip(plan, owned):
        assert s.lo == max(0, lo - halo) and s.hi == min(w, hi + halo)
        assert s.lo % a == 0 and (s.hi == w or s.hi % a == 0)
        assert 0 <= s.own_lo < s.own_hi <= s.width
    want = (w + 2 * halo * (n - 1)) / w
    assert mesh.halo_overhead(plan) <= want + 1e-12
    if (w, ns, chroma) == (7680, 6, False):
        assert mesh.halo_overhead(plan) == pytest.approx(1.125, abs=1e-12)
    if (w, ns, n) == (7680, 6, 2):
        assert mesh.halo_overhead(plan) == pytest.approx(8000 / 7680, abs=1e-12)


@pytest.mark.parametrize("entry", ["rgb", "yuv"])
def test_split_columns_contiguous(entry):
    """Each strip's copy holds its cut of every plane, contiguous; 4:2:0
    chroma cut at [lo/2, ceil(hi/2))."""
    m = mesh.make_mesh(3, device="cpu")
    if entry == "rgb":
        t = _rgb_pair(5, 2, 16, 515)[0]
        plan = mesh.spatial_sharding(m, 515, num_scales=3)
        for s, part in zip(plan, mesh.split_columns(t, plan, m)):
            assert part.is_contiguous() and torch.equal(part, t[..., s.lo:s.hi])
        parts = mesh.split_columns(t.numpy(), plan, m)
        assert all(isinstance(p, torch.Tensor) and p.is_contiguous() for p in parts)
    else:
        y2, uv2 = _yuv_pair(5, 1, 16, 515)
        plan = mesh.spatial_sharding(m, 515, num_scales=3, chroma=True)
        for s, py, pc in zip(plan, mesh.split_columns(y2, plan, m), mesh.split_columns(uv2, plan, m, chroma=True)):
            assert py.is_contiguous() and pc.is_contiguous()
            assert torch.equal(pc, uv2[..., s.lo // 2:(s.hi + 1) // 2, :])
            assert pc.shape[-2] == -(-py.shape[-1] // 2)


@pytest.mark.parametrize("entry,backend", [("rgb", "jnp"), ("rgb", "pallas3"), ("yuv", None)])
def test_mesh_of_one_bit_equal(entry, backend):
    """A mesh of one entry gives the unsharded sub-scores bit for bit."""
    taps, opsin = _consts()
    if entry == "rgb":
        args = _rgb_pair(7, 2, 48, 99)
        fn = functools.partial(s2.ssimulacra2_subscores, num_scales=3, backend=backend)
        in_ndims = (4, 4)
    else:
        args = _yuv_pair(7, 2, 48, 99)
        fn = functools.partial(s2.ssimulacra2_subscores_from_yuv, num_scales=3, taps=taps, opsin=opsin)
        in_ndims = (4, 5)
    got = mesh.shard_over_width(fn, mesh.make_mesh(1, device="cpu"), in_ndims=in_ndims)(*args)
    assert torch.equal(got, fn(*args))


def test_width_sharding_errors():
    """TypeError for a function that is not a supported entry; ValueError
    for jnp_iir and for too narrow a width."""
    m = mesh.make_mesh(4, device="cpu")
    for fn in (lambda a, b: a, functools.partial(s2.ssimulacra2_level_sums, num_scales=3),
               functools.partial(s2.ssimulacra2_subscores, torch.zeros(1, 3, 8, 8), num_scales=3)):
        with pytest.raises(TypeError, match="partitioner|keywords only"):
            mesh.shard_over_width(fn, m, in_ndims=(4, 4))
    with pytest.raises(ValueError, match="jnp_iir"):
        mesh.shard_over_width(functools.partial(s2.ssimulacra2_subscores, num_scales=3, backend="jnp_iir"),
                              m, in_ndims=(4, 4))
    ref, dis = _rgb_pair(3, 1, 32, 64)
    with pytest.raises(ValueError, match="jnp_iir"):
        s2.ssimulacra2_level_sums(ref, dis, num_scales=3, backend="jnp_iir", columns=(0, 32))
    with pytest.raises(ValueError, match="at least 128"):
        mesh.spatial_sharding(m, 127, num_scales=6)
    fn = functools.partial(s2.ssimulacra2_subscores, num_scales=6, backend="jnp")
    with pytest.raises(ValueError, match="at least 128"):
        mesh.shard_over_width(fn, m, in_ndims=(4, 4))(*_rgb_pair(3, 1, 120, 120))
    with pytest.raises(ValueError, match="dims"):
        mesh.shard_over_width(fn, m, in_ndims=(4, 5))
    with pytest.raises(ValueError, match="columns"):
        scale_stats.fused_scale_rgb(torch.stack([ref, dis]), *_consts(), columns=(10, 65))


@pytest.mark.parametrize("entry,backend", [("rgb", "jnp"), ("rgb", "pallas3"), ("rgb", "pallas2"), ("yuv", None)])
def test_short_pyramid_matches_unsharded(entry, backend):
    """A frame whose pyramid ends before num_scales (16 rows: scale_dims
    stops after three of six levels) gives the unsharded sub-scores, shape
    included: the plain chain's every level, the kernel routes' scale_dims
    levels."""
    taps, opsin = _consts()
    if entry == "rgb":
        args = _rgb_pair(16, 1, 16, 512)
        fn = functools.partial(s2.ssimulacra2_subscores, num_scales=6, backend=backend)
        in_ndims = (4, 4)
    else:
        args = _yuv_pair(16, 1, 16, 512)
        fn = functools.partial(s2.ssimulacra2_subscores_from_yuv, num_scales=6, taps=taps, opsin=opsin)
        in_ndims = (4, 5)
    want = fn(*args)
    assert want.shape[2] == (6 if backend == "jnp" else 3)
    got = mesh.shard_over_width(fn, mesh.make_mesh(4, device="cpu"), in_ndims=in_ndims)(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SHARD_TOL, atol=SHARD_TOL)


@pytest.mark.parametrize("h,w,cut", [(67, 99, 40), (35, 131, 48), (40, 70, 24)])
def test_windowed_twins_add_up(h, w, cut):
    """Kernels 1, 2, #3 and #4 (twins), #8 and #10: the sums of two windows
    that meet mid-tile, on a multiple of 2^(levels-1) as strips do, add to
    the whole level's (rtol 1e-6), and a window
    of the whole width gives the unwindowed sums bit for bit."""
    taps, opsin = _consts()
    ref, dis = _rgb_pair(h + w, 2, h, w)
    p12 = torch.stack([ref, dis])
    y2, uv2 = _yuv_pair(h + w, 2, h, w)
    xyb = linear_rgb_to_xyb(p12, opsin=opsin)
    calls = {
        "kernel 1": lambda c: scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin, columns=c)[0],
        "#3": lambda c: scale_stats.fused_scale_rgb(p12, taps, opsin, columns=c)[0],
        "kernel 2": lambda c: scale_tail.fused_pyramid_tail(p12, 4, taps, opsin, columns=c),
        "#4": lambda c: fused_tail.fused_tail(p12, 4, taps, opsin, columns=c),
        "#8": lambda c: scale_stats.scale_sums(xyb[0], xyb[1], taps, columns=c),
        "#10": lambda c: scale_stats.fused_scale_pair(ref, dis, taps, opsin, columns=c),
    }
    for name, call in calls.items():
        whole = call(None)
        assert torch.equal(call((0, w)), whole), name
        left, right = call((0, cut)), call((cut, w))
        np.testing.assert_allclose((left.double() + right.double()).numpy(), whole.double().numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
        assert not torch.equal(left, whole), name


def test_window_subscores_and_dims():
    """The level sums of owned-column windows: a window of the whole width
    is the unwindowed call bit for bit (RGB and YUV entries), three windows
    cut on multiples of 2^(levels-1) add to the whole frame's sums on every
    level (rtol 1e-6), and the unwindowed sums normalised by the frame's
    scale_dims are the sub-scores bit for bit."""
    taps, opsin = _consts()
    ref, dis = _rgb_pair(11, 1, 48, 99)
    for backend in ("jnp", "pallas3"):
        whole = s2.ssimulacra2_level_sums(ref, dis, num_scales=3, backend=backend)
        assert all(torch.equal(a, b) for a, b in zip(
            s2.ssimulacra2_level_sums(ref, dis, num_scales=3, backend=backend, columns=(0, 99)), whole))
        parts = [s2.ssimulacra2_level_sums(ref, dis, num_scales=3, backend=backend, columns=c)
                 for c in ((0, 16), (16, 80), (80, 99))]
        for lvl, want in enumerate(whole):
            got = sum(p[lvl].double() for p in parts)
            np.testing.assert_allclose(got.numpy(), want.double().numpy(), rtol=1e-6, atol=1e-9,
                                       err_msg=f"{backend} level {lvl}")
    # ``whole`` is pallas3's: its sub-scores are its sums' norms.
    assert torch.equal(s2.subscores_from_sums(whole, scale_dims(48, 99, 3)),
                       s2.ssimulacra2_subscores(ref, dis, num_scales=3, backend="pallas3"))
    y2, uv2 = _yuv_pair(11, 1, 48, 99)
    whole = s2.ssimulacra2_level_sums_from_yuv(y2, uv2, taps, opsin, num_scales=3)
    assert all(torch.equal(a, b) for a, b in zip(
        s2.ssimulacra2_level_sums_from_yuv(y2, uv2, taps, opsin, num_scales=3, columns=(0, 99)), whole))
    assert torch.equal(s2.subscores_from_sums(whole, scale_dims(48, 99, 3)),
                       s2.ssimulacra2_subscores_from_yuv(y2, uv2, taps, opsin, num_scales=3))
    assert opsin_vector().shape == (11,)
