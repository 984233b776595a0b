"""Width sharding of PSNR, SSIM, MS-SSIM and XPSNR in the port
(parallel/mesh.py ``shard_over_width`` of ops/quality.py
``quality_from_rgb`` and ops/kernels/xpsnr.py ``xpsnr_block_stats``; the
owned-column windows of kernels #11 and #12) vs the JAX package's
``shard_over_width`` and the port's unsharded calls, on the CPU.

On the CPU every kernel wrapper runs its plain twin; the strips are entries
of ``make_mesh(n, device="cpu")``.  Against the JAX package (psnr and
ssim_msssim with ``backend="jnp"`` on the quantized codes, XPSNR's jnp
block statistics, four virtual devices) the bars are
tests/test_torch_quality.py's, PSNR 1e-4 dB and SSIM / MS-SSIM 1e-5, and
XPSNR's grids bit for bit.  Against the port's unsharded calls PSNR and
XPSNR's grids are bit-equal (exact integer sums) and SSIM / MS-SSIM within
1e-6 (each strip's f32 sums round apart).  The JAX references are
compiled once, in a module fixture.
"""

import functools

import numpy as np
import pytest
import torch

from turbo_metrics_tpu.ops import quality as jq
from turbo_metrics_tpu.ops import xpsnr_ops as jx
from turbo_metrics_tpu.parallel import mesh as jax_mesh

from turbo_metrics_tpu_torch.ops import quality as tq
from turbo_metrics_tpu_torch.ops import xpsnr_ops
from turbo_metrics_tpu_torch.ops.kernels import vif, windowed, windowed_tail, xpsnr
from turbo_metrics_tpu_torch.parallel import mesh

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

# tests/test_torch_quality.py: the port vs the JAX functions.
PSNR_ATOL, SSIM_ATOL = 1e-4, 1e-5
# Sharded vs unsharded in the port: the strips' f32 sums round apart.
SHARD_ATOL = 1e-6
ALL3 = dict(want_psnr=True, want_ssim=True, want_msssim=True)
# (h, w) against the JAX package: three MS-SSIM levels, and all five.
JAX_SHAPES = [(64, 512), (176, 512)]


def _lin_pair(seed, b, h, w):
    """A (2, B, 3, h, w) linear-RGB pair in [0, 1]: a smooth base with noise
    and a noisier copy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([0.5 + 0.35 * np.sin(xx / (7 + 3 * k)) * np.cos(yy / (5 + 2 * k)) for k in range(3)])
    a = np.clip(base + rng.normal(0, 0.01, (b,) + base.shape), 0, 1)
    d = np.clip(a + rng.normal(0, 0.03, a.shape), 0, 1)
    return torch.from_numpy(np.stack([a, d]).astype(np.float32))


def _codes(p12):
    """The pair's 8-bit code values as f32 numpy (clip(round(x * 255)))."""
    return np.clip(np.round(p12.numpy() * np.float32(255.0)), 0, 255).astype(np.float32)


def _luma(seed, b, h, w, ref_depth, dis_depth):
    """(B, h, w) reference and distorted luma and the (h, w) previous
    reference, the reference at ``ref_depth``, the distorted image at
    ``dis_depth`` (u8 at 8 bits, else u16)."""
    rng = np.random.default_rng(seed)

    def plane(shape, depth):
        return rng.integers(0, 1 << depth, shape).astype(np.uint8 if depth == 8 else np.uint16)

    return plane((b, h, w), ref_depth), plane((b, h, w), dis_depth), plane((h, w), ref_depth)


def _window():
    return tq.Quality(device="cpu").window


def _quality(**flags):
    return functools.partial(tq.quality_from_rgb, window=_window(), **flags)


@pytest.fixture(scope="module")
def jax_width_sharded():
    """The JAX package's width-sharded PSNR and (SSIM, MS-SSIM) of each
    JAX_SHAPES pair's codes, and its XPSNR grids of a u8 and a 10-bit pair
    (the distorted 8-bit luma aligned to 10 bits), over four virtual
    devices."""
    m4 = jax_mesh.make_mesh(4)
    out = {}
    metrics = jax_mesh.shard_over_width(
        lambda a, b: (jq.psnr(a, b),) + jq.ssim_msssim(a, b, backend="jnp"), m4, in_ndims=(4, 4))
    for h, w in JAX_SHAPES:
        codes = _codes(_lin_pair(h + w, 1, h, w))
        out[(h, w)] = [np.asarray(v) for v in metrics(codes[0], codes[1])]
    stats = jax_mesh.shard_over_width(functools.partial(jx.xpsnr_block_stats, backend="jnp"), m4,
                                      in_ndims=(3, 3, 3))
    for ref_depth, dis_depth in ((8, 8), (10, 8)):
        ref, dis, prev0 = _luma(ref_depth, 2, 40, 512, ref_depth, dis_depth)
        y_prev = np.concatenate([prev0[None], ref[:-1]])
        dis_aligned = dis.astype(np.int32) << (ref_depth - dis_depth)
        got = stats(ref, dis_aligned, y_prev)
        out[("xpsnr", ref_depth)] = {k: np.asarray(v).astype(np.int64) for k, v in got.items()}
    return out


@pytest.mark.parametrize("hw", JAX_SHAPES)
def test_quality_matches_jax(jax_width_sharded, hw):
    """The port's shard_over_width of quality_from_rgb over four strips
    against the JAX package's of psnr and ssim_msssim on the codes."""
    h, w = hw
    want_psnr, want_ssim, want_ms = jax_width_sharded[hw]
    lv = tq._clamp_levels(h, w, 5)[0]
    assert lv == (3 if h == 64 else 5)
    p12 = _lin_pair(h + w, 1, h, w)
    got = mesh.shard_over_width(_quality(**ALL3), mesh.make_mesh(4, device="cpu"), in_ndims=(5,))(p12)
    assert all(v.dtype == torch.float32 and v.shape == (1,) for v in got.values())
    np.testing.assert_allclose(got["psnr"].numpy(), want_psnr, rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(got["ssim"].numpy(), want_ssim, rtol=0, atol=SSIM_ATOL)
    np.testing.assert_allclose(got["msssim"].numpy(), want_ms, rtol=0, atol=SSIM_ATOL)
    assert 0.5 < float(want_ssim.min()) and float(want_ms.max()) < 1.0


@pytest.mark.parametrize("ref_depth", [8, 10])
def test_xpsnr_matches_jax(jax_width_sharded, ref_depth):
    """Kernel-route XPSNR strips against the JAX package's shard_over_width
    of its jnp block statistics, y_prev = [prev0, ref[:-1]]: bit for bit."""
    ref, dis, prev0 = (torch.from_numpy(a) for a in _luma(ref_depth, 2, 40, 512, ref_depth, 8))
    fn = functools.partial(xpsnr.xpsnr_block_stats, dis_shift=ref_depth - 8)
    got = mesh.shard_over_width(fn, mesh.make_mesh(4, device="cpu"), in_ndims=(3, 3, 2))(ref, dis, prev0)
    want = jax_width_sharded[("xpsnr", ref_depth)]
    assert list(got) == list(xpsnr.QUANTITIES)
    for k in xpsnr.QUANTITIES:
        assert got[k].dtype == torch.int64 and tuple(got[k].shape) == (2, 3, 32)
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# (flags, B, h, w, strips): all three metrics, SSIM alone, PSNR alone and
# MS-SSIM alone; odd widths; 176x200 over four strips, whose edge strips'
# last level is under 11 columns (a level that owns nothing adds zeros).
QUALITY_CASES = [
    (ALL3, 2, 48, 515, 2), (ALL3, 2, 48, 515, 3), (ALL3, 1, 48, 515, 4), (ALL3, 1, 176, 515, 3),
    (ALL3, 1, 176, 200, 4), (ALL3, 1, 100, 1001, 4),
    (dict(want_ssim=True), 2, 48, 515, 3), (dict(want_ssim=True), 1, 40, 40, 3),
    (dict(want_psnr=True), 2, 48, 515, 4), (dict(want_psnr=True), 1, 16, 7, 4),
    (dict(want_msssim=True), 1, 100, 512, 2),
]


@pytest.mark.parametrize("flags,b,h,w,n", QUALITY_CASES)
def test_quality_sharded_matches_unsharded(flags, b, h, w, n):
    """PSNR bit-equal, SSIM and MS-SSIM within 1e-6 of the unsharded call,
    keys, shapes and types equal."""
    p12 = _lin_pair(w + n, b, h, w)
    fn = _quality(**flags)
    want = fn(p12)
    got = mesh.shard_over_width(fn, mesh.make_mesh(n, device="cpu"), in_ndims=(5,))(p12)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32 and got[k].shape == v.shape == (b,)
        if k == "psnr":
            assert torch.equal(got[k], v)
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=SHARD_ATOL, err_msg=k)


# (B, h, w, strips, reference depth, distorted depth): odd widths whose last
# block is partial (515 = 32 * 16 + 3), heights off the block too.
XPSNR_CASES = [
    (2, 33, 515, 2, 8, 8), (2, 33, 515, 3, 8, 8), (1, 16, 515, 4, 8, 8), (2, 24, 512, 4, 10, 8),
    (1, 17, 100, 3, 10, 10), (1, 8, 64, 4, 8, 8),
]


@pytest.mark.parametrize("b,h,w,n,ref_depth,dis_depth", XPSNR_CASES)
def test_xpsnr_sharded_matches_unsharded(b, h, w, n, ref_depth, dis_depth):
    """The kernel route's three grids bit-equal to the unsharded call's, and
    so the XPSNR of every frame."""
    ref, dis, prev0 = (torch.from_numpy(a) for a in _luma(w + n, b, h, w, ref_depth, dis_depth))
    fn = functools.partial(xpsnr.xpsnr_block_stats, dis_shift=ref_depth - dis_depth)
    want = fn(ref, dis, prev0)
    got = mesh.shard_over_width(fn, mesh.make_mesh(n, device="cpu"), in_ndims=(3, 3, 2))(ref, dis, prev0)
    for k in xpsnr.QUANTITIES:
        assert got[k].dtype == torch.int64 and torch.equal(got[k], want[k]), k
    for f in range(b):
        grids = [got[k][f].numpy() for k in xpsnr.QUANTITIES]
        wsse, _ = xpsnr_ops.xpsnr_weights(*grids, width=w, height=h, depth=ref_depth)
        want_wsse, _ = xpsnr_ops.xpsnr_weights(*(want[k][f].numpy() for k in xpsnr.QUANTITIES),
                                               width=w, height=h, depth=ref_depth)
        assert wsse == want_wsse


@pytest.mark.parametrize("w,n", [(515, 3), (512, 4), (100, 3), (1001, 2)])
def test_xpsnr_plan(w, n):
    """XPSNR's strips: owned edges on multiples of 16 (the last at w), one
    block of halo on each side clipped at the frame's edges, so every strip's
    block grid is the frame's and the owned block columns cover it once."""
    plan = mesh.spatial_sharding(mesh.make_mesh(n, device="cpu"), w, alignment=16, halo=16)
    blocks = []
    for s in plan:
        own_lo, own_hi = s.lo + s.own_lo, s.lo + s.own_hi
        assert s.lo % 16 == 0 and own_lo % 16 == 0 and (own_hi == w or own_hi % 16 == 0)
        assert s.lo == max(0, own_lo - 16) and s.hi == min(w, own_hi + 16)
        blocks += range(own_lo // 16, -(-own_hi // 16))
    assert blocks == list(range(-(-w // 16)))


def _rng_codes(seed, b, h, w):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (b, 3, h, w))
    d = np.clip(a + rng.integers(-20, 21, a.shape), 0, 255)
    return torch.from_numpy(np.stack([a, d]).astype(np.float32))


@pytest.mark.parametrize("quantize", [True, False])
def test_ssim_sums_windows_add_up(quantize):
    """#11's twin: a window of the whole width is the unwindowed call bit for
    bit (the emitted level too); three windows that cut 32-column tiles
    mid-way add to the whole level's sums (rtol 1e-6)."""
    h, w = 67, 99
    p12 = _lin_pair(5, 2, h, w) if quantize else _rng_codes(5, 2, h, w)
    win = _window()
    whole, ds = windowed.ssim_sums(p12, win, quantize=quantize, emit_ds=True)
    full, ds_full = windowed.ssim_sums(p12, win, quantize=quantize, emit_ds=True, columns=(0, w))
    assert torch.equal(full, whole) and torch.equal(ds_full, ds)
    parts = [windowed.ssim_sums(p12, win, quantize=quantize, columns=c)[0] for c in ((0, 21), (21, 58), (58, w))]
    np.testing.assert_allclose(sum(p.double() for p in parts).numpy(), whole.double().numpy(), rtol=1e-6)
    assert all(not torch.equal(p, whole) for p in parts)


def test_msssim_tail_windows_add_up():
    """#12's twin: the full window bit-equal to none; three windows on
    multiples of 2^(levels-1) add to the whole on every level (rtol 1e-6)."""
    q = _rng_codes(6, 2, 100, 131)
    win = _window()
    whole = windowed_tail.msssim_tail(q, 4, win)
    assert torch.equal(windowed_tail.msssim_tail(q, 4, win, columns=(0, 131)), whole)
    parts = [windowed_tail.msssim_tail(q, 4, win, columns=c) for c in ((0, 40), (40, 96), (96, 131))]
    np.testing.assert_allclose(sum(p.double() for p in parts).numpy(), whole.double().numpy(), rtol=1e-6)
    assert windowed_tail.level_columns((40, 96), 4) == [(40, 96), (20, 48), (10, 24), (5, 12)]


def test_narrow_levels_add_zeros():
    """A strip's level narrower than the 11-wide window owns no valid output:
    with a window it adds zeros (#11 and #12), where the unwindowed call
    raises; #11 refuses to emit from such a level."""
    win = _window()
    q = _rng_codes(7, 1, 48, 36)
    tail = windowed_tail.msssim_tail(q, 3, win, columns=(16, 36))
    assert torch.equal(tail[:, 2], torch.zeros(1, 3, 2)) and bool((tail[:, :2] != 0).all())
    with pytest.raises(ValueError, match="leave a level under"):
        windowed_tail.msssim_tail(q, 3, win)
    narrow = q[..., :8].contiguous()
    assert torch.equal(windowed.ssim_sums(narrow, win, columns=(0, 8))[0], torch.zeros(1, 3, 2))
    assert torch.equal(windowed_tail.msssim_tail(narrow, 2, win, columns=(0, 8)), torch.zeros(1, 2, 3, 2))
    with pytest.raises(ValueError, match="emits no next level"):
        windowed.ssim_sums(narrow, win, emit_ds=True, columns=(0, 8))
    with pytest.raises(ValueError, match="at least 11x11"):
        windowed.ssim_sums(narrow, win)
    assert windowed.valid_window((0, 8), 8) == (0, 0) and windowed.valid_window((3, 40), 99) == (0, 35)
    assert windowed.valid_window(None, 99) == (0, 89) and windowed.valid_window((60, 99), 99) == (55, 89)


@pytest.mark.parametrize("entry", ["quality", "xpsnr"])
def test_mesh_of_one_bit_equal(entry):
    """A mesh of one entry runs the function unchanged."""
    m1 = mesh.make_mesh(1, device="cpu")
    if entry == "quality":
        p12 = _lin_pair(9, 2, 48, 99)
        fn = _quality(**ALL3)
        got, want = mesh.shard_over_width(fn, m1, in_ndims=(5,))(p12), fn(p12)
    else:
        args = [torch.from_numpy(a) for a in _luma(9, 2, 33, 99, 8, 8)]
        got = mesh.shard_over_width(xpsnr.xpsnr_block_stats, m1, in_ndims=(3, 3, 2))(*args)
        want = xpsnr.xpsnr_block_stats(*args)
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_width_metrics_errors():
    """TypeError for what has no strip loop (a scale wrapper of VIF, any
    other function, the plain block sums under the XPSNR statistics) and a
    missing window; ValueError for XPSNR blocks other than the strips' 16,
    for a width that leaves a strip fewer than A owned columns, naming the
    smallest width, and for the wrong dims."""
    m = mesh.make_mesh(4, device="cpu")
    for fn, nd in ((vif.vif_scale0, (5,)), (lambda a, b: a, (4, 4)), (xpsnr_ops.block_sums, (3,))):
        with pytest.raises(TypeError, match="partitioner"):
            mesh.shard_over_width(fn, m, in_ndims=nd)
    with pytest.raises(ValueError, match="block=16"):
        mesh.shard_over_width(functools.partial(xpsnr_ops.xpsnr_block_stats, block=8), m, in_ndims=(3, 3, 3))
    with pytest.raises(TypeError, match="keywords only"):
        mesh.shard_over_width(functools.partial(tq.quality_from_rgb, _lin_pair(1, 1, 16, 64)), m, in_ndims=(5,))
    with pytest.raises(TypeError, match="window"):
        mesh.shard_over_width(functools.partial(tq.quality_from_rgb, want_psnr=True), m, in_ndims=(5,))
    with pytest.raises(ValueError, match="dims"):
        mesh.shard_over_width(_quality(**ALL3), m, in_ndims=(4, 4))
    with pytest.raises(ValueError, match="dims"):
        mesh.shard_over_width(xpsnr.xpsnr_block_stats, m, in_ndims=(3, 3, 3))
    with pytest.raises(ValueError, match="dims"):
        mesh.shard_over_width(_quality(**ALL3), m, in_ndims=(5,))(_lin_pair(1, 1, 48, 99)[0])
    # 176x176 keeps five MS-SSIM levels: owned edges on multiples of 16.
    with pytest.raises(ValueError, match="at least 256"):
        mesh.shard_over_width(_quality(**ALL3), mesh.make_mesh(16, device="cpu"), in_ndims=(5,))(
            _lin_pair(1, 1, 176, 176))
    with pytest.raises(ValueError, match="at least 64"):
        mesh.shard_over_width(xpsnr.xpsnr_block_stats, m, in_ndims=(3, 3, 2))(
            *(torch.from_numpy(a) for a in _luma(1, 1, 16, 63, 8, 8)))
    with pytest.raises(ValueError, match="multiple of the alignment"):
        mesh.spatial_sharding(m, 512, alignment=16, halo=8)
