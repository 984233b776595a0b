"""Width sharding of VMAF's float features in the port (parallel/mesh.py
``shard_over_width`` of ops/kernels/vif.py ``vif_scale_stats``,
ops/kernels/adm.py ``adm_stats`` and ops/kernels/motion.py ``motion_stats``
and ``integer_blur``; the owned-column windows of kernels #14, #15, #16 and
#18) vs the JAX package's ``shard_over_width`` and the port's unsharded
calls, on the CPU.

On the CPU every kernel wrapper runs its plain twin; the strips are entries
of ``make_mesh(n, device="cpu")``.  Against the JAX package (its jnp
functions over four virtual devices) the bars are tests/test_torch_vmaf.py's:
VIF sums rtol 2e-5 / atol 2e-6, ADM sums rtol 1e-4 (against the jnp path
op by op where the jitted one flipped an angle gate), motion and its blur
bit for bit.  Against the port's unsharded calls the VIF and ADM sums lie
within rtol 1e-6 (each strip's f32 sums round apart) and their features
within 1e-6, the blurred planes and row SADs are bit-equal.  The JAX
references are compiled once, in a module fixture.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turbo_metrics_tpu.ops import adm as jadm
from turbo_metrics_tpu.ops import vif as jvif
from turbo_metrics_tpu.ops import vmaf_motion as jmot
from turbo_metrics_tpu.parallel import mesh as jax_mesh

from turbo_metrics_tpu_torch.ops import adm as tadm
from turbo_metrics_tpu_torch.ops import vif as tvif
from turbo_metrics_tpu_torch.ops.kernels import adm, integer_adm, integer_vif, motion, vif
from turbo_metrics_tpu_torch.parallel import mesh

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

# tests/test_torch_vmaf.py: the port vs the JAX functions.
VIF_RTOL, VIF_ATOL, ADM_RTOL = 2e-5, 2e-6, 1e-4
# Sharded vs unsharded in the port: the strips' f32 sums round apart.
SHARD_RTOL, FEATURE_ATOL = 1e-6, 1e-6
# (B, h, w) against the JAX package: 128 columns per virtual device.
JAX_SHAPE = (1, 96, 512)
CPU = functools.partial(mesh.make_mesh, device="cpu")


def _pair(seed, b, h, w, noise=4.0):
    """A (2, B, h, w) f32 luma pair in 8-bit units: tests/test_torch_vmaf.py's
    sinusoid with per-frame noise, and a noisy copy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 80 * np.sin(xx / 11) * np.cos(yy / 7)
    ref = np.clip(base + rng.normal(0, 2, (b, h, w)), 0, 255)
    dis = np.clip(ref + rng.normal(0, noise, ref.shape), 0, 255)
    return torch.from_numpy(np.stack([ref, dis]).astype(np.float32))


def _noise_pair(seed, b, h, w):
    """White noise and a noisy copy: every column differs from its
    neighbours, so a halo that is too short shows."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 255, (b, h, w))
    dis = np.clip(ref + rng.normal(0, 20, ref.shape), 0, 255)
    return torch.from_numpy(np.stack([ref, dis]).astype(np.float32))


def _luma(seed, b, h, w, depth):
    """(B, h, w) luma codes at ``depth`` bits (u8 at 8, else u16) and a (h,
    w) uint16 previous blurred plane."""
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth == 8 else np.uint16
    y = rng.integers(0, 1 << depth, (b, h, w)).astype(dt)
    return torch.from_numpy(y), torch.from_numpy(rng.integers(0, 1 << 16, (h, w)).astype(np.uint16))


def _jax_motion(y, p0, depth):
    prev = jnp.concatenate([p0[None], jmot.integer_blur(y, depth=depth, backend="jnp")[:-1]])
    return jmot.motion_stats(y, prev, depth=depth, backend="jnp")


@pytest.fixture(scope="module")
def jax_width_sharded():
    """The JAX package's width-sharded VIF and ADM sums of a JAX_SHAPE pair,
    its motion statistics and its blur of 8-bit and 10-bit luma, over four
    virtual devices (four compiled functions)."""
    m4 = jax_mesh.make_mesh(4)
    b, h, w = JAX_SHAPE
    ref, dis = _pair(1, b, h, w).numpy()
    vif_fn = jax_mesh.shard_over_width(functools.partial(jvif.vif_scale_stats, backend="jnp"), m4, in_ndims=(3, 3))
    adm_fn = jax_mesh.shard_over_width(functools.partial(jadm.adm_stats, backend="jnp"), m4, in_ndims=(3, 3))
    motion_fn = jax_mesh.shard_over_width(
        lambda y8, p8, y10, p10: (_jax_motion(y8, p8, 8), _jax_motion(y10, p10, 10)), m4, in_ndims=(3, 2, 3, 2))
    blur_fn = jax_mesh.shard_over_width(
        lambda y8, y10: (jmot.integer_blur(y8, depth=8, backend="jnp"), jmot.integer_blur(y10, depth=10, backend="jnp")),
        m4, in_ndims=(3, 3))
    lumas = {d: [t.numpy() for t in _luma(d, b, h, w, d)] for d in (8, 10)}
    stats = motion_fn(*lumas[8], *lumas[10])
    blurs = blur_fn(lumas[8][0], lumas[10][0])
    out = {"vif": np.asarray(vif_fn(ref, dis)), "adm": np.asarray(adm_fn(ref, dis))}
    for i, d in enumerate((8, 10)):
        out[("motion", d)] = {k: np.asarray(v).astype(np.int64) for k, v in stats[i].items()}
        out[("blur", d)] = np.asarray(blurs[i])
    return out


def test_vif_matches_jax(jax_width_sharded):
    """The port's shard_over_width of vif_scale_stats over four strips
    against the JAX package's of its jnp VIF."""
    got = mesh.shard_over_width(vif.vif_scale_stats, CPU(4), in_ndims=(4,))(_pair(1, *JAX_SHAPE))
    assert got.dtype == torch.float32 and tuple(got.shape) == (JAX_SHAPE[0], 4, 2)
    np.testing.assert_allclose(got.numpy(), jax_width_sharded["vif"], rtol=VIF_RTOL, atol=VIF_ATOL)


def test_adm_matches_jax(jax_width_sharded):
    """The port's shard_over_width of adm_stats over four strips against the
    JAX package's of its jnp ADM; where the jitted path flipped an angle
    gate (FMA contraction), against the jnp path op by op."""
    p = _pair(1, *JAX_SHAPE)
    got = mesh.shard_over_width(adm.adm_stats, CPU(4), in_ndims=(4,))(p)
    assert got.dtype == torch.float32 and tuple(got.shape) == (JAX_SHAPE[0], 4, 3, 2)
    if not np.allclose(got.numpy(), jax_width_sharded["adm"], rtol=ADM_RTOL, atol=0):
        want = np.asarray(jadm.adm_stats(p[0].numpy(), p[1].numpy(), backend="jnp"))
        np.testing.assert_allclose(got.numpy(), want, rtol=ADM_RTOL, atol=0,
                                   err_msg="apart from both the jitted and the op-by-op jnp path")


@pytest.mark.parametrize("depth", [8, 10])
def test_motion_matches_jax(jax_width_sharded, depth):
    """Motion's blurred planes and row SADs, and the blur alone, over four
    strips bit for bit against the JAX package's shard_over_width of its jnp
    functions (frame 0's previous plane prev0, frame b's the blur of frame
    b - 1)."""
    y, p0 = _luma(depth, *JAX_SHAPE, depth)
    fn = functools.partial(motion.motion_stats, depth=depth)
    got = mesh.shard_over_width(fn, CPU(4), in_ndims=(3, 2))(y, p0)
    want = jax_width_sharded[("motion", depth)]
    assert got["blurred"].dtype == torch.uint16 and got["sad_rows"].dtype == torch.int64
    np.testing.assert_array_equal(got["blurred"].numpy().astype(np.int64), want["blurred"])
    np.testing.assert_array_equal(got["sad_rows"].numpy(), want["sad_rows"])
    blur = mesh.shard_over_width(functools.partial(motion.integer_blur, depth=depth), CPU(4), in_ndims=(3,))(y)
    np.testing.assert_array_equal(blur.numpy(), jax_width_sharded[("blur", depth)])


# (entry, B, h, w, strips): odd widths, and ADM's odd band sizes at 75x517.
FEATURE_CASES = [
    ("vif", 2, 48, 515, 2), ("vif", 2, 48, 515, 3), ("vif", 1, 48, 515, 4), ("vif", 1, 33, 100, 4),
    ("adm", 1, 75, 517, 2), ("adm", 2, 75, 517, 3), ("adm", 1, 75, 517, 4), ("adm", 1, 40, 64, 4),
]


def _features(entry, sums, h, w):
    if entry == "vif":
        return tvif.vif_scores(sums.numpy())
    return tadm.adm_score(sums.numpy(), h, w)


@pytest.mark.parametrize("entry,b,h,w,n", FEATURE_CASES)
def test_features_sharded_match_unsharded(entry, b, h, w, n):
    """VIF and ADM sums within rtol 1e-6 of the unsharded call, their
    features (ADM's scored with the frame's size) within 1e-6; shapes and
    types equal."""
    fn = vif.vif_scale_stats if entry == "vif" else adm.adm_stats
    p = _pair(w + n, b, h, w)
    want = fn(p)
    got = mesh.shard_over_width(fn, CPU(n), in_ndims=(4,))(p)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SHARD_RTOL, atol=0)
    f_got, f_want = _features(entry, got, h, w), _features(entry, want, h, w)
    assert list(f_got) == list(f_want)
    for k in f_want:
        np.testing.assert_allclose(f_got[k], f_want[k], rtol=0, atol=FEATURE_ATOL, err_msg=k)


# (depth, B, h, w, strips): u8 and 16-bit luma, int32 codes; odd widths.
MOTION_CASES = [(8, 3, 33, 515, 2), (8, 2, 33, 515, 3), (10, 3, 17, 515, 4), (16, 2, 9, 100, 3), (10, 2, 8, 64, 4)]


@pytest.mark.parametrize("depth,b,h,w,n", MOTION_CASES)
def test_motion_sharded_matches_unsharded(depth, b, h, w, n):
    """The blurred planes, the row SADs and #17's plane bit-equal to the
    unsharded calls; the motion score with them."""
    y, p0 = _luma(w + n, b, h, w, depth)
    if depth == 16:
        y = y.to(torch.int32)  # int32 codes, as RGB sources give
    fn = functools.partial(motion.motion_stats, depth=depth)
    want = fn(y, p0)
    got = mesh.shard_over_width(fn, CPU(n), in_ndims=(3, 2))(y, p0)
    assert list(got) == ["blurred", "sad_rows"]
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    blur = functools.partial(motion.integer_blur, depth=depth)
    assert torch.equal(mesh.shard_over_width(blur, CPU(n), in_ndims=(3,))(y), blur(y))


def _hand_cut(fn, t, plan, **kw):
    """The strip loop by hand over ``plan``: each strip's f64 sums added."""
    w = t.shape[-1]
    return sum(fn(t[..., s.lo:s.hi].contiguous(), columns=s.columns,
                  **({"frame": (s.lo, w)} if fn is adm.adm_stats else {}), **kw).double() for s in plan)


@pytest.mark.parametrize("entry", ["vif", "adm", "motion"])
def test_halos_are_tight(entry):
    """A halo of H - A columns (VIF 16, ADM 16, motion 0) gives results that
    differ from the unsharded call's, where the strip loop's own halo does
    not: the tests can see a halo that is too short."""
    m4 = CPU(4)
    if entry == "motion":
        y, p0 = _luma(3, 2, 20, 512, 8)
        want = motion.motion_stats(y, p0)
        for halo, equal in ((0, False), (motion.STRIP_HALO, True)):
            plan = mesh.spatial_sharding(m4, 512, alignment=motion.STRIP_ALIGNMENT, halo=halo)
            blurred = torch.cat([motion.integer_blur(y[..., s.lo:s.hi].contiguous())[..., s.own_lo:s.own_hi]
                                 for s in plan], dim=-1)
            assert torch.equal(blurred, want["blurred"]) == equal, halo
        return
    mod = vif if entry == "vif" else adm
    fn = vif.vif_scale_stats if entry == "vif" else adm.adm_stats
    p = _noise_pair(4, 1, 64, 512)
    want = fn(p).double()
    for halo, close in ((mod.STRIP_HALO - mod.STRIP_ALIGNMENT, False), (mod.STRIP_HALO, True)):
        plan = mesh.spatial_sharding(m4, 512, alignment=mod.STRIP_ALIGNMENT, halo=halo)
        got = _hand_cut(fn, p, plan)
        rel = float(((got - want).abs() / want.abs()).max())
        assert (rel <= SHARD_RTOL) == close, (halo, rel)
        if not close:
            assert rel > 10 * SHARD_RTOL, (halo, rel)


def test_vif_windows_add_up():
    """#14 and #15's twins: the full window bit-equal to none (scale 1's
    emitted input too); three windows on multiples of 8 add to the whole at
    every scale (rtol 1e-6); an empty window adds zeros."""
    h, w = 67, 99
    p = _pair(5, 2, h, w)
    whole0, l1 = vif.vif_scale0(p)
    full0, l1_full = vif.vif_scale0(p, columns=(0, w))
    assert torch.equal(full0, whole0) and torch.equal(l1_full, l1)
    whole_tail = vif.vif_tail(l1)
    assert torch.equal(vif.vif_tail(l1, columns=(0, l1.shape[-1])), whole_tail)
    whole = vif.vif_scale_stats(p)
    assert torch.equal(vif.vif_scale_stats(p, columns=(0, w)), whole)
    parts = [vif.vif_scale_stats(p, columns=c) for c in ((0, 24), (24, 72), (72, w))]
    np.testing.assert_allclose(sum(t.double() for t in parts).numpy(), whole.double().numpy(), rtol=SHARD_RTOL)
    assert all(bool((t != whole).any()) for t in parts)
    assert torch.equal(vif.vif_scale0(p, columns=(40, 40))[0], torch.zeros(2, 2))
    assert [tvif.scale_columns((24, 99), k) for k in range(4)] == [(24, 99), (12, 50), (6, 25), (3, 13)]


def test_adm_windows_add_up():
    """#18's twin: the full window (every level's centre columns) bit-equal
    to none; three windows on multiples of 16 add to the whole at every
    level (rtol 1e-6); a window wholly outside every level's centre region
    gives zeros."""
    h, w = 75, 101
    p = _pair(6, 2, h, w)
    whole = adm.adm_stats(p)
    assert torch.equal(adm.adm_stats(p, columns=(0, w)), whole)
    assert torch.equal(adm.adm_stats(p, columns=(0, w), frame=(0, w)), whole)
    parts = [adm.adm_stats(p, columns=c) for c in ((0, 32), (32, 80), (80, w))]
    np.testing.assert_allclose(sum(t.double() for t in parts).numpy(), whole.double().numpy(), rtol=SHARD_RTOL)
    assert all(bool((t != whole).any()) for t in parts)
    # At 512 columns the centre regions start at band columns 25, 12, 5, 2:
    # level-0 columns 0-15 lie left of every one.
    assert tadm.level_windows(512, (0, 16)) == [(25, 25), (12, 12), (5, 5), (2, 2)]
    assert torch.equal(adm.adm_stats(_pair(6, 1, 40, 512), columns=(0, 16)), torch.zeros(1, 4, 3, 2))
    # A strip's windows are the frame's, made strip-local.
    frame = tadm.level_windows(512, (128, 384))
    strip = tadm.level_windows(320, (32, 288), frame=(96, 512))
    assert [(a - 96 // 2 ** (k + 1), b - 96 // 2 ** (k + 1)) for k, (a, b) in enumerate(frame)] == strip
    with pytest.raises(ValueError, match="multiple of 16"):
        tadm.level_windows(100, (0, 50), frame=(8, 512))


def test_motion_windows_add_up():
    """#16's twin: the full window bit-equal to none; windows add to the
    whole rows exactly; the blurred planes whole either way."""
    y, p0 = _luma(7, 3, 19, 99, 8)
    whole = motion.motion_stats(y, p0)
    full = motion.motion_stats(y, p0, columns=(0, 99))
    assert all(torch.equal(full[k], whole[k]) for k in whole)
    parts = [motion.motion_stats(y, p0, columns=c) for c in ((0, 13), (13, 64), (64, 99))]
    assert torch.equal(sum(t["sad_rows"] for t in parts), whole["sad_rows"])
    assert all(torch.equal(t["blurred"], whole["blurred"]) for t in parts)
    assert torch.equal(motion.motion_stats(y, p0, columns=(5, 5))["sad_rows"], torch.zeros(3, 19, dtype=torch.int64))


@pytest.mark.parametrize("entry", ["vif", "adm", "motion"])
@pytest.mark.parametrize("w,n", [(515, 3), (512, 4), (100, 2)])
def test_plans(entry, w, n):
    """Each feature's strips: owned edges on multiples of A (the last at w),
    H columns of halo on each side clipped at the frame's edges, the owned
    columns covering the frame once; the halo overhead at 7680 columns."""
    mod = {"vif": vif, "adm": adm, "motion": motion}[entry]
    a, halo = mod.STRIP_ALIGNMENT, mod.STRIP_HALO
    assert (a, halo) == {"vif": (8, 24), "adm": (16, 32), "motion": (16, 16)}[entry]
    plan = mesh.spatial_sharding(CPU(n), w, alignment=a, halo=halo)
    owned = []
    for s in plan:
        own_lo, own_hi = s.lo + s.own_lo, s.lo + s.own_hi
        assert s.lo % a == 0 and own_lo % a == 0 and (own_hi == w or own_hi % a == 0)
        assert s.lo == max(0, own_lo - halo) and s.hi == min(w, own_hi + halo)
        owned += range(own_lo, own_hi)
    assert owned == list(range(w))
    want = {"vif": (1.00625, 1.01875, 1.04375), "adm": (1.00833, 1.025, 1.05833),
            "motion": (1.00417, 1.0125, 1.02917)}[entry]
    for k, strips in enumerate((2, 4, 8)):
        wide = mesh.spatial_sharding(CPU(strips), 7680, alignment=a, halo=halo)
        assert round(mesh.halo_overhead(wide), 5) == want[k]


@pytest.mark.parametrize("entry", ["vif", "adm", "motion", "blur"])
def test_mesh_of_one_bit_equal(entry):
    """A mesh of one entry runs the function unchanged."""
    m1 = CPU(1)
    if entry in ("vif", "adm"):
        fn, args, nd = (vif.vif_scale_stats if entry == "vif" else adm.adm_stats), (_pair(9, 2, 40, 99),), (4,)
        assert torch.equal(mesh.shard_over_width(fn, m1, in_ndims=nd)(*args), fn(*args))
        return
    y, p0 = _luma(9, 2, 20, 99, 8)
    if entry == "blur":
        assert torch.equal(mesh.shard_over_width(motion.integer_blur, m1, in_ndims=(3,))(y), motion.integer_blur(y))
        return
    got, want = mesh.shard_over_width(motion.motion_stats, m1, in_ndims=(3, 2))(y, p0), motion.motion_stats(y, p0)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_vmaf_width_errors():
    """ValueError for a width that leaves a strip fewer than A owned columns,
    naming the smallest width, and for the wrong dims; TypeError for what
    has no strip loop (VIF's scale wrappers, any other function) and for
    keywords the strip loops do not take; the fixed-point features take
    VIF's and ADM's strip loops."""
    m4 = CPU(4)
    with pytest.raises(ValueError, match="at least 32"):
        mesh.shard_over_width(vif.vif_scale_stats, m4, in_ndims=(4,))(_pair(1, 1, 16, 31))
    with pytest.raises(ValueError, match="at least 64"):
        mesh.shard_over_width(adm.adm_stats, m4, in_ndims=(4,))(_pair(1, 1, 16, 63))
    with pytest.raises(ValueError, match="at least 64"):
        mesh.shard_over_width(motion.motion_stats, m4, in_ndims=(3, 2))(*_luma(1, 1, 16, 63, 8))
    with pytest.raises(ValueError, match="at least 64"):
        mesh.shard_over_width(motion.integer_blur, m4, in_ndims=(3,))(_luma(1, 1, 16, 63, 8)[0])
    for fn, nd in ((vif.vif_scale_stats, (3, 3)), (adm.adm_stats, (4, 4)), (motion.motion_stats, (3, 3)),
                   (motion.integer_blur, (3, 2))):
        with pytest.raises(ValueError, match="dims"):
            mesh.shard_over_width(fn, m4, in_ndims=nd)
    with pytest.raises(ValueError, match="dims"):
        mesh.shard_over_width(vif.vif_scale_stats, m4, in_ndims=(4,))(_pair(1, 1, 16, 64)[0])
    for fn, nd in ((vif.vif_scale0, (4,)), (vif.vif_tail, (4,)), (lambda pair: pair, (4,))):
        with pytest.raises(TypeError, match="partitioner"):
            mesh.shard_over_width(fn, m4, in_ndims=nd)
    for fn in (integer_vif.integer_vif_stats, integer_adm.integer_adm_stats):
        assert callable(mesh.shard_over_width(functools.partial(fn, depth=10), m4, in_ndims=(4,)))
    with pytest.raises(TypeError, match="no keywords"):
        mesh.shard_over_width(functools.partial(vif.vif_scale_stats, columns=(0, 8)), m4, in_ndims=(4,))
    with pytest.raises(TypeError, match="no keywords"):
        mesh.shard_over_width(functools.partial(motion.motion_stats, columns=(0, 8)), m4, in_ndims=(3, 2))
    with pytest.raises(TypeError, match="keywords only"):
        mesh.shard_over_width(functools.partial(adm.adm_stats, _pair(1, 1, 16, 64)), m4, in_ndims=(4,))
