"""Width sharding of VMAF's fixed-point features in the port (parallel/mesh.py
``shard_over_width`` of ops/kernels/integer_vif.py ``integer_vif_stats`` and
ops/kernels/integer_adm.py ``integer_adm_stats``, through the strip loops of
ops/kernels/vif.py and adm.py; the owned-column windows of kernels K-int-VIF
and K-int-ADM) vs the port's unsharded calls and the JAX package's jnp
functions, on the CPU.

On the CPU every kernel wrapper runs its plain twin; the strips are entries
of ``make_mesh(n, device="cpu")``.  Against the port's unsharded calls the
sums lie within rtol 1e-6 (each strip's f32 sums round apart) and the
features within 1e-6; every strip's integer planes (VIF's moments and means,
ADM's bands and gate) at its owned pixels equal the frame's bit for bit.
Against the JAX package's jnp functions (compiled once, in a module
fixture) the bars are tests/test_torch_integer.py's: VIF sums rel 2e-5, ADM
5e-4.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from turbo_metrics_tpu.ops import integer_adm as jia
from turbo_metrics_tpu.ops import integer_vif as jiv

from turbo_metrics_tpu_torch.ops import adm as tadm
from turbo_metrics_tpu_torch.ops import vif as tvif
from turbo_metrics_tpu_torch.ops.kernels import adm, integer_adm, integer_vif, vif
from turbo_metrics_tpu_torch.parallel import mesh

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

# tests/test_torch_integer.py: the port vs the JAX functions.
VIF_RTOL, ADM_RTOL = 2e-5, 5e-4
# Sharded vs unsharded in the port: the strips' f32 sums round apart.
SHARD_RTOL, FEATURE_ATOL = 1e-6, 1e-6
CPU = functools.partial(mesh.make_mesh, device="cpu")
ENTRIES = {"vif": integer_vif.integer_vif_stats, "adm": integer_adm.integer_adm_stats}
# (B, h, w) held against the JAX package: an odd width, four 64-column strips.
JAX_SHAPE = (2, 40, 259)
JAX_SEEDS = {8: 1, 10: 2}


def _codes(seed, b, h, w, depth, noise=None):
    """A (2, B, h, w) pair of luma codes at ``depth`` bits (uint8 at 8, else
    uint16): a sinusoid with per-frame noise, and a noisy copy; ``noise``
    (a fraction of the range) for white noise, every column apart from its
    neighbours."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    if noise is None:
        yy, xx = np.mgrid[0:h, 0:w]
        ref = top * (0.5 + 0.3 * np.sin(xx / 11) * np.cos(yy / 7)) + rng.normal(0, top / 128, (b, h, w))
        dis = ref + rng.normal(0, top / 64, ref.shape)
    else:
        ref = rng.uniform(0, top, (b, h, w))
        dis = ref + rng.normal(0, noise * top, ref.shape)
    pair = np.clip(np.round(np.stack([ref, dis])), 0, top)
    return torch.from_numpy(pair.astype(np.uint8 if depth == 8 else np.uint16))


@pytest.fixture(scope="module")
def jax_stats():
    """The JAX package's jnp integer_vif_stats at 8 and 10 bits and its
    integer_adm_stats at 10 bits, on JAX_SHAPE pairs (one compiled
    function)."""
    p8, p10 = (_codes(JAX_SEEDS[d], *JAX_SHAPE, d).numpy() for d in (8, 10))
    fn = jax.jit(lambda a, b, c, d: (jiv.integer_vif_stats(a, b, depth=8), jiv.integer_vif_stats(c, d, depth=10),
                                     jia.integer_adm_stats(c, d, depth=10)))
    v8, v10, a10 = (np.asarray(t) for t in fn(p8[0], p8[1], p10[0], p10[1]))
    return {("vif", 8): v8, ("vif", 10): v10, ("adm", 10): a10}


@pytest.mark.parametrize("entry,depth", [("vif", 8), ("vif", 10), ("adm", 10)])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_matches_jax(jax_stats, entry, depth, n):
    """The port's shard_over_width of the integer entry over n strips at an
    odd width against the JAX package's unsharded jnp function."""
    fn = functools.partial(ENTRIES[entry], depth=depth)
    got = mesh.shard_over_width(fn, CPU(n), in_ndims=(4,))(_codes(JAX_SEEDS[depth], *JAX_SHAPE, depth))
    np.testing.assert_allclose(got.numpy(), jax_stats[entry, depth], rtol=VIF_RTOL if entry == "vif" else ADM_RTOL,
                               atol=0)


def _features(entry, sums, h, w):
    if entry == "vif":
        return tvif.vif_scores(sums.numpy())
    return tadm.adm_score(sums.numpy(), h, w)


# (entry, depth, B, h, w, strips): u8 and 10-bit u16 codes, odd widths, the
# narrowest frames each plan splits (4 strips of A columns).
SHARD_CASES = [(e, d, b, h, w, n) for e in ("vif", "adm") for d, b, h, w, n in (
    (8, 2, 33, 259, 2), (10, 1, 33, 259, 3), (8, 1, 24, 515, 4), (10, 2, 17, 4 * (8 if e == "vif" else 16), 4))]


@pytest.mark.parametrize("entry,depth,b,h,w,n", SHARD_CASES)
def test_sharded_matches_unsharded(monkeypatch, entry, depth, b, h, w, n):
    """Sums within rtol 1e-6 of the unsharded call and their features
    (ADM's scored with the frame's size) within 1e-6; shape and type equal;
    each strip keeps the codes' dtype."""
    fn = functools.partial(ENTRIES[entry], depth=depth)
    p = _codes(w + n, b, h, w, depth)
    mod = vif if entry == "vif" else adm
    seen = []

    def strip_input(t, s, dev, **kw):
        out = mesh.strip_input(t, s, dev, **kw)
        seen.append(out.dtype)
        return out

    monkeypatch.setattr(mod, "strip_input", strip_input)
    want = fn(p)
    got = mesh.shard_over_width(fn, CPU(n), in_ndims=(4,))(p)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SHARD_RTOL, atol=0)
    f_got, f_want = _features(entry, got, h, w), _features(entry, want, h, w)
    assert list(f_got) == list(f_want)
    for k in f_want:
        np.testing.assert_allclose(f_got[k], f_want[k], rtol=0, atol=FEATURE_ATOL, err_msg=k)
    assert seen == [p.dtype] * n


def _owned_vif_planes(p, depth, plan):
    """Every strip's VIF planes at its owned pixels, per scale, joined."""
    out = []
    for s in plan:
        planes = integer_vif.integer_vif_planes(p[..., s.lo:s.hi].contiguous(), depth=depth)
        out.append([{k: v[..., lo:hi] for k, v in sc.items()} for sc, (lo, hi)
                    in zip(planes, (tvif.scale_columns(s.columns, k) for k in range(4)))])
    return [{k: torch.cat([o[sc][k] for o in out], dim=-1) for k in out[0][sc]} for sc in range(4)]


def _owned_adm_levels(p, depth, plan, w):
    """Every strip's ADM bands and gate at its owned band columns, per
    level, joined."""
    out = []
    for s in plan:
        levels = integer_adm.integer_adm_levels(p[..., s.lo:s.hi].contiguous(), depth=depth)
        m = [1 << (li + 1) for li in range(4)]
        out.append([{k: v[..., -(-s.own_lo // m[li]):-(-s.own_hi // m[li])] for k, v in lv.items()}
                    for li, lv in enumerate(levels)])
    return [{k: torch.cat([o[li][k] for o in out], dim=-1) for k in out[0][li]} for li in range(4)]


@pytest.mark.parametrize("depth", [8, 10])
def test_strip_planes_are_the_frames(depth):
    """At every scale and level, each strip's integer planes at its owned
    pixels are the frame's bit for bit (VIF's moments, means and inputs;
    ADM's six bands, gate and A bands): the plans' halos reach every owned
    output, and A keeps the strips in the frame's decimation phase."""
    h, w = 40, 4 * 64 + 3
    p = _codes(11, 1, h, w, depth, noise=0.1)
    m4 = CPU(4)
    plan = mesh.spatial_sharding(m4, w, alignment=vif.STRIP_ALIGNMENT, halo=vif.STRIP_HALO)
    frame = integer_vif.integer_vif_planes(p, depth=depth)
    for k, (got, want) in enumerate(zip(_owned_vif_planes(p, depth, plan), frame)):
        for key in want:
            assert torch.equal(got[key], want[key]), (k, key)
    plan = mesh.spatial_sharding(m4, w, alignment=adm.STRIP_ALIGNMENT, halo=adm.STRIP_HALO)
    frame = integer_adm.integer_adm_levels(p, depth=depth)
    for li, (got, want) in enumerate(zip(_owned_adm_levels(p, depth, plan, w), frame)):
        for key in want:
            assert torch.equal(got[key], want[key]), (li, key)


@pytest.mark.parametrize("entry", ["vif", "adm"])
def test_halos_are_tight(entry):
    """A halo of H - A columns (VIF 16, ADM 16) gives sums that differ from
    the unsharded call's, where the plan's own halo does not: the tests can
    see a halo that is too short."""
    fn, mod = ENTRIES[entry], vif if entry == "vif" else adm
    w = 512
    p = _codes(4, 1, 48, w, 8, noise=0.15)
    want = fn(p).double()
    for halo, close in ((mod.STRIP_HALO - mod.STRIP_ALIGNMENT, False), (mod.STRIP_HALO, True)):
        plan = mesh.spatial_sharding(CPU(4), w, alignment=mod.STRIP_ALIGNMENT, halo=halo)
        got = sum(fn(p[..., s.lo:s.hi].contiguous(), columns=s.columns,
                     **({"frame": (s.lo, w)} if entry == "adm" else {})).double() for s in plan)
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        assert (rel <= SHARD_RTOL) == close, (halo, rel)
        if not close:
            assert rel > 10 * SHARD_RTOL, (halo, rel)


@pytest.mark.parametrize("depth", [8, 10])
def test_vif_windows_add_up(depth):
    """K-int-VIF's twin: the full window bit-equal to none; three windows on
    multiples of 8 add to the whole at every scale (rtol 1e-6), each apart
    from it; an empty window adds zeros; the plain twin takes the same
    windows (ops/integer_vif.py)."""
    h, w = 67, 99
    p = _codes(5, 2, h, w, depth)
    whole = integer_vif.integer_vif_stats(p, depth=depth)
    assert torch.equal(integer_vif.integer_vif_stats(p, depth=depth, columns=(0, w)), whole)
    parts = [integer_vif.integer_vif_stats(p, depth=depth, columns=c) for c in ((0, 24), (24, 72), (72, w))]
    np.testing.assert_allclose(sum(t.double() for t in parts).numpy(), whole.double().numpy(), rtol=SHARD_RTOL)
    assert all(bool((t != whole).any()) for t in parts)
    assert torch.equal(integer_vif.integer_vif_stats(p, depth=depth, columns=(40, 40)), torch.zeros(2, 4, 2))
    from turbo_metrics_tpu_torch.ops import integer_vif as tiv

    assert torch.equal(tiv.integer_vif_stats(p[0], p[1], depth=depth, columns=(24, 72)), parts[1])
    with pytest.raises(ValueError, match="columns"):
        integer_vif.integer_vif_stats(p, depth=depth, columns=(10, w + 1))


@pytest.mark.parametrize("depth", [8, 10])
def test_adm_windows_add_up(depth):
    """K-int-ADM's twin: the full window (every level's centre columns)
    bit-equal to none, with and without ``frame``; three windows on
    multiples of 16 add to the whole at every level (rtol 1e-6); a window
    wholly outside every level's centre region gives zeros; a column strip
    with ``frame`` sums the frame's windows."""
    h, w = 75, 101
    p = _codes(6, 2, h, w, depth)
    whole = integer_adm.integer_adm_stats(p, depth=depth)
    assert torch.equal(integer_adm.integer_adm_stats(p, depth=depth, columns=(0, w)), whole)
    assert torch.equal(integer_adm.integer_adm_stats(p, depth=depth, columns=(0, w), frame=(0, w)), whole)
    parts = [integer_adm.integer_adm_stats(p, depth=depth, columns=c) for c in ((0, 32), (32, 80), (80, w))]
    np.testing.assert_allclose(sum(t.double() for t in parts).numpy(), whole.double().numpy(), rtol=SHARD_RTOL)
    assert all(bool((t != whole).any()) for t in parts)
    wide = _codes(7, 1, 40, 512, depth)
    assert torch.equal(integer_adm.integer_adm_stats(wide, depth=depth, columns=(0, 16)), torch.zeros(1, 4, 3, 2))
    # The second of four strips of the 512-column frame, cut with ADM's halo.
    s = mesh.spatial_sharding(CPU(4), 512, alignment=adm.STRIP_ALIGNMENT, halo=adm.STRIP_HALO)[1]
    strip = integer_adm.integer_adm_stats(wide[..., s.lo:s.hi].contiguous(), depth=depth, columns=s.columns,
                                          frame=(s.lo, 512))
    own = integer_adm.integer_adm_stats(wide, depth=depth, columns=(s.lo + s.own_lo, s.lo + s.own_hi))
    np.testing.assert_allclose(strip.numpy(), own.numpy(), rtol=SHARD_RTOL)
    with pytest.raises(ValueError, match="multiple of 16"):
        integer_adm.integer_adm_stats(wide[..., 8:200].contiguous(), depth=depth, columns=(0, 100), frame=(8, 512))


def test_integer_strip_loop_errors():
    """ValueError for a width that leaves a strip fewer than A owned columns
    (naming the smallest width) and for the wrong dims; TypeError for a
    keyword the integer strip loops do not take; a mesh of one runs the
    entry unchanged."""
    m4 = CPU(4)
    with pytest.raises(ValueError, match="at least 32"):
        mesh.shard_over_width(integer_vif.integer_vif_stats, m4, in_ndims=(4,))(_codes(1, 1, 16, 31, 8))
    with pytest.raises(ValueError, match="at least 64"):
        mesh.shard_over_width(integer_adm.integer_adm_stats, m4, in_ndims=(4,))(_codes(1, 1, 16, 63, 8))
    for fn in ENTRIES.values():
        with pytest.raises(ValueError, match="dims"):
            mesh.shard_over_width(fn, m4, in_ndims=(3,))
        with pytest.raises(TypeError, match="no keywords"):
            mesh.shard_over_width(functools.partial(fn, columns=(0, 16)), m4, in_ndims=(4,))
        p = _codes(3, 2, 20, 99, 10)
        one = functools.partial(fn, depth=10)
        assert torch.equal(mesh.shard_over_width(one, CPU(1), in_ndims=(4,))(p), one(p))
