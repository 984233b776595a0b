"""The port's plain SSIM / MS-SSIM / XPSNR entries on their kernels
(ops/quality.py ``ssim``, ``msssim``, ``ssim_msssim`` with ``backend``, on
kernels #11 and #12; ops/xpsnr_ops.py ``xpsnr_block_stats`` with ``depth``
and ``backend``, on kernel #13 with every frame's previous plane), and their
width sharding (parallel/mesh.py ``shard_over_width``: ops/quality.py
``plain_width_sharded``, ops/kernels/xpsnr.py ``xpsnr_width_sharded``), vs
the JAX package and the port's own routes, on the CPU.

On the CPU every kernel wrapper runs its plain twin, so the kernel route
("pallas", which "auto" picks on a CUDA tensor) is the twins' arithmetic:
the per-level sums of ops/kernels/windowed.py in f64, scored as the kernels'
are.  Bars: against JAX's jnp entries (compiled once, with the interpret-mode
Pallas route at the same tiny shape, in a module fixture)
tests/test_torch_quality.py's SSIM bar 1e-5; the kernel route against the
plain one 1e-6; the strips against the unsharded call 1e-6; XPSNR's grids
bit for bit everywhere.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from turbo_metrics_tpu.ops import quality as jq
from turbo_metrics_tpu.ops import xpsnr_ops as jx

from turbo_metrics_tpu_torch.ops import quality as tq
from turbo_metrics_tpu_torch.ops import xpsnr_ops as tx
from turbo_metrics_tpu_torch.ops.kernels import windowed, windowed_tail
from turbo_metrics_tpu_torch.ops.kernels import xpsnr as kx
from turbo_metrics_tpu_torch.parallel import mesh

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

# tests/test_torch_quality.py: the port vs the JAX functions.
SSIM_ATOL = 1e-5
# The kernel route (its twins here) vs the plain chain, and strips vs the
# unsharded call: f32 sums of a different grouping.
ROUTE_ATOL = 1e-6
CPU = functools.partial(mesh.make_mesh, device="cpu")
ENTRIES = {"ssim": tq.ssim, "msssim": tq.msssim, "ssim_msssim": tq.ssim_msssim}
# (B, 3, h, w) held against the JAX package: two MS-SSIM levels.
JAX_SHAPE = (2, 3, 24, 40)


def _codes(seed, shape, noise=9):
    """A pair of f32 code values in [0, 255]: a sinusoid with noise, and a
    noisy copy."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.clip(np.round(128 + 80 * np.sin(xx / 7) * np.cos(yy / 5) + rng.normal(0, 6, shape)), 0, 255)
    b = np.clip(a + rng.integers(-noise, noise + 1, shape), 0, 255)
    return torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32))


def _luma(seed, b, h, w, depth):
    """(B, h, w) y_ref, y_dis and y_prev at ``depth`` bits (uint8 at 8, else
    uint16)."""
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth == 8 else np.uint16
    return tuple(torch.from_numpy(rng.integers(0, 1 << depth, (b, h, w)).astype(dt)) for _ in range(3))


def _pairs(out):
    """An entry's result as a tuple of tensors."""
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture(scope="module")
def jax_scores():
    """The JAX package's ssim_msssim on a JAX_SHAPE pair by its jnp route and
    by its Pallas route in interpret mode (one compiled function)."""
    a, b = (t.numpy() for t in _codes(1, JAX_SHAPE))
    fn = jax.jit(lambda x, y: (jq.ssim_msssim(x, y, backend="jnp"), jq.ssim_msssim(x, y, backend="interpret")))
    (s, ms), (si, msi) = fn(a, b)
    return {"jnp": (np.asarray(s), np.asarray(ms)), "interpret": (np.asarray(si), np.asarray(msi))}


@pytest.mark.parametrize("jax_backend", ["jnp", "interpret"])
@pytest.mark.parametrize("backend", ["auto", "jnp", "pallas"])
def test_entries_match_jax(jax_scores, jax_backend, backend):
    """ssim, msssim and ssim_msssim by every backend name the port takes
    against JAX's jnp route and its interpret-mode Pallas route."""
    a, b = _codes(1, JAX_SHAPE)
    want_s, want_ms = jax_scores[jax_backend]
    s, ms = tq.ssim_msssim(a, b, backend=backend)
    for got, want in ((s, want_s), (ms, want_ms), (tq.ssim(a, b, backend=backend), want_s),
                      (tq.msssim(a, b, backend=backend), want_ms)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SSIM_ATOL)


def _count_launches(monkeypatch):
    """Calls of the kernel wrappers #11 and #12 (here their twins), by name."""
    calls = {"ssim_sums": 0, "msssim_tail": 0}
    for mod, name in ((windowed, "ssim_sums"), (windowed_tail, "msssim_tail")):
        real = getattr(mod, name)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("shape,levels", [((2, 3, 67, 99), 3), ((1, 3, 176, 200), 5), ((2, 2, 3, 40, 48), 2)])
def test_routes(monkeypatch, entry, shape, levels):
    """"pallas" takes the kernel route (#11 once, #12 once where MS-SSIM
    has more than one level), "jnp" and "auto" on a CPU tensor the plain
    chain; the leading dims are flattened for the kernels and restored; the
    routes agree within 1e-6."""
    fn = ENTRIES[entry]
    a, b = _codes(shape[-1], shape)
    calls = _count_launches(monkeypatch)
    plain = _pairs(fn(a, b, backend="jnp"))
    assert calls == {"ssim_sums": 0, "msssim_tail": 0}
    assert all(torch.equal(x, y) for x, y in zip(_pairs(fn(a, b)), plain))
    assert calls == {"ssim_sums": 0, "msssim_tail": 0}
    kern = _pairs(fn(a, b, backend="pallas"))
    assert calls == {"ssim_sums": 1, "msssim_tail": int(entry != "ssim" and levels > 1)}
    assert tq._clamp_levels(shape[-2], shape[-1], 5)[0] == levels
    for k, p in zip(kern, plain):
        assert k.shape == p.shape == shape[:-3] and k.dtype == torch.float32
        np.testing.assert_allclose(k.numpy(), p.numpy(), rtol=0, atol=ROUTE_ATOL)


def test_gates_and_backend_names(monkeypatch):
    """JAX's gate: three channels and both dims at least 11 take the
    kernels, anything else the plain chain even under "pallas"; "auto" is
    the kernels on cuda and the plain chain elsewhere; a name the port
    cannot honour (JAX's "interpret") raises, listing the names it takes."""
    calls = _count_launches(monkeypatch)
    for shape in ((2, 1, 40, 48), (2, 3, 40, 10), (2, 4, 20, 20)):
        a, b = _codes(3, shape)
        for fn in ENTRIES.values():
            got, want = _pairs(fn(a, b, backend="pallas")), _pairs(fn(a, b, backend="jnp"))
            assert all(torch.allclose(x, y, rtol=0, atol=0, equal_nan=True) for x, y in zip(got, want))
    assert calls == {"ssim_sums": 0, "msssim_tail": 0}
    assert tq.resolve_backend("auto", "cpu") == "jnp" and tq.resolve_backend("auto", "cuda") == "pallas"
    assert tq.kernel_ok(torch.zeros(3, 11, 11), "pallas") and not tq.kernel_ok(torch.zeros(3, 11, 11), "auto")
    a, b = _codes(3, (1, 3, 16, 16))
    for name in ("interpret", "pallas3", "tpu"):
        for fn in ENTRIES.values():
            with pytest.raises(ValueError, match="one of"):
                fn(a, b, backend=name)
        with pytest.raises(ValueError, match="one of"):
            tx.xpsnr_block_stats(*_luma(1, 1, 16, 16, 8), backend=name)


@pytest.mark.parametrize("depth", [8, 10])
def test_xpsnr_per_frame_prev_matches_jax(depth):
    """xpsnr_block_stats with every frame's own previous plane: the plain
    route ("auto" on the CPU, "jnp") and the kernel route ("pallas": #13's
    twin with ``prev``) bit-equal to the JAX package's jnp entry; with
    y_prev[b] = y_ref[b-1] the kernel wrapper's ``prev0`` convention gives
    the same grids."""
    y, d, p = _luma(depth, 3, 33, 99, depth)
    want = jx.xpsnr_block_stats(y.numpy(), d.numpy(), p.numpy(), depth=depth, backend="jnp")
    for backend in (None, "auto", "jnp", "pallas"):
        got = tx.xpsnr_block_stats(y, d, p, depth=depth, backend=backend)
        assert list(got) == ["sse", "sact", "tact"]
        for q in got:
            assert got[q].dtype == torch.int64
            np.testing.assert_array_equal(got[q].numpy(), np.asarray(want[q]).astype(np.int64), err_msg=q)
    prev = torch.cat([p[:1], y[:-1]])
    conv, per_frame = kx.xpsnr_block_stats(y, d, p[0].contiguous()), kx.xpsnr_block_stats(y, d, prev=prev)
    assert all(torch.equal(conv[q], per_frame[q]) for q in conv)


def test_xpsnr_gates(monkeypatch):
    """#13 is taken for 16x16 blocks of (B, h, w) planes of its types with
    y_prev of y_ref's type, at any size and depth; otherwise the plain
    version runs, with the same grids; exactly one of prev0 and prev."""
    calls = []
    real = kx.xpsnr_block_stats
    monkeypatch.setattr(kx, "xpsnr_block_stats", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    y, d, p = _luma(5, 2, 17, 15, 8)
    for args, kw, kernel in (((y, d, p), {}, True), ((y, d, p), {"block": 8}, False),
                             ((y, d, p.to(torch.int32)), {}, False), ((y[None], d[None], p[None]), {}, False),
                             ((y.to(torch.int32), d, p.to(torch.int32)), {"depth": 16}, True)):
        calls.clear()
        got = tx.xpsnr_block_stats(*args, backend="pallas", **kw)
        want = tx.xpsnr_block_stats(*args, backend="jnp", **kw)
        assert bool(calls) == kernel and all(torch.equal(got[q], want[q]) for q in want)
    with pytest.raises(ValueError, match="exactly one"):
        kx.xpsnr_block_stats(y, d, p[0].contiguous(), prev=p)
    with pytest.raises(ValueError, match="exactly one"):
        kx.xpsnr_block_stats(y, d)
    with pytest.raises(ValueError, match="prev must be"):
        kx.xpsnr_block_stats(y, d, prev=p[:1])
    with pytest.raises(ValueError, match="depth"):
        tx.xpsnr_block_stats(y, d, p, depth=17)


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("backend", ["auto", "jnp", "pallas"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_entries_sharded_match_unsharded(entry, backend, n):
    """ssim, msssim and ssim_msssim over n strips at an odd width within
    1e-6 of the unsharded call, shapes and types equal (MS-SSIM's three
    levels at 48 rows: owned edges on multiples of 4, a halo of 20)."""
    fn = functools.partial(ENTRIES[entry], backend=backend)
    a, b = _codes(n, (2, 3, 48, 259))
    want = _pairs(fn(a, b))
    got = _pairs(mesh.shard_over_width(fn, CPU(n), in_ndims=(4, 4))(a, b))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=ROUTE_ATOL)


@pytest.mark.parametrize("depth,backend,n", [(8, None, 2), (8, "pallas", 3), (10, "jnp", 4), (10, "pallas", 4)])
def test_xpsnr_sharded_matches_unsharded(depth, backend, n):
    """The plain XPSNR statistics over n strips (y_prev cut like y_ref) at
    an odd width: every grid bit-equal to the unsharded call's."""
    y, d, p = _luma(depth + n, 2, 33, 259, depth)
    fn = functools.partial(tx.xpsnr_block_stats, depth=depth, backend=backend, block=16)
    want = fn(y, d, p)
    got = mesh.shard_over_width(fn, CPU(n), in_ndims=(3, 3, 3))(y, d, p)
    assert list(got) == list(want) and all(torch.equal(got[q], want[q]) for q in want)


def test_msssim_halo_is_tight():
    """The strips of MS-SSIM's plan, by hand: a halo of H - A columns gives a
    score apart from the unsharded one, the plan's own halo does not."""
    a, b = _codes(7, (1, 3, 176, 512), noise=60)
    lv = tq._clamp_levels(176, 512, 5)[0]
    want = tq.msssim(a, b, backend="pallas").double()
    win = tq._window(torch.device("cpu"))
    for halo, close in ((mesh.strip_halo(lv) - mesh.strip_alignment(lv), False), (mesh.strip_halo(lv), True)):
        plan = mesh.spatial_sharding(CPU(4), 512, num_scales=lv, halo=halo)
        sums = None
        for s in plan:
            p12 = torch.stack([a[..., s.lo:s.hi], b[..., s.lo:s.hi]])
            part = [t.double() for t in tq.level_sums(p12, win, lv, quantize=False, columns=s.columns)]
            sums = part if sums is None else [x + y for x, y in zip(sums, part)]
        per_level = [tq.means_from_sums(t.float(), 176 >> li, 512 >> li) for li, t in enumerate(sums)]
        got = tq._msssim_combine(per_level, tq._clamp_levels(176, 512, 5)[1]).double()
        assert (float((got - want).abs().max()) <= ROUTE_ATOL) == close, halo


def test_plain_width_errors():
    """TypeError for a keyword the entries do not take and a positional
    binding; ValueError for a backend name the port cannot honour, the wrong
    dims, a frame off the kernels' gate, too narrow a width and XPSNR blocks
    other than 16; a mesh of one runs the entry unchanged."""
    m4 = CPU(4)
    with pytest.raises(TypeError, match="no keywords"):
        mesh.shard_over_width(functools.partial(tq.ssim, levels=3), m4, in_ndims=(4, 4))
    with pytest.raises(TypeError, match="keywords only"):
        mesh.shard_over_width(functools.partial(tq.msssim, torch.zeros(1, 3, 16, 16)), m4, in_ndims=(4,))
    with pytest.raises(ValueError, match="one of"):
        mesh.shard_over_width(functools.partial(tq.msssim, backend="interpret"), m4, in_ndims=(4, 4))
    with pytest.raises(ValueError, match="dims"):
        mesh.shard_over_width(tq.ssim_msssim, m4, in_ndims=(5,))
    with pytest.raises(ValueError, match="block=16"):
        mesh.shard_over_width(functools.partial(tx.xpsnr_block_stats, block=8), m4, in_ndims=(3, 3, 3))
    with pytest.raises(ValueError, match="dims"):
        mesh.shard_over_width(tx.xpsnr_block_stats, m4, in_ndims=(3, 3, 2))
    with pytest.raises(ValueError, match="at least 11"):
        mesh.shard_over_width(tq.ssim, m4, in_ndims=(4, 4))(*_codes(1, (1, 1, 40, 256)))
    # 48 rows keep three MS-SSIM levels: owned edges on multiples of 4.
    with pytest.raises(ValueError, match="at least 64"):
        mesh.shard_over_width(tq.msssim, CPU(16), in_ndims=(4, 4))(*_codes(1, (1, 3, 48, 60)))
    a, b = _codes(2, (1, 3, 40, 64))
    for fn in ENTRIES.values():
        got, want = mesh.shard_over_width(fn, CPU(1), in_ndims=(4, 4))(a, b), fn(a, b)
        assert all(torch.equal(x, y) for x, y in zip(_pairs(got), _pairs(want)))
