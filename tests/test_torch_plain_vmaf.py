"""The port's plain VMAF-feature and conversion entries on their kernels
(ops/vif.py ``vif_scale_stats`` and ops/adm.py ``adm_stats`` with ``backend``,
``integer`` and ``depth``; ops/vmaf_motion.py ``integer_blur`` and
``motion_stats`` with ``backend``, #16 with every frame's own previous
plane; ops/colorspace.py ``yuv420_to_linear_rgb`` with ``backend``; the
routes of ops/routes.py), their width sharding (parallel/mesh.py
``shard_over_width``), and the last keywords of the JAX signatures
(``pq_eotf``'s nits, ``linear_rgb_to_xyb``'s ``channel_axis``, the
SSIMULACRA2 entries' ``needs``), on the CPU.

On the CPU every kernel wrapper runs its plain twin, so the kernel route
("pallas", which None and "auto" pick on a CUDA tensor) is the twins'
arithmetic: it equals the "jnp" route bit for bit here.  Bars: the strips
against the unsharded call rel 1e-6 (VIF, ADM; f32 sums of another
grouping), motion bit for bit; against the JAX package, the conversion and
the XYB transform at tests/test_torch_ops.py's bars, PQ with its note there,
motion and the masks bit for bit.  The VIF, ADM and integer routes are held
against JAX's jnp entries in tests/test_torch_vmaf.py and
tests/test_torch_integer.py, beside the JAX results those files compile.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turbo_metrics_tpu.models import ssimulacra2 as j_s2
from turbo_metrics_tpu.ops import colorspace as j_cs
from turbo_metrics_tpu.ops import vmaf_motion as j_mot
from turbo_metrics_tpu.ops import xyb as j_xyb

from turbo_metrics_tpu_torch.models import ssimulacra2 as t_s2
from turbo_metrics_tpu_torch.models.ssimulacra2_score import weight_needs
from turbo_metrics_tpu_torch.ops import adm as t_adm
from turbo_metrics_tpu_torch.ops import colorspace as t_cs
from turbo_metrics_tpu_torch.ops import routes
from turbo_metrics_tpu_torch.ops import vif as t_vif
from turbo_metrics_tpu_torch.ops import vmaf_motion as t_mot
from turbo_metrics_tpu_torch.ops import xyb as t_xyb
from turbo_metrics_tpu_torch.ops.downscale import scale_dims
from turbo_metrics_tpu_torch.ops.kernels import adm as k_adm
from turbo_metrics_tpu_torch.ops.kernels import convert as k_convert
from turbo_metrics_tpu_torch.ops.kernels import integer_adm as k_iadm
from turbo_metrics_tpu_torch.ops.kernels import integer_vif as k_ivif
from turbo_metrics_tpu_torch.ops.kernels import motion as k_mot
from turbo_metrics_tpu_torch.ops.kernels import vif as k_vif
from turbo_metrics_tpu_torch.parallel import mesh

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

# tests/test_torch_ops.py: the port vs the JAX functions.
RTOL, ATOL = 2e-5, 2e-6
# Strips against the unsharded call: f32 sums of another grouping.
STRIP_RTOL = 1e-6
SHAPES = [(2, 40, 56), (2, 33, 67)]
CPU = functools.partial(mesh.make_mesh, device="cpu")
# The kernel wrappers the entries route to, by the name the counts use.
WRAPPERS = {"#14/#15": (k_vif, "vif_scale_stats"), "K-int-VIF": (k_ivif, "integer_vif_stats"),
            "#18": (k_adm, "adm_stats"), "K-int-ADM": (k_iadm, "integer_adm_stats"),
            "#16": (k_mot, "motion_stats"), "#17": (k_mot, "integer_blur"), "#5": (k_convert, "yuv_to_linear_rgb")}


def _codes(seed, shape, depth=8):
    """A (reference, distorted) pair of luma codes at ``depth`` bits (uint8
    at 8, else uint16): a sinusoid with noise, and a noisy copy."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    top = (1 << depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    ref = np.clip(np.round(top * (0.5 + 0.3 * np.sin(xx / 5) * np.cos(yy / 4)) + rng.normal(0, top / 60, shape)), 0,
                  top)
    dis = np.clip(ref + rng.integers(-(top >> 5), (top >> 5) + 1, shape), 0, top)
    dt = np.uint8 if depth == 8 else np.uint16
    return torch.from_numpy(ref.astype(dt)), torch.from_numpy(dis.astype(dt))


def _planes(seed, shape, dt=np.uint16):
    """Random planes of ``shape`` (the previous blurred frames: any uint16)."""
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 1 << 16, shape).astype(dt))


def _count(monkeypatch) -> dict:
    """Calls of each kernel wrapper (here running its twin), by name."""
    calls = dict.fromkeys(WRAPPERS, 0)
    for name, (mod, attr) in WRAPPERS.items():
        real = getattr(mod, attr)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(mod, attr, counted)
    return calls


def _tensors(out) -> list:
    return list(out.values()) if isinstance(out, dict) else [out]


def _entries(shape):
    """(name, call of a backend, the wrapper its kernel route launches) for
    every plain entry on inputs of ``shape``."""
    r8, d8 = _codes(shape[-1], shape)
    r10, d10 = _codes(shape[-1] + 1, shape, depth=10)
    rf, df = r8.float(), d8.float()
    prev = _planes(shape[-2], shape)
    return [
        ("VIF", lambda b: t_vif.vif_scale_stats(rf, df, backend=b), "#14/#15"),
        ("VIF integer 8-bit", lambda b: t_vif.vif_scale_stats(r8, d8, integer=True, backend=b), "K-int-VIF"),
        ("VIF integer 10-bit", lambda b: t_vif.vif_scale_stats(r10, d10, integer=True, depth=10, backend=b),
         "K-int-VIF"),
        ("ADM", lambda b: t_adm.adm_stats(rf, df, backend=b), "#18"),
        ("ADM integer 8-bit", lambda b: t_adm.adm_stats(r8, d8, integer=True, backend=b), "K-int-ADM"),
        ("ADM integer 10-bit", lambda b: t_adm.adm_stats(r10, d10, integer=True, depth=10, backend=b), "K-int-ADM"),
        ("integer_blur", lambda b: t_mot.integer_blur(r10, depth=10, backend=b), "#17"),
        ("motion_stats", lambda b: t_mot.motion_stats(r8, prev, backend=b), "#16"),
    ]


@pytest.mark.parametrize("shape", SHAPES)
def test_routes_match_jnp(monkeypatch, shape):
    """Each entry's kernel route ("pallas": its wrapper called once) equals
    its "jnp" route bit for bit; None and "auto" on a CPU tensor take the
    plain route (no wrapper called)."""
    calls = _count(monkeypatch)
    for name, call, wrapper in _entries(shape):
        want = _tensors(call("jnp"))
        for backend in (None, "auto"):
            assert all(torch.equal(g, w) for g, w in zip(_tensors(call(backend)), want)), (name, backend)
        assert not any(calls.values()), name
        got = _tensors(call("pallas"))
        assert calls[wrapper] == 1 and sum(calls.values()) == 1, (name, calls)
        calls[wrapper] = 0
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("chroma", [420, 422, 444])
@pytest.mark.parametrize("depth", [8, 10])
def test_conversion_backend_matches_jax(monkeypatch, chroma, depth):
    """yuv420_to_linear_rgb by every backend name against JAX's (its "auto"
    on the CPU is jnp): #5 on the kernel route, for every subsampling."""
    calls = _count(monkeypatch)
    rng = np.random.default_rng(depth + chroma)
    b, h, w = 2, 17, 23
    dt = np.uint8 if depth == 8 else np.uint16
    y = rng.integers(0, 1 << depth, (b, h, w)).astype(dt)
    uv = rng.integers(0, 1 << depth, (b, *t_cs.chroma_dims(chroma, h, w), 2)).astype(dt)
    kw = dict(depth=depth, matrix="bt709" if depth == 8 else "bt2020", transfer="srgb", chroma=chroma)
    want = np.asarray(j_cs.yuv420_to_linear_rgb(jnp.asarray(y), jnp.asarray(uv), **kw))
    plain = t_cs.yuv420_to_linear_rgb(torch.from_numpy(y), torch.from_numpy(uv), **kw, backend="jnp")
    for backend in (None, "auto", "jnp", "pallas"):
        got = t_cs.yuv420_to_linear_rgb(torch.from_numpy(y), torch.from_numpy(uv), **kw, backend=backend)
        assert got.shape == (b, 3, h, w) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        assert torch.equal(got, plain)
    assert calls["#5"] == 1 and sum(calls.values()) == 1


def test_gates(monkeypatch):
    """Under "pallas" a call off JAX's gate (a side under 32, planes not
    (B, h, w)), a type the kernels do not take or ADM's
    plain ``windows`` takes the plain route: no wrapper called, the "jnp"
    route's result."""
    calls = _count(monkeypatch)
    r, d = _codes(1, (2, 31, 64))
    rw, dw = _codes(2, (2, 40, 64))
    prev = _planes(3, (2, 40, 64))
    windows = t_adm.level_windows(64)
    cases = [
        ("VIF, a side of 31", t_vif.vif_scale_stats, (r.float(), d.float()), {}),
        ("VIF, 2-D planes", t_vif.vif_scale_stats, (rw[0].float(), dw[0].float()), {}),
        ("VIF, 4-D planes", t_vif.vif_scale_stats, (rw[None].float(), dw[None].float()), {}),
        ("VIF integer, 2-D planes", t_vif.vif_scale_stats, (rw[0], dw[0]), {"integer": True}),
        ("ADM, a side of 31", t_adm.adm_stats, (r.float(), d.float()), {}),
        ("ADM, windows", t_adm.adm_stats, (rw.float(), dw.float()), {"windows": windows}),
        ("ADM integer, windows", t_adm.adm_stats, (rw, dw), {"integer": True, "windows": windows}),
        ("ADM integer, 4-D planes", t_adm.adm_stats, (rw[None], dw[None]), {"integer": True}),
        ("blur, a side of 31", t_mot.integer_blur, (r,), {}),
        ("blur, int64 luma", t_mot.integer_blur, (rw.to(torch.int64),), {}),
        ("blur, 2-D plane", t_mot.integer_blur, (rw[0],), {}),
        ("motion, int16 luma", t_mot.motion_stats, (rw.to(torch.int16), prev), {}),
        ("motion, int32 previous planes", t_mot.motion_stats, (rw, prev.to(torch.int32)), {}),
        ("motion, (1, h, w) previous planes", t_mot.motion_stats, (rw, prev[:1]), {}),
    ]
    for what, fn, args, kw in cases:
        got, want = fn(*args, **kw, backend="pallas"), fn(*args, **kw, backend="jnp")
        assert all(torch.equal(g, w) for g, w in zip(_tensors(got), _tensors(want))), what
        assert not any(calls.values()), (what, calls)
    y8 = torch.randint(0, 256, (2, 2, 16, 20), dtype=torch.uint8)
    uv8 = torch.randint(0, 256, (2, 2, 8, 10, 2), dtype=torch.uint8)
    for what, y, uv, kw in (("conversion, a (2, B, h, w) pair", y8, uv8, {}),
                            ("conversion, uint16 at 8 bits", y8[0].to(torch.int32).to(torch.uint16),
                             uv8[0].to(torch.int32).to(torch.uint16), {}),
                            ("conversion, int32 at 10 bits", y8[0].to(torch.int32), uv8[0].to(torch.int32),
                             {"depth": 10})):
        got = t_cs.yuv420_to_linear_rgb(y, uv, **kw, backend="pallas")
        assert torch.equal(got, t_cs.yuv420_to_linear_rgb(y, uv, **kw, backend="jnp")), what
        assert not any(calls.values()), (what, calls)
    # One (h, w) previous plane for every frame: #16 with a batch stride of 0.
    got = t_mot.motion_stats(rw, prev[0], backend="pallas")
    assert calls["#16"] == 1
    want = t_mot.motion_stats(rw, prev[0], backend="jnp")
    assert all(torch.equal(got[q], want[q]) for q in want)


def test_backend_names():
    """None and "auto" are the kernels on cuda and the plain route elsewhere;
    a name the port cannot honour (JAX's "interpret") raises, listing the
    names it takes, on every entry and under width sharding."""
    assert routes.kernel_route(None, "cuda") and routes.kernel_route("auto", "cuda:0")
    assert not routes.kernel_route(None, "cpu") and not routes.kernel_route("jnp", "cuda")
    assert routes.kernel_route("pallas", "cpu")
    r, d = _codes(4, (1, 8, 8))
    uv = torch.zeros((1, 4, 4, 2), dtype=torch.uint8)
    calls = [lambda b: t_vif.vif_scale_stats(r.float(), d.float(), backend=b),
             lambda b: t_vif.vif_scale_stats(r, d, integer=True, backend=b),
             lambda b: t_adm.adm_stats(r.float(), d.float(), backend=b),
             lambda b: t_adm.adm_stats(r, d, integer=True, backend=b),
             lambda b: t_mot.integer_blur(r, backend=b),
             lambda b: t_mot.motion_stats(r, _planes(1, (1, 8, 8)), backend=b),
             lambda b: t_cs.yuv420_to_linear_rgb(r, uv, backend=b)]
    for name in ("interpret", "pallas3", "tpu"):
        for call in calls:
            with pytest.raises(ValueError, match="one of"):
                call(name)
        for fn in (t_vif.vif_scale_stats, t_adm.adm_stats, t_mot.motion_stats):
            with pytest.raises(ValueError, match="one of"):
                mesh.shard_over_width(functools.partial(fn, backend=name), CPU(2), in_ndims=(3, 3))


@pytest.mark.parametrize("dt", [np.float32, np.int16, np.int64])
@pytest.mark.parametrize("depth", [8, 10])
def test_integer_codes_cast_as_jax(monkeypatch, dt, depth):
    """Codes in a type that K-int-VIF and K-int-ADM do not take (f32 code
    values, here with fractions; int16; int64) are cast as the JAX package
    casts them, to uint32 truncating, then narrowed to uint8 (8 bits) or
    uint16: the kernel route's pair holds JAX's cast values, and its sums
    equal the plain route's on the same inputs."""
    calls = _count(monkeypatch)
    r, d = _codes(depth, (2, 40, 56), depth)
    frac = 0.75 if dt == np.float32 else 0
    ref, dis = (torch.from_numpy(t.numpy().astype(dt) + dt(frac)) for t in (r, d))
    pair = routes.code_pair(ref, dis, depth)
    assert pair.dtype == (torch.uint8 if depth == 8 else torch.uint16) and pair.is_contiguous()
    for got, t in zip(pair, (ref, dis)):
        want = np.asarray(jnp.asarray(t.numpy()).astype(jnp.uint32))
        np.testing.assert_array_equal(got.to(torch.int64).numpy(), want)
    assert torch.equal(routes.code_pair(r, d, depth), torch.stack([r, d]))
    for fn in (t_vif.vif_scale_stats, t_adm.adm_stats):
        got = fn(ref, dis, integer=True, depth=depth, backend="pallas")
        assert torch.equal(got, fn(ref, dis, integer=True, depth=depth, backend="jnp"))
        assert torch.equal(got, fn(r, d, integer=True, depth=depth, backend="jnp"))
    assert calls["K-int-VIF"] == calls["K-int-ADM"] == 1


@pytest.mark.parametrize("depth", [8, 10])
def test_motion_per_frame_prev_matches_jax(depth):
    """#16 with every frame's own previous plane (``prev``; none of them
    frame b-1's blur): its twin bit-equal to the plain entry and to the JAX
    package's jnp motion_stats, eager, and to the kernel route; the
    ``prev0`` convention is ``prev`` = [prev0, blur of frames 0 .. B-2];
    one plane for every frame (a batch stride of 0); exactly one of the
    two."""
    y, _ = _codes(depth + 5, (3, 40, 56), depth)
    prev = _planes(depth, (3, 40, 56))
    want = j_mot.motion_stats(jnp.asarray(y.numpy()), jnp.asarray(prev.numpy()), depth=depth, backend="jnp")
    got = k_mot.motion_stats(y, prev=prev, depth=depth)
    for q in ("blurred", "sad_rows"):
        np.testing.assert_array_equal(got[q].numpy().astype(np.int64), np.asarray(want[q]).astype(np.int64))
    np.testing.assert_array_equal(t_mot.integer_blur(y, depth=depth, backend="pallas").numpy(),
                                  np.asarray(j_mot.integer_blur(jnp.asarray(y.numpy()), depth=depth)))
    for backend in (None, "pallas"):
        out = t_mot.motion_stats(y, prev, depth=depth, backend=backend)
        assert all(torch.equal(out[q], got[q]) for q in got), backend
    chained = k_mot.motion_stats(y, prev[0].contiguous(), depth=depth)
    per_frame = k_mot.motion_stats(y, prev=torch.cat([prev[:1], got["blurred"][:-1]]), depth=depth)
    assert all(torch.equal(chained[q], per_frame[q]) for q in chained)
    one = k_mot.motion_stats(y, prev=prev[1].expand(y.shape), depth=depth)
    want_one = t_mot.motion_stats(y, prev[1], depth=depth, backend="jnp")
    assert all(torch.equal(one[q], want_one[q]) for q in one)
    with pytest.raises(ValueError, match="exactly one"):
        k_mot.motion_stats(y, prev[0].contiguous(), prev=prev)
    with pytest.raises(ValueError, match="exactly one"):
        k_mot.motion_stats(y)
    with pytest.raises(ValueError, match="prev must be"):
        k_mot.motion_stats(y, prev=prev.to(torch.int32))


def _sharded_cases():
    """(name, entry, inputs, in_ndims, exact) of the plain entries on a
    (2, 33, 131) frame: an odd width."""
    shape = (2, 33, 131)
    r8, d8 = _codes(7, shape)
    r10, d10 = _codes(8, shape, depth=10)
    prev = _planes(9, shape)
    return [
        ("VIF", t_vif.vif_scale_stats, (r8.float(), d8.float()), (3, 3), False),
        ("VIF jnp", functools.partial(t_vif.vif_scale_stats, backend="jnp"), (r8.float(), d8.float()), (3, 3), False),
        ("VIF integer 10-bit", functools.partial(t_vif.vif_scale_stats, integer=True, depth=10, backend="pallas"),
         (r10, d10), (3, 3), False),
        ("ADM", functools.partial(t_adm.adm_stats, backend="pallas"), (r8.float(), d8.float()), (3, 3), False),
        ("ADM jnp", functools.partial(t_adm.adm_stats, backend="jnp"), (r8.float(), d8.float()), (3, 3), False),
        ("ADM integer 8-bit", functools.partial(t_adm.adm_stats, integer=True, backend="pallas"), (r8, d8), (3, 3),
         False),
        ("ADM integer 10-bit jnp", functools.partial(t_adm.adm_stats, integer=True, depth=10, backend="jnp"),
         (r10, d10), (3, 3), False),
        ("motion_stats", functools.partial(t_mot.motion_stats, backend="pallas"), (r8, prev), (3, 3), True),
        ("motion_stats jnp, one previous plane", functools.partial(t_mot.motion_stats, depth=10, backend="jnp"),
         (r10, prev[0]), (3, 2), True),
        ("integer_blur", functools.partial(t_mot.integer_blur, depth=10), (r10,), (3,), True),
    ]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_plain_entries_sharded_match_unsharded(n):
    """The plain entries over n strips of an odd width: VIF's and ADM's sums
    within rel 1e-6 of the unsharded call, motion's planes and row SADs and
    the blur bit for bit (the per-frame previous planes cut like the luma),
    shapes and types equal."""
    for name, fn, args, ndims, exact in _sharded_cases():
        want = _tensors(fn(*args))
        got = _tensors(mesh.shard_over_width(fn, CPU(n), in_ndims=ndims)(*args))
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if exact:
                assert torch.equal(g, w), name
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=STRIP_RTOL, atol=0, err_msg=name)


def test_plain_sharding_errors():
    """TypeError for a keyword the strip loops do not take (the plain
    entries' ``columns`` and ``windows``, which the strips set) and a
    positional binding; ValueError for the wrong dims; a mesh of one runs
    the entry unchanged."""
    m4 = CPU(4)
    for fn, kw in ((t_vif.vif_scale_stats, {"columns": (0, 8)}), (t_adm.adm_stats, {"windows": None}),
                   (t_mot.motion_stats, {"columns": (0, 8)})):
        with pytest.raises(TypeError, match="no keywords"):
            mesh.shard_over_width(functools.partial(fn, **kw), m4, in_ndims=(3, 3))
    with pytest.raises(TypeError, match="keywords only"):
        mesh.shard_over_width(functools.partial(t_adm.adm_stats, torch.zeros(1, 8, 64)), m4, in_ndims=(3,))
    for fn, nd in ((t_vif.vif_scale_stats, (4,)), (t_adm.adm_stats, (3,)), (t_mot.motion_stats, (3,)),
                   (t_mot.integer_blur, (3, 3))):
        with pytest.raises(ValueError, match="dims"):
            mesh.shard_over_width(fn, m4, in_ndims=nd)
    r, d = _codes(3, (1, 40, 64))
    for fn, args in ((t_vif.vif_scale_stats, (r.float(), d.float())), (t_adm.adm_stats, (r.float(), d.float())),
                     (t_mot.motion_stats, (r, _planes(2, (1, 40, 64))))):
        got = mesh.shard_over_width(fn, CPU(1), in_ndims=(3, 3))(*args)
        assert all(torch.equal(g, w) for g, w in zip(_tensors(got), _tensors(fn(*args))))


def test_pq_nits_match_jax():
    """pq_eotf with a peak and a normalisation other than 10000 nits against
    JAX's (PQ's tolerance: tests/test_torch_ops.py's note), scaled by their
    ratio; the defaults leave the curve as it was."""
    v = np.random.default_rng(5).uniform(-0.1, 1.1, (4, 64)).astype(np.float32)
    for peak, norm in ((1000.0, 203.0), (4000.0, 10000.0), (10000.0, 10000.0)):
        got = t_cs.pq_eotf(torch.from_numpy(v), peak_nits=peak, norm_nits=norm)
        want = np.asarray(j_cs.pq_eotf(jnp.asarray(v), peak_nits=peak, norm_nits=norm))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4 * peak / norm)
    base = t_cs.pq_eotf(torch.from_numpy(v))
    assert torch.equal(base, t_cs.pq_eotf(torch.from_numpy(v), peak_nits=10000.0, norm_nits=10000.0))
    assert torch.equal(t_cs.pq_eotf(torch.from_numpy(v), peak_nits=5000.0),
                       base * np.float32(0.5))


@pytest.mark.parametrize("layout,axis", [((2, 9, 11, 3), -1), ((3, 9, 11), 0), ((2, 3, 9, 11), 1)])
def test_channel_axis_matches_jax(layout, axis):
    """linear_rgb_to_xyb with the channels on another axis against JAX's,
    and equal to the default layout's result moved there."""
    rgb = np.random.default_rng(6).uniform(0, 1, layout).astype(np.float32)
    got = t_xyb.linear_rgb_to_xyb(torch.from_numpy(rgb), channel_axis=axis)
    want = np.asarray(j_xyb.linear_rgb_to_xyb(jnp.asarray(rgb), channel_axis=axis))
    assert got.shape == rgb.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    planar = torch.from_numpy(np.moveaxis(rgb, axis, -3).copy())
    assert torch.equal(torch.movedim(t_xyb.linear_rgb_to_xyb(planar), -3, axis), got)


def test_needs_masks_match_jax():
    """The SSIMULACRA2 entries' ``needs``: "auto" the zero weights of the
    pyramid (the default), None no mask, explicit per-scale masks; the mask
    of each bit-equal to the JAX package's; from the YUV and RGB entries and
    over strips, None keeps the sub-scores "auto" zeroes."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0.1, 1, (2, 3, 3, 2, 3)).astype(np.float32)
    odd = tuple(tuple(tuple(bool(v) for v in rng.integers(0, 2, 6)) for _ in range(3)) for _ in range(3))
    for needs in (None, weight_needs(3), odd):
        got = t_s2._apply_needs_mask(torch.from_numpy(x), needs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_s2._apply_needs_mask(jnp.asarray(x), needs)))
    assert t_s2.resolve_needs("auto", 3) == weight_needs(3) and t_s2.resolve_needs(None, 3) is None
    y2, _ = _codes(9, (2, 2, 40, 56))
    uv2 = torch.from_numpy(rng.integers(16, 241, (2, 2, 20, 28, 2)).astype(np.uint8))
    m = t_s2.Ssimulacra2(56, 40, device="cpu")
    assert m.batch == 1
    ns = len(scale_dims(40, 56))
    mask = torch.from_numpy(np.array(j_s2._apply_needs_mask(jnp.ones((3, ns, 2, 3), jnp.float32),
                                                             weight_needs(ns))))
    p12 = t_cs.yuv420_to_linear_rgb(y2, uv2).contiguous()
    yuv = functools.partial(t_s2.ssimulacra2_subscores_from_yuv, y2, uv2, m.taps, m.opsin, num_scales=ns)
    rgb = functools.partial(t_s2.ssimulacra2_subscores_from_rgb, p12, m.taps, m.opsin, num_scales=ns)
    for entry in (yuv, rgb):
        auto, none = entry(), entry(needs=None)
        assert torch.equal(entry(needs="auto"), auto) and torch.equal(entry(needs=weight_needs(ns)), auto)
        assert torch.equal(none * mask, auto) and bool((none * (1 - mask)).abs().sum() > 0)
    full = functools.partial(t_s2.ssimulacra2_subscores_from_yuv, taps=m.taps, opsin=m.opsin, num_scales=ns,
                             needs=None)
    got = mesh.shard_over_width(full, CPU(2), in_ndims=(4, 5))(y2, uv2)
    np.testing.assert_allclose(got.numpy(), yuv(needs=None).numpy(), rtol=2e-5, atol=2e-5)
