"""SSIMULACRA2 straight from packed integer sRGB (``fused_scale_srgb``,
the sRGB sibling of kernel 1) on the CPU.

The wrapper runs its plain twin here (the plain route it replaces for
SSIMULACRA2 alone: ``colorspace.srgb_pair_to_linear``, then #3's twin); the
kernel itself is held to that route bit for bit on the card by
chip_smoke.py (phase 15).  So the twin, the model entry and the engine's
SSIMULACRA2-only route are held against the JAX package: the JAX
``colorspace.srgb_to_linear`` and jnp ``ssimulacra2_subscores`` on
independent random codes at the kernel-vs-jnp tolerance rtol 2e-5 / atol
2e-6 (tests/test_torch_kernels.py), and the JAX engine on close frame pairs
at the score tolerance 1e-3 (tests/test_torch_formats.py).  The engine's
choice of route is read from spies on the model module's scale-0 wrappers.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from turbo_metrics_tpu import engine as jax_engine
from turbo_metrics_tpu.color.characteristics import height_fallback as jax_height_fallback
from turbo_metrics_tpu.io.frame_source import RawFrame as JaxRawFrame
from turbo_metrics_tpu.models.ssimulacra2 import ssimulacra2_subscores as jax_subscores
from turbo_metrics_tpu.ops import colorspace as j_cs
from turbo_metrics_tpu.ops.downscale import downscale_by_2 as jax_downscale

from turbo_metrics_tpu_torch import engine as port_engine
from turbo_metrics_tpu_torch.color.characteristics import (
    ColorCharacteristics,
    ColourPrimaries,
    MatrixCoefficients,
    TransferCharacteristic,
    height_fallback,
)
from turbo_metrics_tpu_torch.engine import ConvertSpec, Metrics, TurboMetrics
from turbo_metrics_tpu_torch.io.frame_source import RawFrame
from turbo_metrics_tpu_torch.models import ssimulacra2 as s2
from turbo_metrics_tpu_torch.models.ssimulacra2 import (
    Ssimulacra2,
    ssimulacra2_subscores_from_rgb,
    ssimulacra2_subscores_from_srgb,
    ssimulacra2_subscores_from_yuv,
    subscores_from_sums,
)
from turbo_metrics_tpu_torch.ops import colorspace
from turbo_metrics_tpu_torch.ops.kernels import scale_stats
from turbo_metrics_tpu_torch.utils import profiling

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
SRGB = (ColorCharacteristics(ColourPrimaries.BT709, MatrixCoefficients.BT709, TransferCharacteristic.SRGB), "full")
YUV = (ColorCharacteristics(ColourPrimaries.BT709, MatrixCoefficients.BT709, TransferCharacteristic.BT709), "limited")
# (type, depth): 8-bit codes, 16-bit codes, 10-bit codes in uint16.
CODES = [(torch.uint8, 8), (torch.uint16, 16), (torch.uint16, 10)]
CODE_IDS = ["uint8-8", "uint16-16", "uint16-10"]
SHAPES = [(37, 53), (48, 64)]  # odd (edge quads replicate), even


def _codes(seed, bsz, h, w, dtype, depth):
    """Seeded (reference, distorted) (B, h, w, 3) codes: a smooth base and
    the distorted image a few codes off it, every code in range."""
    rng = np.random.default_rng(seed)
    hi = (1 << depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([0.5 + 0.4 * np.sin(xx / 7.0) * np.cos(yy / 5.0), 0.5 + 0.3 * np.cos(xx / 3.0),
                     0.5 + 0.2 * np.sin((xx + yy) / 9.0)], axis=-1)
    ref = np.clip(np.round((base + rng.normal(0, 0.02, (bsz, h, w, 3))) * hi), 0, hi)
    dis = np.clip(ref + rng.integers(-9, 10, ref.shape) * max(hi // 255, 1), 0, hi)
    dt = np.uint8 if dtype == torch.uint8 else np.uint16
    return torch.from_numpy(ref.astype(dt)), torch.from_numpy(dis.astype(dt))


def _independent_codes(seed, bsz, h, w, dtype, depth):
    """Seeded independent, uniformly random (reference, distorted) codes:
    the SSIM quotients of the deep scales stay well conditioned in f32, so
    the JAX comparisons see the port's own error
    (tests/test_torch_kernels.py ``_yuv_pair``)."""
    gen = torch.Generator().manual_seed(seed)
    ref, dis = torch.randint(0, 1 << depth, (2, bsz, h, w, 3), generator=gen, dtype=torch.int32)
    return ref.to(dtype), dis.to(dtype)


def _jax_lin(ref, dis, depth):
    """The JAX package's linear light of the pair, (2, B, 3, h, w)."""
    codes = jnp.asarray(np.stack([ref.numpy(), dis.numpy()]))
    return np.asarray(j_cs.srgb_to_linear(codes, depth=depth)).transpose(0, 1, 4, 2, 3).copy()


@functools.lru_cache(maxsize=None)
def _jax_chain(num_scales):
    """The JAX jnp sub-scores, compiled once per number of scales."""
    return jax.jit(functools.partial(jax_subscores, num_scales=num_scales, backend="jnp"))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _consts():
    m = Ssimulacra2(64, 48, device="cpu")
    return m.taps, m.opsin


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("codes", CODES, ids=CODE_IDS)
def test_twin_matches_jax(codes, hw):
    """The wrapper's twin against the JAX sRGB conversion and jnp chain:
    scale 0's sub-scores and the emitted level 1."""
    dtype, depth = codes
    h, w = hw
    ref, dis = _independent_codes(1, 2, h, w, dtype, depth)
    lin = _jax_lin(ref, dis, depth)
    taps, opsin = _consts()
    sums, level1 = scale_stats.fused_scale_srgb(ref, dis, taps, opsin, None, depth=depth)
    assert sums.dtype == torch.float32 and sums.shape == (2, 3, 6)
    assert level1.shape == (2, 2, 3, (h + 1) // 2, (w + 1) // 2)
    _close(subscores_from_sums([sums], [(h, w)]), _jax_chain(1)(lin[0], lin[1]))
    _close(level1, jax_downscale(jnp.asarray(lin)))


@pytest.mark.parametrize("emit_ds", [False, True])
def test_twin_takes_emission(emit_ds):
    """Without ``emit_ds`` no level 1, and the same sums."""
    ref, dis = _codes(2, 1, 37, 53, torch.uint8, 8)
    taps, opsin = _consts()
    sums, level1 = scale_stats.fused_scale_srgb(ref, dis, taps, opsin, None, emit_ds=emit_ds)
    want_sums, want_level1 = scale_stats.fused_scale_rgb_ref(
        colorspace.srgb_pair_to_linear(ref, dis, depth=8), taps, opsin)
    assert torch.equal(sums, want_sums)
    assert (level1 is None) == (not emit_ds)
    if emit_ds:
        assert torch.equal(level1, want_level1)


@pytest.mark.parametrize("codes", CODES, ids=CODE_IDS)
def test_code_table_holds_each_code_conversion(codes):
    """Every entry of the code table is the plain conversion of its code,
    evaluated on the codes of the type as one contiguous run, and within
    the conversion tolerance of the JAX package's; 2^8 entries for uint8,
    2^16 for uint16 whatever the depth."""
    dtype, depth = codes
    table = scale_stats.code_table(dtype, depth, "cpu")
    n = 256 if dtype == torch.uint8 else 65536
    assert table.shape == (n,) and table.dtype == torch.float32 and table.is_contiguous()
    every = torch.randperm(n, generator=torch.Generator().manual_seed(5)).to(torch.int32)
    assert torch.equal(table[every.long()], colorspace.srgb_to_linear(every.to(dtype), depth=depth))
    assert table[0] == 0.0 and table[(1 << depth) - 1] == 1.0
    in_range = torch.arange(1 << depth, dtype=torch.int32)
    want = j_cs.srgb_to_linear(jnp.asarray(in_range.numpy().astype(np.uint8 if n == 256 else np.uint16)), depth=depth)
    np.testing.assert_allclose(table[: 1 << depth].numpy(), np.asarray(want), rtol=0, atol=3e-6)


@pytest.mark.parametrize("bsz, hw", [(1, (37, 53)), (2, (48, 64)), (2, (37, 53))])
@pytest.mark.parametrize("codes", CODES, ids=CODE_IDS)
def test_subscores_from_srgb_match_jax(codes, bsz, hw):
    """The model entry from codes, through the module's entry too, against
    the JAX sRGB conversion and jnp chain over the whole pyramid, and bit
    for bit against ``ssimulacra2_subscores_from_rgb`` on the plain route's
    pair buffer of the same codes."""
    dtype, depth = codes
    h, w = hw
    ref, dis = _independent_codes(3, bsz, h, w, dtype, depth)
    model = Ssimulacra2(w, h, device="cpu")
    lin = _jax_lin(ref, dis, depth)
    got = ssimulacra2_subscores_from_srgb(ref, dis, model.taps, model.opsin, model.code_table(dtype, depth),
                                          num_scales=model.num_scales, depth=depth)
    assert got.shape == (bsz, 3, model.num_scales, 2, 3) and got.dtype == torch.float32
    _close(got, _jax_chain(model.num_scales)(lin[0], lin[1]))
    assert torch.equal(model.subscores_from_srgb(ref, dis, depth=depth), got)
    p12 = colorspace.srgb_pair_to_linear(ref, dis, depth=depth)
    assert torch.equal(got, ssimulacra2_subscores_from_rgb(p12, model.taps, model.opsin, num_scales=model.num_scales))


def test_module_keeps_one_table_per_type_and_depth():
    """``Ssimulacra2.code_table`` builds each table once and hands the same
    tensor back; another type or depth is another table."""
    model = Ssimulacra2(64, 48, device="cpu")
    t8 = model.code_table(torch.uint8, 8)
    assert model.code_table(torch.uint8, 8) is t8
    others = [model.code_table(torch.uint16, 16), model.code_table(torch.uint16, 10), model.code_table(torch.uint8, 7)]
    assert all(t is not t8 for t in others)
    assert model.code_table(torch.uint16, 10) is others[1]
    assert torch.equal(t8, scale_stats.code_table(torch.uint8, 8, "cpu"))


@pytest.mark.parametrize("bad", ["float", "mixed", "channels", "shapes", "layout", "device", "depth"])
def test_wrapper_rejects_bad_inputs(bad):
    """Types, shapes, layouts, devices and depths are checked before any
    launch; a tensor on neither the CPU nor CUDA raises."""
    ref, dis = _codes(4, 1, 16, 20, torch.uint8, 8)
    taps, opsin = _consts()
    kw = {}
    if bad == "float":
        ref, dis = ref.float(), dis.float()
    elif bad == "mixed":
        dis = dis.to(torch.int32).to(torch.uint16)
    elif bad == "channels":
        ref, dis = ref[..., :2].contiguous(), dis[..., :2].contiguous()
    elif bad == "shapes":
        dis = dis[:, :-1].contiguous()
    elif bad == "layout":
        ref, dis = ref.transpose(1, 2), dis.transpose(1, 2)
    elif bad == "device":
        ref, dis, taps, opsin = ref.to("meta"), dis.to("meta"), taps.to("meta"), opsin.to("meta")
    else:
        kw["depth"] = 17
    with pytest.raises(ValueError):
        scale_stats.fused_scale_srgb(ref, dis, taps, opsin, None, **kw)


def test_code_table_rejects_other_types():
    with pytest.raises(ValueError):
        scale_stats.code_table(torch.int32, 8, "cpu")


def test_launches_stay_zero_on_cpu():
    """On CPU tensors the wrapper runs its twin: no launch counted."""
    scale_stats.fused_scale_srgb.launches = 0
    ref, dis = _codes(5, 1, 24, 32, torch.uint8, 8)
    model = Ssimulacra2(32, 24, device="cpu")
    model.subscores_from_srgb(ref, dis)
    assert scale_stats.fused_scale_srgb.launches == 0


# The engine's route, by the scale-0 wrapper each batch's step calls.
SPIED = ("fused_scale_srgb", "fused_scale_rgb", "fused_scale0_yuv")


def _spy(monkeypatch):
    calls = []
    for name in SPIED:
        fn = getattr(s2, name)

        def rec(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)

        monkeypatch.setattr(s2, name, rec)
    return calls


def _rgb_frames(seed, n, h, w, dtype=torch.uint8, depth=8, as_float=False):
    ref, dis = _codes(seed, n, h, w, dtype, depth)
    if as_float:
        ref, dis = ref.float() / 255.0, dis.float() / 255.0
    return ([RawFrame(rgb=f.numpy(), depth=depth) for f in ref], [RawFrame(rgb=f.numpy(), depth=depth) for f in dis])


def _yuv_frames(seed, n, h, w):
    rng = np.random.default_rng(seed)

    def frame(y):
        return RawFrame(y=y, uv=rng.integers(16, 241, ((h + 1) // 2, (w + 1) // 2, 2), dtype=np.uint8))

    ref = [rng.integers(16, 236, (h, w), dtype=np.uint8) for _ in range(n)]
    dis = [np.clip(y.astype(int) + rng.integers(-4, 5, y.shape), 0, 255).astype(np.uint8) for y in ref]
    return [frame(y) for y in ref], [frame(y) for y in dis]


@pytest.mark.parametrize("case, metrics, want", [
    ("srgb u8", {"ssimulacra2": True}, "fused_scale_srgb"),
    ("srgb u16", {"ssimulacra2": True}, "fused_scale_srgb"),
    ("srgb u8", {"ssimulacra2": True, "xpsnr": True}, "fused_scale_srgb"),
    ("srgb u8", {"ssimulacra2": True, "psnr": True}, "fused_scale_rgb"),
    ("float rgb", {"ssimulacra2": True}, "fused_scale_rgb"),
    ("yuv420", {"ssimulacra2": True}, "fused_scale0_yuv"),
])
def test_engine_picks_scale0_route(monkeypatch, case, metrics, want):
    """Packed integer RGB with SSIMULACRA2 as the only RGB family takes the
    codes straight into its first level pass, once a batch; the same pairs
    beside PSNR, and float RGB, keep the pair buffer and #3; YUV 4:2:0 pairs
    kernel 1."""
    h, w, n = 37, 53, 3
    if case == "yuv420":
        ref, dis = _yuv_frames(6, n, h, w)
        cc = YUV
    else:
        dtype, depth = (torch.uint16, 16) if case == "srgb u16" else (torch.uint8, 8)
        ref, dis = _rgb_frames(6, n, h, w, dtype, depth, as_float=case == "float rgb")
        cc = SRGB
    calls = _spy(monkeypatch)
    engine = TurboMetrics(w, h, Metrics(**metrics), batch=2, device="cpu")
    scores = engine.compute_frames(ref[:2], cc, dis[:2], cc) + engine.compute_frames(ref[2:], cc, dis[2:], cc)
    assert calls == [want, want]
    assert all(np.isfinite(s.ssimulacra2) for s in scores)


def _yuv_spec(depth, chroma=420):
    return ConvertSpec("yuv420", depth, "bt709", "bt709", False, chroma)


def _rgb_spec(depth):
    return ConvertSpec("rgb", depth, "identity", "srgb", True)


def _direct_planes(seed, bsz, h, w, spec, dtype):
    """One input's planes as the engine uploads them for ``spec``: (luma,
    chroma) codes, or (packed rgb,) codes of ``dtype`` (float: scaled to
    [0, 1])."""
    gen = torch.Generator().manual_seed(seed)
    hi = (1 << spec.depth) - 1

    def codes(*shape):
        x = torch.randint(0, hi + 1, shape, generator=gen, dtype=torch.int32)
        return x.float() / hi if dtype == torch.float32 else x.to(dtype)

    if spec.kind == "rgb":
        return (codes(bsz, h, w, 3),)
    return codes(bsz, h, w), codes(bsz, *colorspace.chroma_dims(spec.chroma, h, w), 2)


@pytest.mark.parametrize("fmt_ref, fmt_dis, want", [
    ((_yuv_spec(8), torch.uint8), (_yuv_spec(8), torch.uint8), "fused_scale0_yuv"),
    ((_yuv_spec(10), torch.uint16), (_yuv_spec(10), torch.uint16), "fused_scale0_yuv"),
    ((_yuv_spec(10), torch.uint16), (_yuv_spec(8), torch.uint8), None),
    ((_yuv_spec(8, 422), torch.uint8), (_yuv_spec(8, 422), torch.uint8), None),
    ((_rgb_spec(8), torch.uint8), (_rgb_spec(8), torch.uint8), "fused_scale_srgb"),
    ((_rgb_spec(16), torch.uint16), (_rgb_spec(16), torch.uint16), "fused_scale_srgb"),
    ((_rgb_spec(8), torch.uint8), (_rgb_spec(16), torch.uint16), None),
    ((_rgb_spec(8), torch.uint8), (_rgb_spec(8), torch.uint16), None),
    ((_rgb_spec(8), torch.int32), (_rgb_spec(8), torch.int32), None),
    ((_rgb_spec(8), torch.float32), (_rgb_spec(8), torch.float32), None),
], ids=["yuv420", "yuv420 10-bit", "yuv420 10 vs 8 bits", "yuv422", "srgb u8", "srgb u16", "srgb u8 vs u16",
        "srgb u8 vs u16 codes at 8 bits", "srgb int32", "float rgb"])
def test_model_picks_first_level_pass(monkeypatch, fmt_ref, fmt_dis, want):
    """``Ssimulacra2.subscores_direct`` on the planes the engine's step
    uploads (the stacked pair only for two inputs of one planar YUV spec):
    kernel 1 for YUV 4:2:0 of one spec, the sRGB pass for packed uint8 or
    uint16 sRGB codes of one spec and type, each called once and its
    sub-scores the entry's own, bit for bit; None, with no pass called,
    for specs that differ, 4:2:2, codes of two types, int32 codes and
    float RGB."""
    h, w, bsz = 19, 27, 2
    (spec_ref, dt_ref), (spec_dis, dt_dis) = fmt_ref, fmt_dis
    arr_ref = _direct_planes(1, bsz, h, w, spec_ref, dt_ref)
    arr_dis = _direct_planes(2, bsz, h, w, spec_dis, dt_dis)
    pair = None
    if spec_ref == spec_dis and spec_ref.kind == "yuv420":
        pair = tuple(torch.stack([a, b]) for a, b in zip(arr_ref, arr_dis))
    model = Ssimulacra2(w, h, device="cpu")
    calls = _spy(monkeypatch)
    got = model.subscores_direct(spec_ref, spec_dis, arr_ref, arr_dis, pair)
    assert calls == ([] if want is None else [want])
    if want is None:
        assert got is None
    elif want == "fused_scale0_yuv":
        assert torch.equal(got, ssimulacra2_subscores_from_yuv(
            *pair, model.taps, model.opsin, num_scales=model.num_scales, depth=spec_ref.depth,
            kr_kb=model.kr_kb["bt709"]))
    else:
        table = model.code_table(dt_ref, spec_ref.depth)
        assert torch.equal(got, ssimulacra2_subscores_from_srgb(
            *arr_ref, *arr_dis, model.taps, model.opsin, table, num_scales=model.num_scales, depth=spec_ref.depth))


@pytest.mark.parametrize("codes", CODES[:2], ids=CODE_IDS[:2])
def test_engine_scores_equal_across_routes(codes):
    """SSIMULACRA2 alone on sRGB codes (the fused route) scores each frame
    as the engine with PSNR beside it (the pair-buffer route), bit for
    bit."""
    dtype, depth = codes
    h, w, n = 37, 53, 3
    ref, dis = _rgb_frames(7, n, h, w, dtype, depth)
    got, want = (
        [s.ssimulacra2 for s in TurboMetrics(w, h, Metrics(**m), batch=n, device="cpu").compute_frames(
            ref, SRGB, dis, SRGB)]
        for m in ({"ssimulacra2": True}, {"ssimulacra2": True, "psnr": True})
    )
    assert got == want


def test_engine_records_no_conversion_span():
    """The fused route records the model's level and norm spans once a
    batch, and no ``tm.step.convert``."""
    h, w, batches = 37, 53, 2
    ref, dis = _rgb_frames(8, 2 * batches, h, w)
    engine = TurboMetrics(w, h, Metrics(ssimulacra2=True), batch=2, device="cpu")
    with profiling.tracing():
        for b in range(batches):
            engine.compute_frames(ref[2 * b:2 * b + 2], SRGB, dis[2 * b:2 * b + 2], SRGB)
    records = profiling.take()
    once = ["tm.step.ssimulacra2", "tm.step.ssimulacra2.levels", "tm.step.ssimulacra2.norms"]
    assert {name: records.spans[name].count for name in once} == dict.fromkeys(once, batches)
    assert "tm.step.convert" not in records.spans


@pytest.mark.parametrize("codes", CODES, ids=CODE_IDS)
def test_engine_srgb_alone_matches_jax(codes):
    """SSIMULACRA2 alone on packed sRGB frames (the port's fused route)
    through both engines' compute_frames, in two batches (the second
    padded): every score within the score tolerance of the JAX engine's."""
    dtype, depth = codes
    h, w, n = 37, 53, 3
    ref, dis = _codes(9, n, h, w, dtype, depth)
    scores = []
    for mod, frame, fallback, kw in (
        (jax_engine, JaxRawFrame, jax_height_fallback, {}),
        (port_engine, RawFrame, height_fallback, {"device": "cpu"}),
    ):
        eng = mod.TurboMetrics(w, h, mod.Metrics(ssimulacra2=True), batch=2, **kw)
        cc = (fallback(h), "full")
        r = [frame(rgb=f.numpy(), depth=depth) for f in ref]
        d = [frame(rgb=f.numpy(), depth=depth) for f in dis]
        out = eng.compute_frames(r[:2], cc, d[:2], cc) + eng.compute_frames(r[2:], cc, d[2:], cc)
        scores.append([s.ssimulacra2 for s in out])
    want, got = scores
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.isfinite(got).all()
