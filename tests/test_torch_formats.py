"""The port's generic conversion (kernel #5's twin, sRGB sources) and the
engine and CLI on 4:2:2, 4:4:4, mixed-format and RGB inputs, vs the JAX
package on the CPU.

The conversion twin is held against the JAX jnp ``yuv420_to_linear_rgb
(chroma=...)`` and the Pallas kernel it replaces in interpret mode at atol
3e-6, 1e-4 for PQ (the JAX package's own tolerances, tests/
test_pallas_kernels.py:107).  Engine and CLI runs score every RGB family and
XPSNR: PSNR within 1e-4 dB, SSIM and MS-SSIM 1e-5, SSIMULACRA2 1e-3 (the JAX
jnp path's own f32 error on frames this small, tests/test_torch_slice.py),
XPSNR 1e-9.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turbo_metrics_tpu import cli as jax_cli
from turbo_metrics_tpu import engine as jax_engine
from turbo_metrics_tpu.color.characteristics import height_fallback as jax_height_fallback
from turbo_metrics_tpu.io.frame_source import RawFrame as JaxRawFrame
from turbo_metrics_tpu.ops import colorspace as j_cs
from turbo_metrics_tpu.ops.pallas.convert import yuv420_to_linear_rgb_pallas

from turbo_metrics_tpu_torch import cli as port_cli
from turbo_metrics_tpu_torch import engine as port_engine
from turbo_metrics_tpu_torch.color.characteristics import height_fallback
from turbo_metrics_tpu_torch.io.frame_source import RawFrame
from turbo_metrics_tpu_torch.io.probe import create_source as port_create_source
from turbo_metrics_tpu_torch.ops import colorspace as t_cs
from turbo_metrics_tpu_torch.ops.kernels import convert
from turbo_metrics_tpu_torch.tools.edge_cases import threshold_codes

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

NAMES = ("ssimulacra2", "psnr", "ssim", "msssim", "xpsnr")
ATOL = {"ssimulacra2": 1e-3, "psnr": 1e-4, "ssim": 1e-5, "msssim": 1e-5, "xpsnr": 1e-9}
W, H = 256, 192


def _yuv(rng, n, h, w, depth, chroma):
    """Seeded random planes at a subsampling: (y (n, h, w), uv (n, ch, cw, 2))."""
    ch, cw = t_cs.chroma_dims(chroma, h, w)
    dt = np.uint8 if depth == 8 else np.uint16
    hi = 1 << depth
    return (
        rng.integers(0, hi, (n, h, w)).astype(dt),
        rng.integers(0, hi, (n, ch, cw, 2)).astype(dt),
    )


@pytest.mark.parametrize("transfer", ["bt709", "srgb", "pq", "hlg", "linear"])
@pytest.mark.parametrize("depth", [8, 10, 16])
@pytest.mark.parametrize("chroma", [420, 422, 444])
def test_convert_twin_matches_jax(rng, chroma, depth, transfer):
    """Kernel #5's twin on odd sizes (67x99) against the jnp conversion and
    yuv420_to_linear_rgb_pallas in interpret mode, full range where the
    depth is 16 (limited range elsewhere)."""
    h, w = 67, 99
    y, uv = _yuv(rng, 2, h, w, depth, chroma)
    kw = dict(depth=depth, transfer=transfer, full_range=depth == 16, chroma=chroma)
    got = convert.yuv_to_linear_rgb(torch.from_numpy(y), torch.from_numpy(uv), **kw)
    assert got.shape == (2, 3, h, w) and got.dtype == torch.float32
    atol = 1e-4 if transfer == "pq" else 3e-6
    want = j_cs.yuv420_to_linear_rgb(jnp.asarray(y), jnp.asarray(uv), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
    want = yuv420_to_linear_rgb_pallas(jnp.asarray(y), jnp.asarray(uv), interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("depth", [8, 10, 16])
@pytest.mark.parametrize("transfer", ["bt709", "srgb"])
def test_convert_twin_at_thresholds_matches_jax(transfer, depth, full_range):
    """Kernel #5's twin at the threshold code values (4:4:4), with neutral
    chroma and with Cb and Cr one code off it (so that the three channels
    fall on both sides of the threshold), against the jnp conversion."""
    codes = threshold_codes(depth, full_range)
    neutral = t_cs.sample_range(depth, full_range).neutral
    dt = np.uint8 if depth == 8 else np.uint16
    y = np.broadcast_to(codes, (3, codes.size)).astype(dt)[None]
    cb = np.array([neutral, neutral + 1, neutral - 1])[:, None].repeat(codes.size, 1)
    uv = np.stack([cb, cb[::-1]], axis=-1).astype(dt)[None]
    kw = dict(depth=depth, transfer=transfer, full_range=full_range, chroma=444)
    got = convert.yuv_to_linear_rgb(torch.from_numpy(y.copy()), torch.from_numpy(uv), **kw)
    want = j_cs.yuv420_to_linear_rgb(jnp.asarray(y), jnp.asarray(uv), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-6)


def test_convert_slots_and_routes_agree(rng):
    """Kernel #5 into one slot of the pair buffer equals its stacked call,
    and at 4:2:0 it converts exactly as kernel #6 does."""
    y, uv = _yuv(rng, 4, 21, 33, 10, 422)
    y2, uv2 = torch.from_numpy(y).view(2, 2, 21, 33), torch.from_numpy(uv).view(2, 2, 21, 17, 2)
    whole = convert.yuv_to_linear_rgb(y2, uv2, depth=10, chroma=422)
    p12 = torch.zeros_like(whole)
    for slot in (0, 1):
        out = convert.yuv_to_linear_rgb(y2[slot], uv2[slot], p12[slot], depth=10, chroma=422)
        assert out.data_ptr() == p12[slot].data_ptr()
    assert torch.equal(p12, whole)
    y, uv = _yuv(rng, 2, 21, 33, 8, 420)
    y2, uv2 = torch.from_numpy(y)[:, None], torch.from_numpy(uv)[:, None]
    assert torch.equal(
        convert.yuv_to_linear_rgb(y2, uv2, chroma=420), convert.yuv420_to_linear_rgb_pair(y2, uv2)
    )
    with pytest.raises(ValueError):
        convert.yuv_to_linear_rgb(y2, uv2, chroma=422)


@pytest.mark.parametrize("dtype,depth", [(np.uint8, None), (np.uint16, 10), (np.float32, None)])
def test_srgb_to_linear_matches_jax(rng, dtype, depth):
    hi = 1.0 if dtype == np.float32 else (1 << (depth or 8)) - 1
    x = (rng.uniform(0, hi, (2, 3, 17, 23)) if dtype == np.float32 else
         rng.integers(0, hi + 1, (2, 3, 17, 23))).astype(dtype)
    got = t_cs.srgb_to_linear(torch.from_numpy(x), depth=depth)
    want = j_cs.srgb_to_linear(jnp.asarray(x), depth=depth)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-7)


def _smooth(rng, n, h, w, chroma, depth, noise):
    """Smooth planes with seeded noise at a subsampling and depth."""
    ch, cw = t_cs.chroma_dims(chroma, h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = np.mgrid[0:ch, 0:cw]
    s = 1 << (depth - 8)
    out = []
    for i in range(n):
        planes = (
            128 + 70 * np.sin(xx / 9.0 + i * 0.3) * np.cos(yy / 7.0),
            128 + 40 * np.sin(cx / 5.0 + i * 0.2),
            128 + 40 * np.cos(cy / 4.0),
        )
        out.append(tuple(
            np.clip(np.round((p + rng.normal(0, noise, p.shape)) * s), 0, 255 * s).astype(np.int64)
            for p in planes
        ))
    return out


def _write_y4m(path, frames, w, h, depth, chroma):
    dt = np.uint8 if depth == 8 else np.uint16
    cs = f"{chroma}" if depth == 8 else f"{chroma}p{depth}"
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C{cs}\n".encode())
        for planes in frames:
            f.write(b"FRAME\n")
            for p in planes:
                f.write(p.astype(dt).tobytes())


def _distort(rng, frames, depth, *, to_depth=None, to_420=False):
    """The distorted stream: each plane plus seeded noise, optionally brought
    to another depth and to 4:2:0 (every other chroma row)."""
    to_depth = to_depth or depth
    out = []
    for y, u, v in frames:
        planes = []
        for i, p in enumerate((y, u, v)):
            if to_420 and i:
                p = p[::2]
            p = p >> (depth - to_depth) if to_depth < depth else p << (to_depth - depth)
            s = 1 << (to_depth - 8)
            planes.append(np.clip(p + rng.integers(-9 * s, 9 * s + 1, p.shape), 0, 255 * s))
        out.append(tuple(planes))
    return out


# (reference chroma and depth, distorted chroma and depth)
FORMATS = {
    "422": ((422, 8), (422, 8)),
    "444": ((444, 10), (444, 10)),
    # A 10-bit 4:2:2 master against an 8-bit 4:2:0 encode: each image in its
    # own slot, XPSNR at the reference's depth.
    "422p10-vs-420": ((422, 10), (420, 8)),
}


@pytest.fixture(scope="module", params=sorted(FORMATS))
def format_run(request, tmp_path_factory):
    """A 3-frame Y4M pair of one format and the JAX CLI's five-metric JSON for
    it (batch 2, the last batch padded), computed once per format."""
    (rc, rd), (dc, dd) = FORMATS[request.param]
    rng = np.random.default_rng(2026)
    ref = _smooth(rng, 3, H, W, rc, rd, 2.0)
    dis = _distort(rng, ref, rd, to_depth=dd, to_420=dc == 420 and rc != 420)
    tmp = tmp_path_factory.mktemp(f"fmt{request.param}")
    pr, pd = tmp / "ref.y4m", tmp / "dis.y4m"
    _write_y4m(pr, ref, W, H, rd, rc)
    _write_y4m(pd, dis, W, H, dd, dc)
    args = [str(pr), str(pd), *sum((["-m", m] for m in NAMES), []), "--batch", "2", "--no-progress"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_cli.main(args + ["--output", "json"]) == 0
    return args, json.loads(out.getvalue())


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def _close(got: dict, want: dict):
    for name in NAMES:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL[name], err_msg=name)


def test_format_engine_matches_jax(format_run):
    """compute_all on the pair against the JAX CLI's per-frame values."""
    args, want = format_run
    eng = port_engine.TurboMetrics(
        W, H, port_engine.Metrics(**{n: True for n in NAMES}), batch=2, device="cpu"
    )
    res = eng.compute_all(port_create_source(args[0]), port_create_source(args[1]))
    assert res.frame_count == want["frame_count"] == 3
    _close({n: getattr(res, n).scores for n in NAMES}, {n: want[n]["scores"] for n in NAMES})
    assert all(np.isfinite(getattr(res, n).scores).all() for n in NAMES)


def test_format_single_metric_routes_match_jax(format_run):
    """SSIMULACRA2 alone (the pair-buffer route: no 4:2:0 pair of one spec)
    and XPSNR alone (no conversion at all) against the JAX CLI's five-metric
    values."""
    args, want = format_run
    for name in ("ssimulacra2", "xpsnr"):
        eng = port_engine.TurboMetrics(W, H, port_engine.Metrics(**{name: True}), batch=2, device="cpu")
        res = eng.compute_all(port_create_source(args[0]), port_create_source(args[1]))
        assert res.frame_count == 3 and res.psnr is None
        np.testing.assert_allclose(
            getattr(res, name).scores, want[name]["scores"], rtol=0, atol=ATOL[name], err_msg=name
        )


def test_format_cli_matches_jax(format_run, capsys):
    """The port's CLI: the JAX CLI's JSON keys, frame count and values."""
    args, want = format_run
    assert port_cli.main(args + ["--output", "json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert _keys(got) == _keys(want)
    assert got["frame_count"] == want["frame_count"] == 3
    _close({n: got[n]["scores"] for n in NAMES}, {n: want[n]["scores"] for n in NAMES})


def _rgb_frames(rng, n, h, w, depth):
    yy, xx = np.mgrid[0:h, 0:w]
    hi = (1 << depth) - 1
    out = []
    for i in range(n):
        base = np.stack([
            0.5 + 0.4 * np.sin(xx / 11.0 + i * 0.2) * np.cos(yy / 13.0),
            0.5 + 0.3 * np.cos(xx / 7.0 + 1.0),
            0.5 + 0.2 * np.sin((xx + yy) / 17.0 + i * 0.1),
        ], axis=-1)
        ref = np.clip(np.round((base + rng.normal(0, 0.01, base.shape)) * hi), 0, hi)
        dis = np.clip(ref + rng.integers(-12, 13, ref.shape) * (hi // 255), 0, hi)
        dt = np.uint8 if depth == 8 else np.uint16
        out.append((ref.astype(dt), dis.astype(dt)))
    return out


def _yuv422p10(rgb8):
    """A 10-bit limited-range BT.709 4:2:2 encoding of an 8-bit RGB frame
    (even chroma columns), as a RawFrame's (y, uv)."""
    kr, kb = 0.2126, 0.0722
    r, g, b = (rgb8[..., i] / 255.0 for i in range(3))
    y = kr * r + (1 - kr - kb) * g + kb * b
    cb, cr = (b - y) / (2 * (1 - kb)), (r - y) / (2 * (1 - kr))
    uv = np.stack([cb, cr], -1)[:, ::2]
    return (
        np.clip(np.round(64 + 876 * y), 0, 1023).astype(np.uint16),
        np.clip(np.round(512 + 896 * uv), 0, 1023).astype(np.uint16),
    )


@pytest.mark.parametrize("case", ["rgb8", "rgb8-vs-yuv422p10"])
def test_rgb_frames_match_jax(case):
    """Packed RGB frames through both engines' compute_frames, in two
    batches chained through the XPSNR stream state (the second padded):
    sRGB conversion into the pair buffer, BT.709 luma codes for XPSNR (with
    a 10-bit distorted stream, shifted to the reference's 8 bits)."""
    rng = np.random.default_rng(7)
    frames = _rgb_frames(rng, 3, H, W, 8)
    results = []
    for mod, frame, fallback, kw in (
        (jax_engine, JaxRawFrame, jax_height_fallback, {}),
        (port_engine, RawFrame, height_fallback, {"device": "cpu"}),
    ):
        eng = mod.TurboMetrics(W, H, mod.Metrics(**{n: True for n in NAMES}), batch=2, **kw)
        cc = (fallback(H), "limited")
        ref = [frame(rgb=r, depth=8) for r, _ in frames]
        if case == "rgb8":
            dis = [frame(rgb=d, depth=8) for _, d in frames]
        else:
            dis = [frame(*_yuv422p10(d), depth=10, chroma=422) for _, d in frames]
        scores = eng.compute_frames(ref[:2], cc, dis[:2], cc) + eng.compute_frames(
            ref[2:], cc, dis[2:], cc
        )
        results.append({n: [getattr(s, n) for s in scores] for n in NAMES})
    want, got = results
    _close(got, want)
    assert all(np.isfinite(got[n]).all() for n in NAMES)


@pytest.mark.parametrize("depth", [8, 16])
def test_luma_code_matches_jax(rng, depth):
    """RGB luma codes equal the JAX engine's ``_luma_code`` evaluated op by
    op in f32, bit for bit, at 8 and 16 bits.  (Under ``jax.jit`` the CPU
    compiler fuses the weighted sum and lands 1 ulp away at some f32
    near-ties of .5, which then round the other way: 0 of these 8-bit
    pixels, a few dozen of the 16-bit ones; ROADMAP.md Queue 3.)"""
    dt = np.uint8 if depth == 8 else np.uint16
    rgb = rng.integers(0, 1 << depth, (2, 96, 128, 3)).astype(dt)
    spec_j = jax_engine.ConvertSpec("rgb", depth, "identity", "srgb", True)
    spec_t = port_engine.ConvertSpec("rgb", depth, "identity", "srgb", True)
    want = np.asarray(jax_engine._luma_code(spec_j, (jnp.asarray(rgb),)))
    got = port_engine._luma_code(spec_t, (torch.from_numpy(rgb),))
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
