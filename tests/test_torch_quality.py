"""The port's PSNR / SSIM / MS-SSIM (ops/quality.py) vs the JAX package's.

The same seeded numpy code values go through the JAX jnp functions
(``backend="jnp"``, jitted on the CPU) and the port's plain functions, and
through ``quality_from_rgb``, the multi-metric path, whose kernel wrappers
run their plain twins on CPU tensors.  Tolerances: PSNR within 1e-4 dB,
SSIM and MS-SSIM within 1e-5 (f32 sums in another order; measured ~3e-7).
"""

import jax
import numpy as np
import pytest
import torch

from turbo_metrics_tpu.ops import colorspace as j_cs
from turbo_metrics_tpu.ops import quality as jq
from turbo_metrics_tpu.ops.gaussian import gaussian_window as j_window

from turbo_metrics_tpu_torch.ops import colorspace as t_cs
from turbo_metrics_tpu_torch.ops import quality as tq

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

PSNR_ATOL, SSIM_ATOL = 1e-4, 1e-5
# (h, w): 190x250 runs five MS-SSIM levels with odd dims from level 1 on
# (95 -> 47, 125 -> 62 -> 31); 136x240 takes the clamped four-level branch.
SHAPES = [(190, 250), (136, 240)]


def _codes(rng, bsz, h, w, noise):
    """Integer code values in [0, 255]: a smooth base plus noise, and a
    noisier copy, (B, 3, h, w) f32 each."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack(
        [128 + 90 * np.sin(xx / (7 + 3 * k)) * np.cos(yy / (5 + 2 * k)) for k in range(3)]
    )
    a = np.clip(base + rng.normal(0, 2, (bsz,) + base.shape), 0, 255)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 255)
    return np.round(a).astype(np.float32), np.round(b).astype(np.float32)


# One jitted reference for the module, so that tests on the same shapes share
# its compilation.
_JAX_ALL = jax.jit(lambda x, y: (jq.psnr(x, y),) + jq.ssim_msssim(x, y, backend="jnp"))


def _jax_all(a, b):
    return [np.asarray(v) for v in _JAX_ALL(a, b)]


def _window():
    return torch.from_numpy(j_window(11, 1.5).astype(np.float32))


@pytest.mark.parametrize("hw", SHAPES)
def test_plain_functions_match_jax(rng, hw):
    h, w = hw
    a, b = _codes(rng, 2, h, w, 6.0)
    want_psnr, want_ssim, want_ms = _jax_all(a, b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(tq.psnr(ta, tb).numpy(), want_psnr, rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(tq.ssim(ta, tb).numpy(), want_ssim, rtol=0, atol=SSIM_ATOL)
    np.testing.assert_allclose(tq.msssim(ta, tb).numpy(), want_ms, rtol=0, atol=SSIM_ATOL)
    s, ms = tq.ssim_msssim(ta, tb)
    np.testing.assert_allclose(s.numpy(), want_ssim, rtol=0, atol=SSIM_ATOL)
    np.testing.assert_allclose(ms.numpy(), want_ms, rtol=0, atol=SSIM_ATOL)
    lv, _ = tq._clamp_levels(h, w, 5)
    assert lv == jq._clamp_levels(h, w, 5)[0] == (5 if h == 190 else 4)
    assert 0.5 < float(want_ssim.min()) and float(want_ms.max()) < 1.0


@pytest.mark.parametrize("hw", SHAPES)
def test_quality_from_rgb_matches_jax(rng, hw):
    """The multi-metric path on linear RGB in [0, 1], quantized at load,
    against the JAX functions on the quantized code values."""
    h, w = hw
    a, b = _codes(rng, 2, h, w, 6.0)
    lin = np.stack([a, b]) / np.float32(255.0)
    q = np.asarray(j_cs.f32_to_uint8(lin)).astype(np.float32)
    assert np.array_equal(q, np.stack([a, b]))
    want_psnr, want_ssim, want_ms = _jax_all(q[0], q[1])
    got = tq.quality_from_rgb(
        torch.from_numpy(lin), _window(), want_psnr=True, want_ssim=True, want_msssim=True
    )
    np.testing.assert_allclose(got["psnr"].numpy(), want_psnr, rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(got["ssim"].numpy(), want_ssim, rtol=0, atol=SSIM_ATOL)
    np.testing.assert_allclose(got["msssim"].numpy(), want_ms, rtol=0, atol=SSIM_ATOL)
    alone = tq.quality_from_rgb(torch.from_numpy(lin), _window(), want_ssim=True)
    assert set(alone) == {"ssim"}
    np.testing.assert_allclose(alone["ssim"].numpy(), got["ssim"].numpy(), rtol=0, atol=1e-7)


def test_identical_pair(rng):
    """PSNR of an identical pair is inf (tests/test_quality_oracle.py), SSIM
    and MS-SSIM are 1, on both routes."""
    a = rng.uniform(0, 255, (1, 3, 64, 64)).astype(np.float32)
    ta = torch.from_numpy(a)
    assert np.isinf(float(jq.psnr(a, a)[0])) and np.isinf(float(tq.psnr(ta, ta)[0]))
    assert float(tq.ssim(ta, ta)[0]) == pytest.approx(1.0, abs=1e-6)
    assert float(tq.msssim(ta, ta)[0]) == pytest.approx(1.0, abs=1e-6)
    lin = torch.from_numpy(np.stack([a, a]) / np.float32(255.0))
    got = tq.quality_from_rgb(lin, _window(), want_psnr=True, want_ssim=True, want_msssim=True)
    assert np.isinf(float(got["psnr"][0]))
    assert float(got["ssim"][0]) == pytest.approx(1.0, abs=1e-6)
    assert float(got["msssim"][0]) == pytest.approx(1.0, abs=1e-6)


def test_quantization_rounds_half_to_even():
    """Values whose f32 product with 255 is exactly k + 0.5: the port's
    f32_to_uint8 rounds them to the even neighbour, as the JAX package's does
    (round half away from zero would differ on every odd k)."""
    k = np.arange(255, dtype=np.float64)
    x = ((k + 0.5) / 255.0).astype(np.float32)
    exact = (x * np.float32(255.0)) == (k + 0.5).astype(np.float32)
    x, k = x[exact], k[exact]
    assert len(x) > 100 and (k % 2 == 1).any()
    want = np.asarray(j_cs.f32_to_uint8(x))
    got = t_cs.f32_to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.where(k % 2 == 0, k, k + 1).astype(np.uint8))
    # Out-of-range values clip; f32 code values are the same numbers.
    edge = torch.tensor([-0.5, 0.0, 1.0, 1.7], dtype=torch.float32)
    assert t_cs.f32_to_uint8(edge).tolist() == [0, 0, 255, 255]
    assert t_cs.f32_to_uint8(edge, torch.float32).tolist() == [0.0, 0.0, 255.0, 255.0]


def test_constants_match_jax():
    """The port's SSIM-family constants are the JAX package's values, and a
    Quality module built from the JAX package's numpy values holds them."""
    d = {
        "ssim_window": j_window(11, 1.5),
        "c1": jq._C1,
        "c2": jq._C2,
        "msssim_weights": jq.MSSSIM_WEIGHTS,
    }
    mine = tq.builtin_constants()
    assert set(mine) == set(d)
    for key, val in d.items():
        np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(val))
    mod = tq.Quality(device="cpu")
    mod.constants_from_numpy(d)
    np.testing.assert_array_equal(mod.window.numpy(), d["ssim_window"].astype(np.float32))
    assert (mod.c1, mod.c2) == (float(jq._C1), float(jq._C2))
