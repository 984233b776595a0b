"""Port ops (turbo_metrics_tpu_torch.ops) vs the JAX package's jnp ops.

The same seeded numpy inputs go through both; JAX runs on the CPU, torch on
the CPU.  Tolerance: rtol 2e-5 / atol 2e-6, the JAX package's own
kernel-vs-jnp tolerance (tests/test_pallas_kernels.py), covering f32
rounding-order differences between XLA and torch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turbo_metrics_tpu.models import ssimulacra2_score as j_score
from turbo_metrics_tpu.ops import colorspace as j_cs
from turbo_metrics_tpu.ops import downscale as j_ds
from turbo_metrics_tpu.ops import gaussian as j_g
from turbo_metrics_tpu.ops import ssim_maps as j_maps
from turbo_metrics_tpu.ops import xyb as j_xyb

from turbo_metrics_tpu_torch.models import ssimulacra2 as t_model
from turbo_metrics_tpu_torch.models import ssimulacra2_score as t_score
from turbo_metrics_tpu_torch.ops import colorspace as t_cs
from turbo_metrics_tpu_torch.ops import downscale as t_ds
from turbo_metrics_tpu_torch.ops import gaussian as t_g
from turbo_metrics_tpu_torch.ops import ssim_maps as t_maps
from turbo_metrics_tpu_torch.ops import xyb as t_xyb

RTOL, ATOL = 2e-5, 2e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("transfer", ["bt709", "srgb", "pq", "hlg"])
@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("depth", [8, 10])
def test_yuv420_to_linear_rgb(rng, depth, full_range, transfer):
    h, w = 17, 23  # odd: chroma upsampling crops
    hi = 1 << depth
    dt = np.uint8 if depth == 8 else np.uint16
    y = rng.integers(0, hi, (2, h, w)).astype(dt)
    uv = rng.integers(0, hi, (2, (h + 1) // 2, (w + 1) // 2, 2)).astype(dt)
    matrix = "bt709" if depth == 8 else "bt2020"
    kw = dict(depth=depth, matrix=matrix, transfer=transfer, full_range=full_range)
    want = j_cs.yuv420_to_linear_rgb(jnp.asarray(y), jnp.asarray(uv), **kw)
    got = t_cs.yuv420_to_linear_rgb(torch.from_numpy(y), torch.from_numpy(uv), **kw)
    assert got.shape == (2, 3, h, w) and got.dtype == torch.float32
    if transfer == "pq":
        # PQ's steep top end amplifies a 1-ulp difference in pow(v, 1/m2)
        # into ~6e-5 relative near v = 0.71, where XLA's and torch's f32
        # results are each ~6e-5 from the f64 value: the JAX package's own
        # PQ conversion tolerance (tests/test_pallas_kernels.py:107) applies.
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=1e-4)
    else:
        _close(got, want)


def test_blur_2d(rng):
    x = rng.random((2, 3, 19, 27), dtype=np.float64).astype(np.float32)
    _close(t_g.blur_2d(torch.from_numpy(x)), j_g.blur_2d(jnp.asarray(x)))


def test_linear_rgb_to_xyb(rng):
    rgb = rng.random((2, 3, 13, 21), dtype=np.float64).astype(np.float32)
    rgb[0, :, 0, 0] = 0.0  # black: smallest cube-root argument (the bias)
    _close(t_xyb.linear_rgb_to_xyb(torch.from_numpy(rgb)), j_xyb.linear_rgb_to_xyb(jnp.asarray(rgb)))


@pytest.mark.parametrize("hw", [(16, 24), (17, 25), (9, 8)])
def test_downscale_by_2(rng, hw):
    x = rng.random((2, 3) + hw, dtype=np.float64).astype(np.float32)
    got = t_ds.downscale_by_2(torch.from_numpy(x))
    assert got.shape[-2:] == ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
    _close(got, j_ds.downscale_by_2(jnp.asarray(x)))


@pytest.mark.parametrize("hw", [(96, 128), (1080, 1920), (67, 99), (7, 64)])
def test_scale_dims(hw):
    assert t_ds.scale_dims(*hw) == j_ds.scale_dims(*hw)


def test_scale_norms(rng):
    x1 = rng.random((2, 3, 20, 28), dtype=np.float64).astype(np.float32)
    x2 = np.clip(x1 + rng.normal(0, 0.05, x1.shape), 0, 1).astype(np.float32)
    q = [x1, x2, x1 * x1, x2 * x2, x1 * x2]
    blurred = [np.asarray(j_g.blur_2d(jnp.asarray(v))) for v in q]
    args = [x1, x2] + blurred
    want = j_maps.scale_norms(*[jnp.asarray(a) for a in args])
    got = t_maps.scale_norms(*[torch.from_numpy(a) for a in args])
    assert got.shape == (2, 3, 2, 3)
    _close(got, want)


def test_constants_bit_identical():
    """The port's built-in constants (its stand-in for weights) equal the JAX
    package's bit for bit, and ``constants_from_numpy`` installs them as is."""
    jax_consts = {
        "weights": j_score.WEIGHTS,
        "taps": j_g.gaussian_taps(),
        "opsin_matrix": j_xyb.OPSIN_ABSORBANCE_MATRIX,
        "opsin_bias": j_xyb.OPSIN_ABSORBANCE_BIAS,
        "opsin_bias_root": j_xyb.OPSIN_ABSORBANCE_BIAS_ROOT,
        "matrix_kr_kb": np.array(
            [j_cs.MATRIX_KR_KB[m] for m in t_model.MATRIX_NAMES], dtype=np.float64
        ),
    }
    mine = t_model.builtin_constants()
    assert mine.keys() == jax_consts.keys()
    for k, v in jax_consts.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
        assert np.asarray(mine[k]).dtype == np.asarray(v).dtype, k
    assert t_cs.MATRIX_KR_KB == j_cs.MATRIX_KR_KB
    assert t_score.weight_needs(6) == j_score.weight_needs(6)

    model = t_model.Ssimulacra2(64, 48, device="cpu")
    model.constants_from_numpy(jax_consts)
    np.testing.assert_array_equal(model.taps.numpy(), j_g.gaussian_taps().astype(np.float32))
    np.testing.assert_array_equal(model.opsin.numpy()[:9], j_xyb.OPSIN_ABSORBANCE_MATRIX.reshape(9))
    np.testing.assert_array_equal(
        model.opsin.numpy()[9:],
        [j_xyb.OPSIN_ABSORBANCE_BIAS, j_xyb.OPSIN_ABSORBANCE_BIAS_ROOT],
    )
    np.testing.assert_array_equal(model.weights, j_score.WEIGHTS)


def test_postprocess_score_matches(rng):
    vals = rng.random((4, 3, 6, 2, 3))
    np.testing.assert_array_equal(
        t_score.postprocess_score(vals), j_score.postprocess_score(vals)
    )
