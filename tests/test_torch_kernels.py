"""The port's kernel modules (ops/kernels) vs the JAX package's jnp chain.

On the CPU each kernel wrapper runs its plain twin (a CUDA kernel has no
interpret mode; the kernels themselves are compared with the twins on the
card by chip_smoke.py).  The reference is the JAX chain
``colorspace.yuv420_to_linear_rgb`` -> ``ssimulacra2_subscores(backend=
"jnp")``, which blurs five quantities where the port blurs four, at the JAX
package's kernel-vs-jnp tolerance rtol 2e-5 / atol 2e-6
(tests/test_pallas_kernels.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turbo_metrics_tpu.models.ssimulacra2 import ssimulacra2_subscores as jax_subscores
from turbo_metrics_tpu.ops import colorspace as j_cs
from turbo_metrics_tpu.ops.downscale import downscale_by_2 as jax_downscale

from turbo_metrics_tpu_torch.models.ssimulacra2 import (
    Ssimulacra2,
    subscores_from_sums,
    ssimulacra2_subscores_from_yuv,
)
from turbo_metrics_tpu_torch.ops.downscale import scale_dims
from turbo_metrics_tpu_torch.ops.kernels import scale_stats, scale_tail

RTOL, ATOL = 2e-5, 2e-6
SHAPES = [(48, 64), (67, 99)]  # even; odd (edge-replicated downscales)


def _yuv_pair(rng, bsz, h, w, depth=8):
    """Seeded (y2, uv2) numpy planes: independent, uniformly random
    legal-range reference and distorted images.

    Where the two images are close, the SSIM quotient of the deep scales is
    ill-conditioned in f32: there every f32 implementation, the JAX jnp path
    included, is ~1e-3 relative from the f64 value, and two of them differ
    by as much.  Independent images keep it well conditioned, so that these
    tests see the port's own error; close pairs are held to the score
    tolerance in tests/test_torch_slice.py."""
    s = 1 << (depth - 8)
    dt = np.uint8 if depth == 8 else np.uint16
    ch, cw = (h + 1) // 2, (w + 1) // 2
    y2 = rng.integers(16 * s, 235 * s + 1, (2, bsz, h, w))
    uv2 = rng.integers(16 * s, 240 * s + 1, (2, bsz, ch, cw, 2))
    return y2.astype(dt), uv2.astype(dt)


def _jax_lin(y2, uv2, depth=8):
    return np.asarray(j_cs.yuv420_to_linear_rgb(jnp.asarray(y2), jnp.asarray(uv2), depth=depth))


def _consts():
    m = Ssimulacra2(64, 48, device="cpu")
    return m.taps, m.opsin


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", SHAPES)
def test_scale0_twin_matches_jax(rng, hw):
    """Kernel 1's twin: scale-0 sub-scores and the emitted level 1."""
    h, w = hw
    y2, uv2 = _yuv_pair(rng, 2, h, w)
    lin = _jax_lin(y2, uv2)
    want = np.asarray(jax_subscores(lin[0], lin[1], num_scales=1, backend="jnp"))
    taps, opsin = _consts()
    sums, level1 = scale_stats.fused_scale0_yuv(
        torch.from_numpy(y2), torch.from_numpy(uv2), taps, opsin
    )
    assert sums.shape == (2, 3, 6) and sums.dtype == torch.float32
    _close(subscores_from_sums([sums], [(h, w)]), want)
    assert level1.shape == (2, 2, 3, (h + 1) // 2, (w + 1) // 2)
    _close(level1, jax_downscale(jnp.asarray(lin)))


@pytest.mark.parametrize("hw", SHAPES)
def test_tail_twin_matches_jax(rng, hw):
    """Kernel 2's twin on linear RGB: every level of the pyramid."""
    h, w = hw
    y2, uv2 = _yuv_pair(rng, 2, h, w)
    lin = _jax_lin(y2, uv2)
    dims = scale_dims(h, w)
    want = np.asarray(jax_subscores(lin[0], lin[1], num_scales=len(dims), backend="jnp"))
    taps, opsin = _consts()
    sums = scale_tail.fused_pyramid_tail(torch.from_numpy(lin.copy()), len(dims), taps, opsin)
    assert sums.shape == (2, len(dims), 3, 6)
    _close(subscores_from_sums(list(sums.unbind(1)), dims), want)


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("hw", SHAPES)
def test_kernel_path_matches_jax(rng, hw, depth):
    """Kernels 1 + 2 as the main path chains them, 8- and 10-bit."""
    h, w = hw
    y2, uv2 = _yuv_pair(rng, 2, h, w, depth=depth)
    lin = _jax_lin(y2, uv2, depth=depth)
    ns = len(scale_dims(h, w))
    want = np.asarray(jax_subscores(lin[0], lin[1], num_scales=ns, backend="jnp"))
    taps, opsin = _consts()
    got = ssimulacra2_subscores_from_yuv(
        torch.from_numpy(y2), torch.from_numpy(uv2), taps, opsin,
        num_scales=ns, depth=depth,
    )
    assert got.shape == (2, 3, ns, 2, 3)
    _close(got, want)


def test_launches_stay_zero_on_cpu(rng):
    """On CPU tensors the wrappers run their plain twins: no launch counted."""
    scale_stats.fused_scale0_yuv.launches = 0
    scale_tail.fused_pyramid_tail.launches = 0
    y2, uv2 = _yuv_pair(rng, 1, 24, 32)
    taps, opsin = _consts()
    ssimulacra2_subscores_from_yuv(
        torch.from_numpy(y2), torch.from_numpy(uv2), taps, opsin, num_scales=3
    )
    assert scale_stats.fused_scale0_yuv.launches == 0
    assert scale_tail.fused_pyramid_tail.launches == 0


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "device", "layout"],
)
def test_wrappers_reject_bad_inputs(rng, bad):
    """Shape, type, device and contiguity are checked before any launch; a
    tensor on neither the CPU nor CUDA raises instead of falling back."""
    y2, uv2 = _yuv_pair(rng, 1, 16, 20)
    y2, uv2 = torch.from_numpy(y2), torch.from_numpy(uv2)
    taps, opsin = _consts()
    p12 = torch.zeros(2, 1, 3, 16, 20)
    if bad == "dtype":
        y2, uv2, p12 = y2.to(torch.uint16), uv2.to(torch.uint16), p12.double()
    elif bad == "shape":
        uv2, p12 = uv2[:, :, :-1].contiguous(), p12[:, :, :2].contiguous()
    elif bad == "device":
        y2, uv2, p12 = y2.to("meta"), uv2.to("meta"), p12.to("meta")
        taps, opsin = taps.to("meta"), opsin.to("meta")
    else:
        y2, p12 = y2.transpose(-1, -2), p12.transpose(-1, -2)
    with pytest.raises(ValueError):
        scale_stats.fused_scale0_yuv(y2, uv2, taps, opsin)
    with pytest.raises(ValueError):
        scale_tail.fused_pyramid_tail(p12, 2, taps, opsin)
