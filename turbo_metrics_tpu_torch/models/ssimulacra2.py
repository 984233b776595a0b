"""SSIMULACRA2 in PyTorch: the plain chain, the kernel path and the module.

Two routes to the (B, 3, S, 2, 3) sub-scores (channel, scale, norm, map):
  * ``ssimulacra2_subscores``: the plain torch chain (downscale, XYB, five
    blurs, maps, means), the counterpart of the JAX package's jnp path and
    the reference the kernels are held against;
  * ``ssimulacra2_subscores_from_yuv``: the kernel path of the main path —
    scale 0 from YUV 4:2:0 (ops/kernels/scale_stats.py), then the remaining
    levels from its emitted level 1 (ops/kernels/scale_tail.py).
The final 108-weight score runs on the host in f64
(models/ssimulacra2_score.py).  Layout: (B, 3, H, W) planar f32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from turbo_metrics_tpu_torch.models.ssimulacra2_score import (
    WEIGHTS,
    postprocess_score,
    weight_needs,
)
from turbo_metrics_tpu_torch.ops import colorspace
from turbo_metrics_tpu_torch.ops.downscale import downscale_by_2, scale_dims
from turbo_metrics_tpu_torch.ops.gaussian import blur_2d, gaussian_taps
from turbo_metrics_tpu_torch.ops.kernels.scale_stats import (
    fused_scale0_yuv,
    norms_from_sums,
)
from turbo_metrics_tpu_torch.ops.kernels.scale_tail import fused_pyramid_tail
from turbo_metrics_tpu_torch.ops.ssim_maps import scale_norms
from turbo_metrics_tpu_torch.ops.xyb import (
    OPSIN_ABSORBANCE_BIAS,
    OPSIN_ABSORBANCE_BIAS_ROOT,
    OPSIN_ABSORBANCE_MATRIX,
    linear_rgb_to_xyb,
    opsin_vector,
)

NUM_SCALES = 6
MATRIX_NAMES = ("bt709", "bt601_525", "bt601_625", "bt2020")


def _apply_needs_mask(out: torch.Tensor, needs) -> torch.Tensor:
    """Zero the (..., 3, S, 2, 3) sub-scores whose weight is zero, so every
    route emits the same zero pattern as the JAX package
    (``weight_needs``: 56 of the 108 weights are zero)."""
    m = np.zeros((3, len(needs), 2, 3), np.float32)
    for s, per_ch in enumerate(needs):
        for c in range(3):
            for k in range(6):
                if per_ch[c][k]:
                    m[c, s, k % 2, k // 2] = 1.0
    return out * torch.from_numpy(m).to(out.device)


def ssimulacra2_subscores(
    lin_ref: torch.Tensor,
    lin_dis: torch.Tensor,
    *,
    num_scales: int,
    taps=None,
    opsin=None,
) -> torch.Tensor:
    """Plain sub-scores for (B, 3, H, W) f32 linear-RGB frame pairs.

    Output: (B, 3, num_scales, 2, 3) f32.  Blurs five quantities per level
    (mu1, mu2, sigma11, sigma22, sigma12), like the reference's fused blur
    launch (ssimulacra2-cuda/src/kernel.rs:219-277).
    """
    per_scale = []
    for s in range(num_scales):
        if s:
            lin_ref = downscale_by_2(lin_ref)
            lin_dis = downscale_by_2(lin_dis)
        xyb1 = linear_rgb_to_xyb(lin_ref, opsin=opsin)
        xyb2 = linear_rgb_to_xyb(lin_dis, opsin=opsin)
        stacked = torch.cat([xyb1, xyb2, xyb1 * xyb1, xyb2 * xyb2, xyb1 * xyb2], dim=1)
        mu1, mu2, s11, s22, s12 = torch.chunk(blur_2d(stacked, taps=taps), 5, dim=1)
        per_scale.append(scale_norms(xyb1, xyb2, mu1, mu2, s11, s22, s12))
    return _apply_needs_mask(torch.stack(per_scale, dim=2), weight_needs(num_scales))


def subscores_from_sums(sums_per_level: list, dims) -> torch.Tensor:
    """Per-level (B, 3, 6) sums at pyramid ``dims`` -> masked (B, 3, S, 2, 3)
    sub-scores."""
    per = [norms_from_sums(s, lh * lw) for s, (lh, lw) in zip(sums_per_level, dims)]
    return _apply_needs_mask(torch.stack(per, dim=2), weight_needs(len(dims)))


def ssimulacra2_subscores_from_yuv(
    y2: torch.Tensor,
    uv2: torch.Tensor,
    taps: torch.Tensor,
    opsin: torch.Tensor,
    *,
    num_scales: int,
    depth: int = 8,
    matrix: str = "bt709",
    transfer: str = "bt709",
    full_range: bool = False,
    kr_kb=None,
) -> torch.Tensor:
    """Sub-scores straight from (2, B, h, w) luma + (2, B, ch, cw, 2) chroma.

    Scale 0 runs conversion-fused (kernel 1, full-resolution linear RGB never
    stored); the remaining ``num_scales - 1`` levels run from its emitted
    level 1 (kernel 2).  Returns (B, 3, num_scales, 2, 3) f32.
    """
    h, w = y2.shape[-2], y2.shape[-1]
    sums0, level1 = fused_scale0_yuv(
        y2, uv2, taps, opsin, depth=depth, matrix=matrix, transfer=transfer,
        full_range=full_range, emit_ds=num_scales > 1, kr_kb=kr_kb,
    )
    levels = [sums0]
    if num_scales > 1:
        tail = fused_pyramid_tail(level1, num_scales - 1, taps, opsin)
        levels += list(tail.unbind(1))
    return subscores_from_sums(levels, scale_dims(h, w, num_scales))


def builtin_constants() -> dict:
    """The constants that stand in for weights, as numpy arrays: the 108
    score weights, the 11 blur taps (f64), the opsin matrix, bias and bias
    root, and the (kr, kb) pair of each YCbCr matrix (``MATRIX_NAMES``)."""
    return {
        "weights": WEIGHTS.copy(),
        "taps": gaussian_taps().copy(),
        "opsin_matrix": OPSIN_ABSORBANCE_MATRIX.copy(),
        "opsin_bias": np.float32(OPSIN_ABSORBANCE_BIAS),
        "opsin_bias_root": np.float32(OPSIN_ABSORBANCE_BIAS_ROOT),
        "matrix_kr_kb": np.array(
            [colorspace.MATRIX_KR_KB[m] for m in MATRIX_NAMES], dtype=np.float64
        ),
    }


def resolve_device(device) -> torch.device:
    """An explicit device; CUDA must be present when asked for.

    On CUDA, TF32 is switched off for matmul and cuDNN: the blur's tap sums
    must stay exact in f32 (a 1.3e-6 tap-sum error moves the score ~0.05).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but CUDA is not available "
                "(pass device='cpu' / --device cpu to run the plain path)"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class Ssimulacra2(nn.Module):
    """Per-resolution SSIMULACRA2 scorer on an explicit device.

    Buffers ``taps`` and ``opsin`` hold the blur taps and the opsin matrix
    (9 entries, bias, bias root) as f32 on the device, where the kernels read
    them; the f64 score weights and the YCbCr (kr, kb) pairs stay on the host,
    where they are used.  ``constants_from_numpy`` installs replacements.
    """

    def __init__(self, width: int, height: int, *, device="cuda"):
        super().__init__()
        self.width = int(width)
        self.height = int(height)
        self.dims = scale_dims(self.height, self.width, NUM_SCALES)
        self.num_scales = len(self.dims)
        if self.num_scales == 0:
            raise ValueError("image must be at least 8x8")
        dev = resolve_device(device)
        self.register_buffer("taps", torch.empty(11, dtype=torch.float32, device=dev))
        self.register_buffer("opsin", torch.empty(11, dtype=torch.float32, device=dev))
        self.constants_from_numpy(builtin_constants())

    @property
    def device(self) -> torch.device:
        return self.taps.device

    def constants_from_numpy(self, d: dict) -> None:
        """Install constants given as numpy arrays (``builtin_constants``
        keys), e.g. the JAX package's, into the module."""
        taps = np.asarray(d["taps"], dtype=np.float64).astype(np.float32)
        opsin = opsin_vector(d["opsin_matrix"], d["opsin_bias"], d["opsin_bias_root"])
        with torch.no_grad():
            self.taps.copy_(torch.from_numpy(taps))
            self.opsin.copy_(torch.from_numpy(opsin))
        self.weights = np.asarray(d["weights"], dtype=np.float64).copy()
        kr_kb = np.asarray(d["matrix_kr_kb"], dtype=np.float64)
        self.kr_kb = {m: (float(kr_kb[i, 0]), float(kr_kb[i, 1])) for i, m in enumerate(MATRIX_NAMES)}

    @torch.no_grad()
    def forward(self, lin_ref: torch.Tensor, lin_dis: torch.Tensor) -> torch.Tensor:
        """Kernel-path sub-scores of (B, 3, H, W) linear-RGB pairs: the whole
        pyramid through kernel 2, starting at full resolution."""
        p12 = torch.stack([lin_ref, lin_dis]).to(self.device, torch.float32).contiguous()
        sums = fused_pyramid_tail(p12, self.num_scales, self.taps, self.opsin)
        return subscores_from_sums(list(sums.unbind(1)), self.dims)

    @torch.no_grad()
    def subscores_from_yuv(
        self, y2, uv2, *, depth=8, matrix="bt709", transfer="bt709", full_range=False
    ) -> torch.Tensor:
        return ssimulacra2_subscores_from_yuv(
            y2, uv2, self.taps, self.opsin, num_scales=self.num_scales,
            depth=depth, matrix=matrix, transfer=transfer, full_range=full_range,
            kr_kb=self.kr_kb[matrix],
        )

    def score(self, subscores: torch.Tensor) -> np.ndarray:
        """(B, 3, S, 2, 3) sub-scores -> (B,) f64 scores on the host."""
        vals = subscores.detach().cpu().numpy().astype(np.float64)
        return postprocess_score(vals, self.weights)

    def score_batch(self, lin_ref, lin_dis) -> np.ndarray:
        """Scores for a batch of (B, 3, H, W) frame pairs -> (B,) f64."""
        return self.score(self(torch.as_tensor(lin_ref), torch.as_tensor(lin_dis)))

    def score_pair(self, lin_ref, lin_dis) -> float:
        """Score a single (3, H, W) or (H, W, 3) linear-RGB pair."""
        return float(self.score_batch(_to_planar_batch(lin_ref), _to_planar_batch(lin_dis))[0])


def _to_planar_batch(img) -> torch.Tensor:
    img = torch.as_tensor(np.asarray(img, dtype=np.float32))
    if img.ndim == 3 and img.shape[-1] == 3 and img.shape[0] != 3:
        img = img.permute(2, 0, 1)
    if img.ndim == 3:
        img = img[None]
    return img
