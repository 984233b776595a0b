"""Per-frame values of a block of frame pairs, by the plain reference."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import colour, quality, ssimulacra2, vmaf, xpsnr

# The per-frame values each family gives, under the keys the harness's step
# gives them.
FAMILY_KEYS = {
    "ssimulacra2": ("ssimulacra2",),
    "psnr": ("psnr",),
    "ssim": ("ssim",),
    "msssim": ("msssim",),
    "xpsnr": ("xpsnr",),
    "vif": ("vmaf_vif",) + tuple(f"vmaf_vif_scale{k}" for k in range(4)),
    "adm": ("vmaf_adm",) + tuple(f"vmaf_adm_scale{k}" for k in range(4)),
    "motion": ("vmaf_motion",),
}
RGB_FAMILIES = ("ssimulacra2", "psnr", "ssim", "msssim")
LUMA_FAMILIES = ("xpsnr", "vif", "adm", "motion")


def families(metrics) -> list[str]:
    """The compared families of a configuration's metric list (``vmaf``:
    its three elementary features)."""
    out = []
    for m in metrics:
        out += ["vif", "adm", "motion"] if m == "vmaf" else [m]
    return out


def _linear(planes: tuple, fmt: dict, dtype) -> torch.Tensor:
    if fmt["kind"] == "rgb":
        return colour.srgb_to_linear(planes[0], depth=fmt["depth"], dtype=dtype)
    return colour.yuv_to_linear_rgb(
        planes[0], planes[1], depth=fmt["depth"], chroma=fmt["chroma"], matrix=fmt["matrix"],
        transfer=fmt["transfer"], full_range=fmt["range"] == "full", dtype=dtype,
    )


def _aligned(y: torch.Tensor, from_depth: int, to_depth: int) -> torch.Tensor:
    y = y.to(torch.int64)
    return y << (to_depth - from_depth) if to_depth >= from_depth else y >> (from_depth - to_depth)


def frame_scores(ref: tuple, dis: tuple, prev_luma: torch.Tensor, fmt_ref: dict, fmt_dis: dict, metrics,
                 *, control: bool = False) -> dict[str, np.ndarray]:
    """The per-frame values of B frame pairs: ``ref``/``dis`` the raw planes
    ((B, h, w) luma, (B, ch, cw, 2) chroma; or (B, h, w, 3) sRGB),
    ``prev_luma`` (B, h, w) the luma codes of each frame's previous
    reference.  ``control``: every plane in bfloat16, the sums and the
    host's scoring of XPSNR in float32, in place of float64 (integer
    arithmetic for motion and XPSNR's grids in the reference)."""
    fams = families(metrics)
    dtype = torch.bfloat16 if control else torch.float64
    sums = torch.float32 if control else torch.float64
    out: dict[str, np.ndarray] = {}
    if any(f in RGB_FAMILIES for f in fams):
        lin_ref, lin_dis = _linear(ref, fmt_ref, dtype), _linear(dis, fmt_dis, dtype)
        if "ssimulacra2" in fams:
            out["ssimulacra2"] = ssimulacra2.score(ssimulacra2.subscores(lin_ref, lin_dis, sums))
        if any(f in fams for f in ("psnr", "ssim", "msssim")):
            q_ref, q_dis = quality.quantize(lin_ref), quality.quantize(lin_dis)
            if "psnr" in fams:
                out["psnr"] = quality.psnr(q_ref, q_dis)
            if "ssim" in fams or "msssim" in fams:
                out["ssim"], out["msssim"] = quality.ssim_msssim(q_ref, q_dis, sums)
        del lin_ref, lin_dis
    if any(f in LUMA_FAMILIES for f in fams):
        if fmt_ref["kind"] != "yuv" or fmt_dis["kind"] != "yuv":
            raise ValueError("the luma families take planar Y'CbCr inputs")
        depth = fmt_ref["depth"]
        y_ref = ref[0].to(torch.int64)
        y_dis = _aligned(dis[0], fmt_dis["depth"], depth)
        exact = torch.int64 if not control else dtype
        if "xpsnr" in fams:
            out["xpsnr"] = xpsnr.xpsnr(y_ref, y_dis, prev_luma, depth=depth, dtype=torch.float64 if not control
                                       else dtype, sum_dtype=sums)
        if "motion" in fams:
            blur = vmaf.motion_blur(y_ref, depth=depth, dtype=exact)
            blur_prev = vmaf.motion_blur(prev_luma, depth=depth, dtype=exact)
            out["vmaf_motion"] = vmaf.motion(blur, blur_prev, sums)
        if "vif" in fams or "adm" in fams:
            unit = 255.0 / ((1 << depth) - 1)
            r8, d8 = y_ref.to(dtype) * unit, y_dis.to(dtype) * unit
            if "vif" in fams:
                out.update({f"vmaf_{k}": v for k, v in vmaf.vif(r8, d8, sums).items()})
            if "adm" in fams:
                out.update({f"vmaf_{k.replace('adm2', 'adm')}": v for k, v in vmaf.adm(r8, d8, sums).items()})
    keep = {k for f in fams for k in FAMILY_KEYS[f]}
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items() if k in keep}
