"""Entry points: the flagship step on one device, and a dry run over a mesh.

The port's counterparts of the JAX package's ``__graft_entry__.entry`` and
``__graft_entry__.dryrun_multichip``.  ``dryrun_multichip`` runs the tiny
multi-metric step through ``shard_over_frames``, then the user-facing
``TurboMetrics(mesh=...)`` with PSNR, SSIMULACRA2, XPSNR and VMAF (its fused
score from a fixture model), and checks what the JAX dry run asserts.

    python -m turbo_metrics_tpu_torch.parallel.dryrun 2 --device cuda:0   # two shards on one card
    python -m turbo_metrics_tpu_torch.parallel.dryrun 8 --device cpu
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

# The JAX dry run's fusion model: the genuine vmaf_v0.6.1.json is not
# redistributable.
FIXTURE_FEATURES = (
    ["VMAF_feature_adm2_score", "VMAF_feature_motion2_score"]
    + [f"VMAF_feature_vif_scale{k}_score" for k in range(4)]
)
FIXTURE_SVM = (
    "svm_type nu_svr\nkernel_type rbf\ngamma 0.05\nnr_class 2\n"
    "total_sv 2\nrho -1.25\nSV\n"
    "0.75 1:0.9 2:0.1 3:0.8 4:0.85 5:0.9 6:0.95\n"
    "-0.25 1:0.4 2:0.6 3:0.3 4:0.35 5:0.4 6:0.45\n"
)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run: {what}")


def fixture_model():
    """The dry run's VMAF fusion model (models.vmaf_model.VmafModel)."""
    from turbo_metrics_tpu_torch.models.vmaf_model import VmafModel

    return VmafModel.from_dict({
        "model_dict": {
            "model_type": "LIBSVMNUSVR",
            "feature_names": FIXTURE_FEATURES,
            "norm_type": "linear_rescale",
            "slopes": [0.01, 1.0, 0.5, 1.0, 1.0, 1.0, 1.0],
            "intercepts": [-0.1, 0.0, 0.05, 0.0, 0.0, 0.0, 0.0],
            "score_clip": [0.0, 100.0],
            "model": FIXTURE_SVM,
        }
    })


def entry(device="cuda"):
    """(fn, example_args) for the flagship forward step: the batched
    SSIMULACRA2 sub-score pipeline on (B, 3, H, W) linear-RGB frame pairs
    on ``device`` (the kernel route on the card, the plain twins on the
    CPU)."""
    from turbo_metrics_tpu_torch.models.ssimulacra2 import resolve_device, ssimulacra2_subscores
    from turbo_metrics_tpu_torch.ops.downscale import scale_dims

    dev = resolve_device(device)
    h, w, b = 64, 96, 2
    fn = functools.partial(ssimulacra2_subscores, num_scales=len(scale_dims(h, w)), backend="auto")
    rng = np.random.default_rng(0)
    ref = rng.random((b, 3, h, w), dtype=np.float32)
    dis = np.clip(ref + rng.normal(0, 0.02, ref.shape).astype(np.float32), 0, 1)
    return fn, (torch.from_numpy(ref).to(dev), torch.from_numpy(dis).to(dev))


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """The full multi-metric compute step over a mesh of ``n_devices``
    shards (parallel.mesh.make_mesh: ``cuda`` takes that many cards, a
    device with an index that many shards of it, ``cpu`` that many CPU
    shards), one step on tiny shapes, two frame pairs per shard; then the
    engine over the same mesh, its scores fused.  Raises RuntimeError on
    any failed check."""
    from turbo_metrics_tpu_torch.color.characteristics import height_fallback
    from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics, _VmafFuser, vmaf_pair
    from turbo_metrics_tpu_torch.io.frame_source import RawFrame
    from turbo_metrics_tpu_torch.models.ssimulacra2 import Ssimulacra2, resolve_device
    from turbo_metrics_tpu_torch.ops.kernels.adm import adm_stats
    from turbo_metrics_tpu_torch.ops.kernels.convert import yuv420_to_linear_rgb_pair
    from turbo_metrics_tpu_torch.ops.kernels.vif import vif_scale_stats
    from turbo_metrics_tpu_torch.ops.kernels.xpsnr import xpsnr_block_stats
    from turbo_metrics_tpu_torch.ops.quality import Quality
    from turbo_metrics_tpu_torch.parallel.mesh import make_mesh, shard_over_frames

    mesh = make_mesh(n_devices, device=device)
    h, w = 48, 64
    b = 2 * mesh.size  # 2 frame pairs per shard
    models = {}
    for dev in mesh.distinct_devices():
        resolve_device(dev)
        models[dev] = (Ssimulacra2(w, h, device=dev), Quality(device=dev))
    num_scales = models[mesh.devices[0]][0].num_scales

    def step(y_ref, uv_ref, y_dis, uv_dis):
        s2, qmod = models[y_ref.device]
        p12 = yuv420_to_linear_rgb_pair(torch.stack([y_ref, y_dis]), torch.stack([uv_ref, uv_dis]))
        out = qmod.from_rgb(p12, psnr=True, ssim=True, msssim=True)
        pair = vmaf_pair(y_ref, y_dis, 8, 8)
        out.update(
            ssimulacra2=s2.subscores_from_rgb(p12),
            xpsnr=xpsnr_block_stats(y_ref, y_dis, y_ref[0]),
            vif=vif_scale_stats(pair),
            adm=adm_stats(pair),
        )
        return out

    fn = shard_over_frames(step, mesh, in_ndims=(3, 4, 3, 4))
    rng = np.random.default_rng(0)
    y = rng.integers(16, 236, (b, h, w), dtype=np.uint8)
    uv = rng.integers(16, 240, (b, h // 2, w // 2, 2), dtype=np.uint8)
    y2 = np.clip(y.astype(np.int16) + rng.integers(-5, 6, y.shape), 0, 255).astype(np.uint8)

    out = fn(y, uv, y2, uv)
    _check(out["psnr"].shape == (b,), f"psnr has the shape {tuple(out['psnr'].shape)}")
    _check(out["ssimulacra2"].shape == (b, 3, num_scales, 2, 3),
           f"the sub-scores have the shape {tuple(out['ssimulacra2'].shape)}")
    _check(bool(torch.isfinite(out["psnr"].cpu()).all()), "a PSNR is not finite")

    # The user-facing engine over the same mesh, with VMAF (its one edge
    # between shards: each shard's first motion frame against the previous
    # shard's last reference frame) and the fixture fusion model.
    cc = (height_fallback(h), "limited")
    f_ref = [RawFrame(y=y[i], uv=uv[i], depth=8) for i in range(b)]
    f_dis = [RawFrame(y=y2[i], uv=uv[i], depth=8) for i in range(b)]
    model = fixture_model()
    eng = TurboMetrics(
        w, h, Metrics(psnr=True, ssimulacra2=True, xpsnr=True, vmaf=True),
        batch=b, mesh=mesh, vmaf_model=model,
    )
    scores = eng.compute_frames(f_ref, cc, f_dis, cc)
    _check(len(scores) == b, f"the engine scored {len(scores)} frames")
    _check(all(np.isfinite(s.psnr) and np.isfinite(s.ssimulacra2) for s in scores),
           "a PSNR or SSIMULACRA2 score is not finite")
    _check(all(np.isfinite(s.vmaf_motion) and np.isfinite(s.vmaf_vif) for s in scores),
           "a VMAF motion or VIF score is not finite")
    # Fuse the scores (one batch: motion2's look-ahead within it).
    fuser = _VmafFuser(model)
    fused = [f for s in scores if (f := fuser.push(s)) is not None]
    tail = fuser.flush()
    if tail is not None:
        fused.append(tail)
    _check(len(fused) == b, f"the fuser gave {len(fused)} scores")
    _check(all(np.isfinite(s.vmaf) and 0.0 <= s.vmaf <= 100.0 for s in fused),
           "a fused VMAF score is not finite or outside [0, 100]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, help="shards of the mesh")
    ap.add_argument("--device", default="cuda", help="cuda (that many cards), cuda:K (that many shards of "
                    "card K) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    print(f"dry run over {args.n_devices} shards of {args.device}: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
