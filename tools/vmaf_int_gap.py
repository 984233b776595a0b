"""How far VMAF's fixed-point VIF and ADM lie from the float features on
chip_smoke.py's 1080p pair, on the CPU.

chip_smoke.py's path (d-int) holds the card's fixed-point vif and adm2
within ``INT_VS_FLOAT`` of path (d)'s float features.  That bar is a sanity
bar (the same metric at other arithmetic), so it is set from what the
reference schedule itself gives on that pair: this script computes, for the
first frames of chip_smoke.py's seeded 8-bit 4:2:0 pair, the JAX package's
integer and float vif and adm2 (jitted, one frame at a time) and the same
through the port's plain versions (ops/integer_vif.py, ops/integer_adm.py,
ops/vif.py, ops/adm.py), and prints each gap beside the bar.

Usage:
    JAX_PLATFORMS=cpu python tools/vmaf_int_gap.py [--frames 2]

Two frames take about 25 s.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_luma(path: str, width: int, height: int, frames: int) -> np.ndarray:
    """The Y planes of the first ``frames`` frames of an 8-bit 4:2:0 Y4M."""
    with open(path, "rb") as f:
        data = f.read()
    at = data.index(b"\n") + 1
    size = width * height * 3 // 2
    out = []
    for _ in range(frames):
        at += len(b"FRAME\n")
        out.append(np.frombuffer(data, np.uint8, width * height, at).reshape(height, width))
        at += size
    return np.stack(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args(argv)

    import jax
    import torch

    from chip_smoke import HEIGHT, INT_VS_FLOAT, WIDTH, write_y4m_pair
    from turbo_metrics_tpu.ops import adm as jadm
    from turbo_metrics_tpu.ops import vif as jvif
    from turbo_metrics_tpu_torch.ops import adm as tadm
    from turbo_metrics_tpu_torch.ops import integer_adm as tia
    from turbo_metrics_tpu_torch.ops import integer_vif as tiv
    from turbo_metrics_tpu_torch.ops import vif as tvif

    with tempfile.TemporaryDirectory() as tmp:
        ref_path, dis_path = write_y4m_pair(tmp, frames=args.frames)
        ref = read_luma(ref_path, WIDTH, HEIGHT, args.frames)
        dis = read_luma(dis_path, WIDTH, HEIGHT, args.frames)

    jax_int = (jax.jit(lambda a, b: jvif.vif_scale_stats(a, b, integer=True)),
               jax.jit(lambda a, b: jadm.adm_stats(a, b, integer=True)))
    jax_flt = (jax.jit(lambda a, b: jvif.vif_scale_stats(a, b, backend="jnp")),
               jax.jit(lambda a, b: jadm.adm_stats(a, b, backend="jnp")))
    rows = {"jax": [], "port": []}
    for i in range(args.frames):
        r, d = ref[i : i + 1], dis[i : i + 1]
        rf, df = r.astype(np.float32), d.astype(np.float32)
        for name, (vif_i, adm_i, vif_f, adm_f) in {
            "jax": (np.asarray(jax_int[0](r, d)), np.asarray(jax_int[1](r, d)),
                    np.asarray(jax_flt[0](rf, df)), np.asarray(jax_flt[1](rf, df))),
            "port": (tiv.integer_vif_stats(torch.from_numpy(r), torch.from_numpy(d)).numpy(),
                     tia.integer_adm_stats(torch.from_numpy(r), torch.from_numpy(d)).numpy(),
                     tvif.vif_scale_stats(torch.from_numpy(rf), torch.from_numpy(df)).numpy(),
                     tadm.adm_stats(torch.from_numpy(rf), torch.from_numpy(df)).numpy()),
        }.items():
            feats = tuple(float(v) for v in (
                tvif.vif_scores(vif_i)["vif"][0], tvif.vif_scores(vif_f)["vif"][0],
                tadm.adm_score(adm_i, HEIGHT, WIDTH)["adm2"][0], tadm.adm_score(adm_f, HEIGHT, WIDTH)["adm2"][0]))
            rows[name].append(feats)
            print(f"frame {i} {name}: vif integer {feats[0]!r} float {feats[1]!r}; "
                  f"adm2 integer {feats[2]!r} float {feats[3]!r}", flush=True)
    for name, feats in rows.items():
        a = np.array(feats)
        print(f"{name}: max |integer - float| over {args.frames} frames: vif {float(np.abs(a[:, 0] - a[:, 1]).max())!r} "
              f"(bar {INT_VS_FLOAT['vmaf_vif']}), adm2 {float(np.abs(a[:, 2] - a[:, 3]).max())!r} "
              f"(bar {INT_VS_FLOAT['vmaf_adm']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
