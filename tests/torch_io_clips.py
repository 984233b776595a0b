"""The compressed clip pair of chip_smoke.py's phase 4g, and its record.

Run from the repository root (it writes turbo_metrics_tpu_torch/tools/clips/):

    JAX_PLATFORMS=cpu python -m tests.torch_io_clips

One seeded smooth 1920x1080 8-bit source of 16 frames is encoded twice with
cv2.VideoWriter, as tests/test_io.py encodes its clips: a VP9 MKV (the
reference) and an MPEG-2 TS (the distorted stream).  Beside them goes
``clips.json``, made by the JAX package on the CPU:

- per clip, the width, height, frame count, colour characteristics and range
  as the JAX package's probe reports them, and the sha256 of every plane of
  every frame its NativeVideoSource decodes;
- per clip, the sha256 of every RGB frame its OpenCvVideoSource decodes, with
  the cv2 version (the decode path of a machine without libav);
- the JAX package's per-frame SSIMULACRA2 of the pair, of the native frames
  and of the OpenCV frames (its engine, jitted, B=8);
- the command that made the file.

The tests import ``native_record`` and ``opencv_record`` to hold the
committed record against what the JAX package decodes from the clips now.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CLIPS = REPO / "turbo_metrics_tpu_torch" / "tools" / "clips"
WIDTH, HEIGHT, FRAMES, FPS, SEED = 1920, 1080, 16, 25, 20261017
# (file name, cv2 fourcc): the reference, then the distorted stream.
CLIP_FILES = (("ref_vp9.mkv", "VP90"), ("dis_mpeg2.ts", "MPG2"))
RECORD = "clips.json"


def source_frames(width: int = WIDTH, height: int = HEIGHT, frames: int = FRAMES,
                  seed: int = SEED) -> list[np.ndarray]:
    """Smooth moving BGR frames with a little seeded noise (uint8)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    out = []
    for i in range(frames):
        b = 120 + 70 * np.sin(xx / 82.0 + i * 0.12) * np.cos(yy / 58.0)
        g = 128 + 60 * np.cos(xx / 46.0 - i * 0.07) * np.sin(yy / 74.0 + 0.5)
        r = 110 + 50 * np.sin((xx + yy) / 106.0 + i * 0.05)
        img = np.stack([b, g, r], axis=-1) + rng.normal(0, 0.6, (height, width, 3))
        out.append(np.clip(np.round(img), 0, 255).astype(np.uint8))
    return out


def encode(path: Path, fourcc: str, frames: list[np.ndarray], fps: int = FPS) -> None:
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2.VideoWriter cannot encode {fourcc} into {path.name}")
    for f in frames:
        vw.write(f)
    vw.release()


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def frame_planes(f) -> list[str]:
    """The sha256 of a decoded YUV frame's Y, U and V planes."""
    return [sha256(f.y), sha256(f.uv[..., 0]), sha256(f.uv[..., 1])]


def native_record(path) -> dict:
    """What the JAX package's probe and NativeVideoSource give for a clip."""
    from turbo_metrics_tpu.io.native import NativeVideoSource
    from turbo_metrics_tpu.io.probe import create_source

    src = create_source(str(path))
    if not isinstance(src, NativeVideoSource):
        raise RuntimeError(f"{path}: the JAX package's probe did not pick its native shim")
    cc, crange = src.color_characteristics()
    rec = {
        "width": src.width,
        "height": src.height,
        "frame_count": src.frame_count(),
        "format": str(src.format_id()),
        "cp": cc.cp.name,
        "mc": cc.mc.name,
        "tc": cc.tc.name,
        "range": crange,
    }
    planes = []
    while (f := src.get_frame()) is not None:
        planes.append(frame_planes(f))
    src.close()
    rec["decoded_frames"] = len(planes)
    rec["planes_sha256"] = planes
    return rec


def opencv_record(path) -> dict:
    """The sha256 of each RGB frame of the JAX package's OpenCvVideoSource."""
    import cv2

    from turbo_metrics_tpu.io.opencv_source import OpenCvVideoSource

    src = OpenCvVideoSource(str(path))
    rgb = []
    while (f := src.get_frame()) is not None:
        rgb.append(sha256(f.rgb))
    src.close()
    return {"cv2": cv2.__version__, "rgb_sha256": rgb}


def jax_ssimulacra2(ref, dis) -> list[float]:
    """The JAX package's per-frame SSIMULACRA2 of two FrameSources, B=8."""
    from turbo_metrics_tpu.engine import Metrics, TurboMetrics

    engine = TurboMetrics(ref.width, ref.height, Metrics(ssimulacra2=True), batch=8)
    res = engine.compute_all(ref, dis)
    return [float(s) for s in res.ssimulacra2.scores]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(CLIPS), help="directory of the clips and their record")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    import cv2

    from turbo_metrics_tpu.io.opencv_source import OpenCvVideoSource
    from turbo_metrics_tpu.io.probe import create_source

    frames = source_frames()
    paths = []
    for name, fourcc in CLIP_FILES:
        encode(out / name, fourcc, frames)
        paths.append(out / name)
    clips = {}
    for path in paths:
        clips[path.name] = {
            "bytes": path.stat().st_size,
            "native": native_record(path),
            "opencv": opencv_record(path),
        }
    ref, dis = paths
    record = {
        "source": {"width": WIDTH, "height": HEIGHT, "frames": FRAMES, "fps": FPS, "seed": SEED,
                   "encoder": f"cv2.VideoWriter, cv2 {cv2.__version__}"},
        "clips": clips,
        "reference": ref.name,
        "distorted": dis.name,
        "ssimulacra2_jax_cpu": {
            "native": jax_ssimulacra2(create_source(str(ref)), create_source(str(dis))),
            "opencv": jax_ssimulacra2(OpenCvVideoSource(str(ref)), OpenCvVideoSource(str(dis))),
        },
        "command": "JAX_PLATFORMS=cpu python -m tests.torch_io_clips"
        + "".join(f" {a}" for a in (argv if argv is not None else sys.argv[1:])),
    }
    (out / RECORD).write_text(json.dumps(record, indent=1) + "\n")
    for path in paths:
        print(f"{path}: {path.stat().st_size} bytes")
    print(f"{out / RECORD}: SSIMULACRA2 {record['ssimulacra2_jax_cpu']}")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())
