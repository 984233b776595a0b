"""Alternative decode backend: OpenCV VideoCapture (FFmpeg wrapped).

The inventory role of the reference's AMD AMF backend groundwork (amf/
amf-sys crates — a second decode path behind the primary one).  Used when
the native libturbodemux shim is unavailable.  OpenCV converts decoded
frames to 8-bit BGR via swscale (BT.601), so colour fidelity is lower than
the native path — frames are exposed as gamma RGB and the engine treats
them like image input.  Prefer NativeVideoSource when present.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from turbo_metrics_tpu_torch.color.characteristics import ColorCharacteristics
from turbo_metrics_tpu_torch.io.frame_source import FormatIdentifier, FrameSource, RawFrame
from turbo_metrics_tpu_torch.io.image import SRGB_CHARACTERISTICS


def opencv_available() -> bool:
    try:
        import cv2  # noqa: F401

        return True
    except ImportError:  # pragma: no cover
        return False


class OpenCvVideoSource(FrameSource):
    def __init__(self, path: str):
        import cv2

        self._cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
        if not self._cap.isOpened():
            raise ValueError(f"OpenCV could not open video: {path}")
        self._w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self._h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self._count = max(0, int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)))

    def format_id(self) -> FormatIdentifier:
        return FormatIdentifier(None, "video", "opencv-ffmpeg")

    @property
    def width(self) -> int:
        return self._w

    @property
    def height(self) -> int:
        return self._h

    def color_characteristics(self) -> tuple[ColorCharacteristics, str]:
        # swscale already applied the YCbCr matrix; frames arrive as gamma
        # RGB, handled like decoded images.
        return SRGB_CHARACTERISTICS, "full"

    def frame_count(self) -> int:
        return self._count

    def next_frame(self) -> Optional[RawFrame]:
        ok, frame = self._cap.read()
        if not ok:
            return None
        rgb = np.ascontiguousarray(frame[:, :, ::-1])  # BGR -> RGB
        return RawFrame(rgb=rgb, depth=8, full_range=True)

    def close(self) -> None:
        self._cap.release()
