"""Image input: probe by magic bytes, decode on CPU, yield RGB frames.

Parity with the reference's image path (turbo-metrics/src/input_image.rs):
probe a prefix for the container type, decode with a CPU codec (Pillow here,
zune-image/image-rs there), queue multi-frame images (animated GIF/WebP),
and hand 8/16-bit RGB to the engine, which applies the sRGB EOTF on device.
"""

from __future__ import annotations

import io
from enum import Enum
from typing import BinaryIO, Optional

import numpy as np

from turbo_metrics_tpu_torch.color.characteristics import (
    ColorCharacteristics,
    ColourPrimaries,
    MatrixCoefficients,
    TransferCharacteristic,
)
from turbo_metrics_tpu_torch.io.frame_source import FormatIdentifier, FrameSource, RawFrame

PROBE_LEN = 64


class ImageProbe(Enum):
    """Image formats recognised by magic bytes (input_image.rs:33-64)."""

    PNG = "png"
    JPEG = "jpeg"
    JPEGXL = "jpegxl"
    GIF = "gif"
    BMP = "bmp"
    QOI = "qoi"
    TIFF = "tiff"
    WEBP = "webp"
    AVIF = "avif"

    @staticmethod
    def probe(prefix: bytes) -> Optional["ImageProbe"]:
        if prefix.startswith(b"\x89PNG\r\n\x1a\n"):
            return ImageProbe.PNG
        if prefix.startswith(b"\xff\xd8\xff"):
            return ImageProbe.JPEG
        if prefix.startswith(b"\xff\x0a") or prefix[:12].endswith(b"JXL \r\n\x87\n"):
            return ImageProbe.JPEGXL
        if prefix.startswith((b"GIF87a", b"GIF89a")):
            return ImageProbe.GIF
        if prefix.startswith(b"BM"):
            return ImageProbe.BMP
        if prefix.startswith(b"qoif"):
            return ImageProbe.QOI
        if prefix.startswith((b"II*\x00", b"MM\x00*")):
            return ImageProbe.TIFF
        if prefix[:4] == b"RIFF" and prefix[8:12] == b"WEBP":
            return ImageProbe.WEBP
        if prefix[4:12] in (b"ftypavif", b"ftypavis"):
            return ImageProbe.AVIF
        return None

    def can_decode(self) -> bool:
        try:
            from PIL import Image  # noqa: F401
        except ImportError:  # pragma: no cover
            return False
        if self in (ImageProbe.JPEGXL, ImageProbe.QOI, ImageProbe.AVIF):
            # Pillow needs plugins for these; probe for support.
            from PIL import features

            codec = {"jpegxl": "jxl", "qoi": None, "avif": "avif"}[self.value]
            try:
                return codec is not None and bool(features.check(codec))
            except Exception:
                return False
        return True


SRGB_CHARACTERISTICS = ColorCharacteristics(
    ColourPrimaries.BT709, MatrixCoefficients.IDENTITY, TransferCharacteristic.SRGB
)


class ImageFrameSource(FrameSource):
    """Decodes all frames up front (images are small; input_image.rs:101-163)."""

    def __init__(self, stream: BinaryIO, probe: ImageProbe):
        from PIL import Image, ImageSequence

        self._probe = probe
        img = Image.open(io.BytesIO(stream.read()))
        self._frames: list[np.ndarray] = []
        for frame in ImageSequence.Iterator(img):
            mode = frame.mode
            if mode in ("I;16", "I;16B", "I;16L", "I", "RGB;16"):
                arr = np.asarray(frame.convert("I")).astype(np.uint16)
                rgb = np.repeat(arr[..., None], 3, axis=-1)
            elif mode == "RGB":
                rgb = np.asarray(frame, dtype=np.uint8)
            else:
                rgb = np.asarray(frame.convert("RGB"), dtype=np.uint8)
            self._frames.append(rgb)
        if not self._frames:
            raise ValueError("no frames decoded")
        self._idx = 0
        self._depth = 16 if self._frames[0].dtype == np.uint16 else 8

    def format_id(self) -> FormatIdentifier:
        return FormatIdentifier(None, self._probe.value, "pillow")

    @property
    def width(self) -> int:
        return self._frames[0].shape[1]

    @property
    def height(self) -> int:
        return self._frames[0].shape[0]

    def color_characteristics(self) -> tuple[ColorCharacteristics, str]:
        return SRGB_CHARACTERISTICS, "full"

    def frame_count(self) -> int:
        return len(self._frames)

    def skip_frames(self, n: int) -> None:
        self._idx = min(self._idx + n, len(self._frames))

    def next_frame(self) -> Optional[RawFrame]:
        if self._idx >= len(self._frames):
            return None
        rgb = self._frames[self._idx]
        self._idx += 1
        return RawFrame(rgb=rgb, depth=self._depth, full_range=True)
