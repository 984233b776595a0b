"""Frame source protocol and raw frame containers.

Counterpart of the reference's FrameSource trait + HwFrame enum
(turbo-metrics/src/lib.rs:125-156): sources yield host-side raw frames
(planar YUV 4:2:0 or packed RGB) plus colour metadata; the engine batches
them and ships them to the device.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional

import numpy as np

from turbo_metrics_tpu_torch.color.characteristics import ColorCharacteristics


@dataclass
class FormatIdentifier:
    """container/codec/decoder triple (turbo-metrics/src/lib.rs:132-146)."""

    container: Optional[str]
    codec: str
    decoder: str

    def __str__(self) -> str:
        parts = [] if self.container is None else [self.container]
        return "/".join(parts + [self.codec, self.decoder])


@dataclass
class RawFrame:
    """One decoded frame on the host, ready for device upload.

    Exactly one of the two layouts is populated:
      * Planar YUV: ``y`` (H, W) uint8/uint16 + ``uv`` (ch, cw, 2) chroma,
        where (ch, cw) follows ``chroma``: 420 -> (ceil(H/2), ceil(W/2)),
        422 -> (H, ceil(W/2)), 444 -> (H, W).  The reference is limited to
        NVDEC's 4:2:0 surfaces (NV12/P016); here full-chroma sources keep
        their chroma resolution all the way to the device conversion.
      * RGB: ``rgb`` (H, W, 3) uint8/uint16/float32 gamma-encoded — the analog
        of the reference's Npp8/16/32 image frames.
    """

    y: Optional[np.ndarray] = None
    uv: Optional[np.ndarray] = None
    rgb: Optional[np.ndarray] = None
    depth: int = 8
    full_range: bool = False
    chroma: int = 420  # 420 | 422 | 444 (4:0:0 ships neutral 420 chroma)

    @property
    def kind(self) -> str:
        # Historical name: "yuv420" means "planar YUV" (see ``chroma``).
        return "rgb" if self.rgb is not None else "yuv420"

    @property
    def height(self) -> int:
        return self.rgb.shape[0] if self.rgb is not None else self.y.shape[0]

    @property
    def width(self) -> int:
        return self.rgb.shape[1] if self.rgb is not None else self.y.shape[1]


class ResolutionChanged(RuntimeError):
    """A source reconfigured mid-stream (new resolution/format segment).

    The analog of NVDEC's sequence-callback reconfiguration
    (cudarse-video/src/dec.rs:172-195).  The source has already resized its
    buffers; ``width``/``height`` are the new dimensions and the first frame
    of the new segment will be returned by the next ``get_frame()`` call.
    """

    def __init__(self, width: int, height: int):
        super().__init__(f"stream reconfigured to {width}x{height}")
        self.width = width
        self.height = height


class FrameSource(abc.ABC):
    """Streaming source of frames (turbo-metrics/src/lib.rs:148-156)."""

    @abc.abstractmethod
    def format_id(self) -> FormatIdentifier: ...

    @property
    @abc.abstractmethod
    def width(self) -> int: ...

    @property
    @abc.abstractmethod
    def height(self) -> int: ...

    @abc.abstractmethod
    def color_characteristics(self) -> tuple[ColorCharacteristics, str]:
        """Returns (characteristics, range) with range 'limited' or 'full'."""

    @abc.abstractmethod
    def frame_count(self) -> int:
        """Total frames if known, else 0."""

    def skip_frames(self, n: int) -> None:
        for _ in range(n):
            if self.get_frame() is None:
                return

    @abc.abstractmethod
    def next_frame(self) -> Optional[RawFrame]: ...

    def get_frame(self) -> Optional[RawFrame]:
        """``next_frame`` with push-back support; callers should use this."""
        pushed = getattr(self, "_pushed_back", None)
        if pushed:
            return pushed.pop()
        return self.next_frame()

    def push_back(self, frame: RawFrame) -> None:
        """Return an already-fetched frame to the source (LIFO).  Used when a
        paired fetch is interrupted by the other stream's reconfiguration."""
        if not hasattr(self, "_pushed_back"):
            self._pushed_back: list[RawFrame] = []
        self._pushed_back.append(frame)

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


class ColorOverrideSource(FrameSource):
    """Wrap a source, overriding its colour metadata (CLI --color-* flags).

    Needed for containers that cannot signal colour (e.g. HDR content in
    Y4M, which has no colour metadata at all).
    """

    _MATRIX = {
        "bt709": ("BT709", "BT709"),
        "bt601_525": ("BT601_525", "BT601_525"),
        "bt601_625": ("BT601_625", "BT601_625"),
        "bt2020": ("BT2020", "BT2020_NCL"),
    }
    _TRANSFER = {
        "bt709": "BT709",
        "srgb": "SRGB",
        "pq": "PQ",
        "hlg": "HLG",
        "linear": "LINEAR",
    }

    def __init__(
        self,
        inner: FrameSource,
        *,
        matrix: Optional[str] = None,
        transfer: Optional[str] = None,
        crange: Optional[str] = None,
    ):
        self._inner = inner
        self._matrix = matrix
        self._transfer = transfer
        self._crange = crange

    def format_id(self) -> FormatIdentifier:
        return self._inner.format_id()

    @property
    def width(self) -> int:
        return self._inner.width

    @property
    def height(self) -> int:
        return self._inner.height

    def color_characteristics(self):
        from turbo_metrics_tpu_torch.color.characteristics import (
            ColourPrimaries,
            MatrixCoefficients,
            TransferCharacteristic,
        )

        cc, crange = self._inner.color_characteristics()
        cp, mc, tc = cc.cp, cc.mc, cc.tc
        if self._matrix:
            cp_name, mc_name = self._MATRIX[self._matrix]
            cp = ColourPrimaries[cp_name]
            mc = MatrixCoefficients[mc_name]
        if self._transfer:
            tc = TransferCharacteristic[self._TRANSFER[self._transfer]]
        if self._crange:
            crange = self._crange
        return ColorCharacteristics(cp, mc, tc), crange

    def frame_count(self) -> int:
        return self._inner.frame_count()

    def skip_frames(self, n: int) -> None:
        self._inner.skip_frames(n)

    def next_frame(self) -> Optional[RawFrame]:
        # get_frame (not next_frame) so the inner source's push-back queue is
        # honoured — e.g. the boundary frame a reconfiguring NativeVideoSource
        # holds, or a mate returned by the prefetcher at a segment boundary.
        f = self._inner.get_frame()
        if f is not None and self._crange is not None:
            f.full_range = self._crange == "full"
        return f

    def push_back(self, frame: RawFrame) -> None:
        self._inner.push_back(frame)

    def close(self) -> None:
        self._inner.close()
