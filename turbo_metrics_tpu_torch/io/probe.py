"""Input probing: image first, then video container (CLI main.rs:176-210).

The JAX package's order (turbo_metrics_tpu/io/probe.py): peek a prefix, try
the image magic table (io/image.py, Pillow); then Y4M (io/y4m.py); else hand
the input to the native libav shim (io/native.py), which recognises
MKV/MP4/TS/IVF/raw elementary streams, by path or, for stdin and other pipes,
streaming through AVIO read callbacks (no temp-file spill); where the shim is
unavailable, OpenCV (io/opencv_source.py, paths only, lower colour fidelity);
else an error that names the stream's container, codec and geometry.  MKV
inputs are also parsed by the pure-Python EBML demuxer (io/mkv.py) to
cross-check geometry and to supply colour metadata / frame counts that
libav's codec-level probe may miss (MKV Colour elements live in the
container, not the bitstream).
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import BinaryIO, Optional, Union

from turbo_metrics_tpu_torch.io.frame_source import FrameSource
from turbo_metrics_tpu_torch.io.image import PROBE_LEN, ImageFrameSource, ImageProbe
from turbo_metrics_tpu_torch.io.ivf import IVF_MAGIC
from turbo_metrics_tpu_torch.io.mkv import EBML_MAGIC
from turbo_metrics_tpu_torch.io.y4m import Y4M_MAGIC, Y4MFrameSource

log = logging.getLogger("turbo_metrics_tpu_torch")


class ChainReader:
    """Sequential reader serving a probed prefix, then the rest of a stream.

    Lets us peek magic bytes from a non-seekable source (stdin) and still
    hand the complete byte stream to a downstream consumer.
    """

    def __init__(self, prefix: bytes, rest: BinaryIO, name: str = "<stream>"):
        self._prefix = prefix
        self._pos = 0
        self._rest = rest
        self.name = name

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            out = self._prefix[self._pos :] + self._rest.read()
            self._pos = len(self._prefix)
            return out
        out = b""
        if self._pos < len(self._prefix):
            out = self._prefix[self._pos : self._pos + n]
            self._pos += len(out)
            n -= len(out)
        if n > 0:
            out += self._rest.read(n)
        return out

    def seekable(self) -> bool:
        return False

    def close(self) -> None:
        self._rest.close()


def create_source(path: Union[str, Path], *, use_stdin: bool = False) -> FrameSource:
    """Open a media file (or '-' for stdin) as a FrameSource."""
    if use_stdin or str(path) == "-":
        raw = sys.stdin.buffer
        prefix = raw.read(PROBE_LEN)
        return _probe_stream(ChainReader(prefix, raw, name="<stdin>"), None, prefix)
    f = open(path, "rb")
    prefix = f.read(PROBE_LEN)
    f.seek(0)
    return _probe_stream(f, str(path), prefix)


def _probe_stream(f, path: Optional[str], prefix: bytes) -> FrameSource:
    img = ImageProbe.probe(prefix)
    if img is not None:
        if not img.can_decode():
            raise ValueError(f"detected {img.value} but no decoder is available")
        src = ImageFrameSource(f, img)
        f.close()
        return src

    if prefix.startswith(Y4M_MAGIC):
        return Y4MFrameSource(f, path=path)

    # Everything else (IVF, MKV, MP4, TS, elementary streams) goes through
    # the native libav shim — by path when we have one, else streaming via
    # AVIO callbacks (no temp-file spill).
    from turbo_metrics_tpu_torch.io import native

    if native.native_available():
        meta = None
        if path is not None and prefix.startswith(EBML_MAGIC):
            meta = _mkv_container_meta(path)
        if path is not None:
            f.close()
            return native.NativeVideoSource(path, container_meta=meta)
        return native.NativeVideoSource(stream=f)

    # Fallback decode backend (lower colour fidelity; see opencv_source.py).
    from turbo_metrics_tpu_torch.io import opencv_source

    why = native.SHIM.error()
    unavailable = "native demuxer unavailable" + (f" ({why})" if why else "")
    if opencv_source.opencv_available() and path is not None:
        log.warning(
            "%s: %s; decoding with OpenCV, whose frames are 8-bit RGB converted "
            "by swscale with BT.601 whatever the stream signals: lower colour "
            "fidelity",
            path, unavailable,
        )
        f.close()
        return opencv_source.OpenCvVideoSource(path)

    description = _describe_stream(f, path, prefix)
    f.close()
    raise RuntimeError(
        f"no video decode backend available for {description}: {unavailable}"
        + ("" if path is not None else "; OpenCV cannot read stdin")
        + "; install FFmpeg's libavformat, libavcodec and libavutil with their "
        "development files, or OpenCV"
    )


def _mkv_container_meta(path: str) -> Optional[dict]:
    """Header-only parse of an MKV file with the pure-Python EBML demuxer:
    colour metadata (MKV Colour elements), dimensions and a frame-count
    estimate to cross-check/enrich libav's stream info."""
    from turbo_metrics_tpu_torch.color.characteristics import ColorCharacteristics
    from turbo_metrics_tpu_torch.io.mkv import MkvDemuxer

    try:
        with open(path, "rb") as g:
            mkv = MkvDemuxer(g)
            t = mkv.video_track
            if t is None:
                return None
            cc = ColorCharacteristics.from_code_points(
                t.colour_primaries, t.colour_matrix, t.colour_transfer
            )
            crange = {1: "limited", 2: "full"}.get(t.colour_range)
            return {
                "width": t.pixel_width,
                "height": t.pixel_height,
                "codec": t.codec,
                "frame_count": mkv.frame_count_estimate(),
                "cc": cc,
                "range": crange,
            }
    except Exception as e:  # malformed container: let libav be the judge
        log.debug("MKV header cross-check failed: %s", e)
        return None


def _describe_stream(f, path: Optional[str], prefix: bytes) -> str:
    """Best-effort description of an undecodable input using the pure-Python
    demuxers (io/ivf.py, io/mkv.py) so the error names codec and geometry."""
    what = path or getattr(f, "name", "<stream>")
    try:
        if prefix.startswith(IVF_MAGIC) and path is not None:
            from turbo_metrics_tpu_torch.io import ivf

            with open(path, "rb") as g:
                hdr = ivf.read_header(g)
            return (
                f"{what} (IVF, codec={hdr.codec or hdr.fourcc}, "
                f"{hdr.width}x{hdr.height}, {hdr.frames} frames)"
            )
        if prefix.startswith(EBML_MAGIC) and path is not None:
            meta = _mkv_container_meta(path)
            if meta:
                return (
                    f"{what} (Matroska, codec={meta['codec']}, "
                    f"{meta['width']}x{meta['height']}, "
                    f"~{meta['frame_count']} frames)"
                )
    except Exception:
        pass
    return str(what)
