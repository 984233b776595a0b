"""ctypes bindings for the native turbodemux shim (native/turbodemux.cpp).

Host-side decode: libavformat/libavcodec demux + decode to planar YUV with
full colour metadata, the port's replacement for the reference's NVDEC path
(cudarse-video): decode happens on the host CPU and frames stream to the
device, the mode the reference itself plans for (README.md:66-70).

The port builds its own copy of the shim at first use, from the repository's
``native/turbodemux.cpp`` (read only) with the flags of ``native/Makefile``,
into the package's git-ignored ``_build/`` directory under a name keyed on a
hash of the source and the command; it never loads or writes the copy that
the JAX package builds in ``native/``.  Where the shim neither loads nor
builds, the error quotes the compiler's or the loader's message and names the
libav libraries that are missing (``libav_probe``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from turbo_metrics_tpu_torch.color.characteristics import ColorCharacteristics, height_fallback
from turbo_metrics_tpu_torch.io.frame_source import (
    FormatIdentifier,
    FrameSource,
    RawFrame,
    ResolutionChanged,
)

log = logging.getLogger("turbo_metrics_tpu_torch")

_PKG = Path(__file__).resolve().parents[1]
SHIM_SOURCE = _PKG.parent / "native" / "turbodemux.cpp"
BUILD_DIR = _PKG / "_build"
LIBAV = ("libavformat", "libavcodec", "libavutil")
# native/Makefile: CXXFLAGS, -shared, LDLIBS.
CXXFLAGS = ("-O2", "-fPIC", "-Wall", "-shared")
LDLIBS = ("-lavformat", "-lavcodec", "-lavutil")


class _TmInfo(ctypes.Structure):
    """``struct TmInfo`` of native/turbodemux.cpp, field for field."""

    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("depth", ctypes.c_int32),
        ("chroma", ctypes.c_int32),
        ("color_primaries", ctypes.c_int32),
        ("color_trc", ctypes.c_int32),
        ("color_space", ctypes.c_int32),
        ("full_range", ctypes.c_int32),
        ("frame_count", ctypes.c_int64),
        ("codec_name", ctypes.c_char * 32),
        ("container_name", ctypes.c_char * 32),
        ("time_base_num", ctypes.c_int32),
        ("time_base_den", ctypes.c_int32),
        ("fps_num", ctypes.c_int32),
        ("fps_den", ctypes.c_int32),
        ("start_pts", ctypes.c_int64),
    ]


# AVIO callback signatures (native/turbodemux.cpp tm_open_io).
_READ_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int
)
_SEEK_CB = ctypes.CFUNCTYPE(
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
)
_AVSEEK_SIZE = 0x10000


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX") or "g++")


def _pkg_config(*args: str) -> tuple[int, str]:
    """(exit code, output) of ``pkg-config args``; (-1, why) without it."""
    exe = shutil.which("pkg-config")
    if exe is None:
        return -1, "pkg-config not found"
    res = subprocess.run([exe, *args], capture_output=True, text=True, timeout=60)
    return res.returncode, (res.stdout + res.stderr).strip()


def libav_probe() -> dict:
    """What this machine has for building and loading the shim, found
    without building or decoding anything: the C++ compiler, pkg-config's
    versions of the libav libraries, the loader's shared objects, and the
    libraries of which neither a shared object nor development files were
    found (``missing``)."""
    rc, versions = _pkg_config("--modversion", *LIBAV)
    versions = ", ".join(f"{n} {v}" for n, v in zip(LIBAV, versions.split()))
    dev = {}
    for name in LIBAV:
        dev[name] = _pkg_config("--exists", name)[0] == 0
    shared = {name: ctypes.util.find_library(name[3:]) for name in LIBAV}
    return {
        "compiler": _compiler(),
        "pkg_config": versions if rc == 0 else None,
        "shared_objects": shared,
        "development_files": dev,
        "missing": [n for n in LIBAV if not shared[n] and not dev[n]],
    }


def describe_missing(probe: dict) -> str:
    """The probe's findings as one clause for an error message."""
    parts = []
    if probe["missing"]:
        parts.append(
            "libav libraries missing (no shared object, no pkg-config entry): "
            + ", ".join(probe["missing"])
        )
    no_dev = [n for n, ok in probe["development_files"].items() if not ok and n not in probe["missing"]]
    if no_dev:
        parts.append("no development files (headers, pkg-config) for " + ", ".join(no_dev))
    if probe["compiler"] is None:
        parts.append("no C++ compiler (g++ or $CXX)")
    return "; ".join(parts) or "libav and a C++ compiler were found"


def _build_command(out: Path) -> list[str]:
    cmd = [_compiler() or "g++", *CXXFLAGS]
    rc, flags = _pkg_config("--cflags", "--libs", *LIBAV)
    if rc == 0:
        cmd += [str(SHIM_SOURCE), "-o", str(out), *flags.split()]
    else:
        cmd += [str(SHIM_SOURCE), "-o", str(out), *LDLIBS]
    return cmd


class ShimUnavailable(RuntimeError):
    """The native shim neither loads nor builds on this machine."""


class DemuxLibrary:
    """The port's build of the shim, built and loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._error: Optional[str] = None
        self.path: Optional[Path] = None
        self.built = False  # True where this process compiled the shim

    def get(self) -> ctypes.CDLL:
        """The loaded shim; raises ShimUnavailable with the reason."""
        with self._lock:
            if self._lib is None and self._error is None:
                try:
                    self._lib = self._load()
                except ShimUnavailable as e:
                    self._error = str(e)
            if self._lib is None:
                raise ShimUnavailable(self._error)
            return self._lib

    def error(self) -> Optional[str]:
        """Why the shim is unavailable, or None where it loads."""
        try:
            self.get()
        except ShimUnavailable as e:
            return str(e)
        return None

    def _load(self) -> ctypes.CDLL:
        if not SHIM_SOURCE.is_file():
            raise ShimUnavailable(f"shim source {SHIM_SOURCE} not found")
        cmd = _build_command(Path("OUT"))
        key = hashlib.sha256(SHIM_SOURCE.read_bytes() + " ".join(cmd).encode()).hexdigest()[:16]
        path = BUILD_DIR / f"libturbodemux_{key}.so"
        self.path = path
        if not path.exists():
            self._build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise ShimUnavailable(
                f"could not load {path}: {e}; {describe_missing(libav_probe())}"
            ) from None
        lib.tm_open.restype = ctypes.c_void_p
        lib.tm_open.argtypes = [ctypes.c_char_p]
        lib.tm_open_io.restype = ctypes.c_void_p
        lib.tm_open_io.argtypes = [_READ_CB, _SEEK_CB, ctypes.c_void_p]
        lib.tm_info.restype = ctypes.c_int
        lib.tm_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(_TmInfo)]
        lib.tm_next_frame.restype = ctypes.c_int
        lib.tm_next_frame.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3 + [
            ctypes.POINTER(ctypes.c_int64)
        ]
        lib.tm_seek.restype = ctypes.c_int
        lib.tm_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tm_close.restype = None
        lib.tm_close.argtypes = [ctypes.c_void_p]
        lib.tm_has_decoder.restype = ctypes.c_int
        lib.tm_has_decoder.argtypes = [ctypes.c_char_p]
        return lib

    def _build(self, path: Path) -> None:
        """Compile under a per-process name, then publish with os.replace, so
        that processes building at once never load a partial file."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = _build_command(tmp)
        if _compiler() is None:
            raise ShimUnavailable(
                f"cannot build {path.name}: {describe_missing(libav_probe())}"
            )
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            tmp.unlink(missing_ok=True)
            raise ShimUnavailable(f"could not run {' '.join(cmd)}: {e}") from None
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            out = (res.stderr or res.stdout).strip().splitlines()
            raise ShimUnavailable(
                f"could not build {path.name} ({' '.join(cmd)} exited {res.returncode}): "
                + " | ".join(out[-6:])
                + f"; {describe_missing(libav_probe())}"
            )
        os.replace(tmp, path)
        self.built = True


SHIM = DemuxLibrary()


def load_library() -> Optional[ctypes.CDLL]:
    """The shim (built on first use), or None where it is unavailable."""
    try:
        return SHIM.get()
    except ShimUnavailable:
        return None


def native_available() -> bool:
    return load_library() is not None


class NativeVideoSource(FrameSource):
    """FrameSource over the native libav decode shim.

    Handles any container/codec the system FFmpeg decodes (H.264, HEVC, AV1,
    VP8/9, MPEG-2, ...), 8..16-bit, 4:2:0/4:2:2/4:4:4 — full-chroma content
    keeps its real chroma grid through to the device conversion (the
    reference is limited to NVDEC's 4:2:0 surfaces).
    """

    def __init__(
        self,
        path: str | os.PathLike | None = None,
        *,
        stream=None,
        container_meta: Optional[dict] = None,
    ):
        """Open a file path, or a binary stream (stdin, pipes, BytesIO)
        via libav AVIO read/seek callbacks — no temp-file spill.

        ``container_meta`` (from the pure-Python MKV header parse,
        io/probe.py) cross-checks geometry and supplies container-level
        colour metadata / frame counts that libav's codec probe may miss."""
        self._h = None
        try:
            lib = SHIM.get()
        except ShimUnavailable as e:
            raise RuntimeError(f"native demuxer unavailable: {e}") from None
        self._lib = lib
        # The ctypes thunks of a stream's callbacks: libav calls them until
        # tm_close, so they live as long as the handle.
        self._cbs: tuple = ()
        self._meta = container_meta
        if stream is not None:
            self._h = self._open_stream(stream)
            name = getattr(stream, "name", "<stream>")
        else:
            if path is None:
                raise ValueError("need a path or a stream")
            self._h = lib.tm_open(str(path).encode())
            name = path
            self._path = str(path)
        if not self._h:
            raise ValueError(f"could not open video: {name}")
        self._read_info_and_alloc()
        if container_meta and container_meta.get("width"):
            mw, mh = container_meta["width"], container_meta["height"]
            if (mw, mh) != (self._w, self._hgt):
                log.warning(
                    "container header says %dx%d but decoder reports %dx%d",
                    mw, mh, self._w, self._hgt,
                )

    def _open_stream(self, stream) -> int:
        def read(_opaque, buf, n):
            try:
                data = stream.read(n)
            except Exception:
                return -1
            if not data:
                return 0
            ctypes.memmove(buf, data, len(data))
            return len(data)

        read_cb = _READ_CB(read)
        seek_cb = _SEEK_CB()  # NULL unless seekable
        if stream.seekable():
            def seek(_opaque, offset, whence):
                try:
                    if whence == _AVSEEK_SIZE:
                        pos = stream.tell()
                        size = stream.seek(0, os.SEEK_END)
                        stream.seek(pos)
                        return size
                    return stream.seek(offset, whence)
                except Exception:
                    return -1

            seek_cb = _SEEK_CB(seek)
        self._cbs = (read_cb, seek_cb)
        return self._lib.tm_open_io(read_cb, seek_cb, None)

    def _read_info_and_alloc(self) -> None:
        """(Re)read stream info and size the decode buffers accordingly.
        Called at open and again after a -3 mid-stream reconfiguration."""
        info = _TmInfo()
        self._lib.tm_info(self._h, ctypes.byref(info))
        self.info = info
        self._depth = int(info.depth)
        self._dtype = np.uint8 if self._depth == 8 else np.uint16
        w, h = int(info.width), int(info.height)
        self._w, self._hgt = w, h
        self._chroma = int(info.chroma)
        if self._chroma in (400, 420):
            cw, ch = (w + 1) // 2, (h + 1) // 2
        elif self._chroma == 422:
            cw, ch = (w + 1) // 2, h
        else:
            cw, ch = w, h
        self._cw, self._ch = cw, ch
        self._ybuf = np.empty((h, w), dtype=self._dtype)
        self._ubuf = np.empty((ch, cw), dtype=self._dtype)
        self._vbuf = np.empty((ch, cw), dtype=self._dtype)

    def format_id(self) -> FormatIdentifier:
        return FormatIdentifier(
            self.info.container_name.decode(),
            self.info.codec_name.decode(),
            "libavcodec",
        )

    @property
    def width(self) -> int:
        return self._w

    @property
    def height(self) -> int:
        return self._hgt

    def color_characteristics(self) -> tuple[ColorCharacteristics, str]:
        cc = ColorCharacteristics.from_code_points(
            int(self.info.color_primaries),
            int(self.info.color_space),
            int(self.info.color_trc),
        )
        # Bitstream metadata wins; the container's MKV Colour elements fill
        # what the codec probe left unspecified; height fallback last
        # (turbo-metrics/src/color.rs:36-78 ordering).
        if self._meta and self._meta.get("cc") is not None:
            cc = cc.or_fallback(self._meta["cc"])
        cc = cc.or_fallback(height_fallback(self._hgt))
        if self.info.full_range in (0, 1):
            crange = "full" if self.info.full_range == 1 else "limited"
        else:
            crange = (self._meta or {}).get("range") or "limited"
        return cc, crange

    def frame_count(self) -> int:
        n = max(0, int(self.info.frame_count))
        if not n and self._meta:
            n = max(0, int(self._meta.get("frame_count") or 0))
        return n

    def next_frame(self) -> Optional[RawFrame]:
        pts = ctypes.c_int64(-(2**63))
        ret = self._lib.tm_next_frame(
            self._h,
            self._ybuf.ctypes.data_as(ctypes.c_void_p),
            self._ubuf.ctypes.data_as(ctypes.c_void_p),
            self._vbuf.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(pts),
        )
        self.last_pts = int(pts.value)
        if ret == 0:
            return None
        if ret == -3:
            # Mid-stream reconfiguration (resolution or pixel-format change):
            # the shim adopted the new format and stashed the frame.  Resize
            # our buffers and signal the caller; the stashed frame arrives on
            # the next get_frame() call.
            old = (self._w, self._hgt, self._depth, self._chroma)
            self._read_info_and_alloc()
            new = (self._w, self._hgt, self._depth, self._chroma)
            log.info("stream reconfigured: %s -> %s", old, new)
            raise ResolutionChanged(self._w, self._hgt)
        if ret < 0:
            raise RuntimeError(f"decode error ({ret})")
        y = self._ybuf.copy()
        u, v = self._ubuf, self._vbuf
        chroma = 420
        if self._chroma == 400:
            neutral = 1 << (self._depth - 1)
            uv = np.full((*u.shape, 2), neutral, dtype=self._dtype)
        else:
            # 4:2:2/4:4:4 keep their full chroma grid: the device conversion
            # upsamples on the real grid (ops/kernels/convert.py).  The
            # reference cannot do this — NVDEC only outputs 4:2:0 surfaces.
            chroma = self._chroma
            uv = np.stack([u, v], axis=-1)
        return RawFrame(
            y=y,
            uv=np.ascontiguousarray(uv),
            depth=self._depth,
            full_range=self.info.full_range == 1,
            chroma=chroma,
        )

    # -- seeking (chunked decode) ------------------------------------------

    AV_NOPTS = -(2**63)

    def can_seek(self) -> bool:
        """Seekable file with known CFR timing and real timestamps."""
        i = self.info
        return (
            not self._cbs  # path-backed, not a callback stream
            and i.fps_num > 0
            and i.fps_den > 0
            and i.time_base_num > 0
            and i.time_base_den > 0
        )

    def _pts_for_frame(self, n: int) -> int:
        i = self.info
        num = int(i.fps_den) * int(i.time_base_den)
        den = int(i.fps_num) * int(i.time_base_num)
        # start_pts: containers like MPEG-TS start at a nonzero PTS; frame 0
        # sits at start_pts, not 0 (without the offset every chunked seek
        # lands ~start_pts/fps frames early and chunks emit duplicates).
        return int(i.start_pts) + (n * num + den // 2) // den

    def frame_index(self, pts: int) -> int:
        """Map a stream timestamp back to a CFR frame index."""
        i = self.info
        num = int(i.fps_num) * int(i.time_base_num)
        den = int(i.fps_den) * int(i.time_base_den)
        return ((pts - int(i.start_pts)) * num + den // 2) // den

    def _reopen(self) -> bool:
        """Re-open a path-backed source at the true stream start (frame 0).

        The fallback when av_seek_frame cannot land at/before a target even
        at ts = start_pts (mpegts' timestamp binary search finds the NEXT
        keyframe after its byte estimate, so the first GOP is unreachable
        by seeking)."""
        path = getattr(self, "_path", None)
        if not path:
            return False
        self._lib.tm_close(self._h)
        self._h = self._lib.tm_open(path.encode())
        self._pushed_back = []
        # A failed reopen leaves _h falsy and reports unseekable:
        # seek_to_frame's contract is to return False so callers fall back
        # to sequential decode, not to raise a pool-fatal error in
        # ChunkedVideoSource._worker.
        return bool(self._h)

    def seek_to_frame(self, n: int) -> bool:
        """Position the stream so the next get_frame() returns frame ``n``.

        Seeks to the keyframe at or before n (tm_seek / av_seek_frame) and
        decodes forward, discarding frames before n.  Returns False if the
        source cannot seek (stream input, unknown timing, no timestamps) —
        callers fall back to sequential decode."""
        if not self.can_seek():
            return False
        i = self.info
        second = int(i.time_base_den) // max(int(i.time_base_num), 1)
        # av_seek_frame(BACKWARD) is imprecise on index-less containers
        # (MPEG-TS does a timestamp binary search and can land at a keyframe
        # AFTER the target, one full GOP late); retry with a growing backward
        # margin until the first decoded frame is at or before the target,
        # then decode-discard forward to it exactly.
        #
        # The margin is adaptive: when a probe lands late by L frames, the
        # next attempt backs off by exactly L + 2 frames instead of a whole
        # second (a whole extra GOP or more of decode-discard per chunk), and
        # the successful margin is remembered per source, so a pool worker
        # pays the probe ladder only on its first chunk.  Whole-second
        # margins remain as the fallback tail.
        target = self._pts_for_frame(n)
        frame_dur = max(self._pts_for_frame(1) - self._pts_for_frame(0), 1)
        f = None
        margin = getattr(self, "_seek_margin_hint", 0)
        fallback = [4 * second, 16 * second]
        for _attempt in range(6):
            ts = max(target - margin, int(i.start_pts))
            if self._lib.tm_seek(self._h, ts) != 0:
                return False
            self._pushed_back = []
            f = self.next_frame()
            if f is None:
                # Nothing decodes from the seek point: the target lies past
                # the end, or (MPEG-TS) the seek overshot every frame left.
                # Past a known frame count it is the end; otherwise back off
                # by the fallback margins, then decode from the start.  (The
                # JAX package returns False here, which drops the frames of
                # a chunk that starts in a TS's last GOP, or of a whole
                # short TS, from ChunkedVideoSource without an error.)
                count = int(i.frame_count)
                if count and n >= count:
                    return False
                if ts <= int(i.start_pts) or not fallback:
                    break
                margin = fallback.pop(0)
                continue
            if self.last_pts == self.AV_NOPTS:
                return False  # no timestamps: index unknowable after a seek
            late = self.frame_index(self.last_pts) - n
            if late <= 0:
                self._seek_margin_hint = margin
                break  # landed at or before the target: decode forward
            f = None
            if ts <= int(i.start_pts):
                break  # even the earliest seek point decodes past n
            grown = margin + (late + 2) * frame_dur
            if fallback and grown >= fallback[0]:
                grown = fallback.pop(0)
            margin = grown
        if f is None:
            # Decode-from-start fallback (unavailable for callback streams).
            if not self._reopen():
                return False
            f = self.next_frame()
            if f is None:
                return False
            if self.last_pts == self.AV_NOPTS:
                return False
        # Decode-discard forward to exactly n.  The probe frame in hand is
        # checked FIRST — next_frame() bypasses _pushed_back, so pushing the
        # probe back before this loop would leak it out of order later.
        while True:
            if self.frame_index(self.last_pts) >= n:
                self.push_back(f)
                return True
            f = self.next_frame()
            if f is None:
                return False  # seek target beyond EOF
            if self.last_pts == self.AV_NOPTS:
                return False

    def close(self) -> None:
        if self._h:
            self._lib.tm_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
