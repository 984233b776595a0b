"""Build the CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into an object, all
sources at once in parallel, and links them into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in the package's git-ignored ``_build/`` directory under a name
keyed on a hash of every file under ``csrc/`` (headers included) and the
flags, so an edited source or header rebuilds and an unchanged tree is
reused.  Nothing here runs at import time: the CPU tests import every module
on a machine without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from turbo_metrics_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = (
    "ssimulacra2_scale.cu", "ssimulacra2_tail.cu", "downscale.cu", "convert.cu", "windowed.cu",
    "xpsnr.cu", "motion.cu", "vif.cu", "adm.cu", "blur_probe.cu", "integer_vif.cu", "integer_adm.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PF = ctypes.POINTER(ctypes.c_float)  # host floats
_PI = ctypes.POINTER(ctypes.c_int)  # host ints
# (name, argtypes): every entry point returns a cudaError_t as int.
_SIGNATURES = {
    "tm_level_blocks": [_I, _I],
    "tm_level_tile_attrs": [_PI],
    "tm_yuv420_to_xyb": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I, _P, _P, _P, _P],
    "tm_rgb_to_xyb": [_P, _I, _I, _I, _P, _P, _P, _P],
    "tm_rgb_pair_to_xyb": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "tm_srgb_pair_to_xyb": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "tm_level_sums": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "tm_level_sums_pair": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "tm_fused_tail": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "tm_fused_tail_attrs": [_PI],
    "tm_downscale2": [_P, _I, _I, _I, _P, _P],
    "tm_yuv420_to_rgb": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I, _P, _P],
    "tm_yuv_to_rgb": [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I, _P, _P],
    "tm_convert_attributes": [_I, _I, _I, _PI],
    "tm_ssim_blocks": [_I, _I],
    "tm_ssim_tile_attrs": [_I, _PI],
    "tm_ssim_level": [_P, _I, _I, _I, _I, _P, _F, _F, _I, _I, _P, _P, _I, _P, _P],
    "tm_xpsnr_block_stats": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "tm_xpsnr_attributes": [_I, _I, _I, _PI],
    "tm_xpsnr_wsse": [_P, _P, _P, _I, _I, _I, _P, _P],
    "tm_motion_stats": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "tm_integer_blur": [_P, _I, _I, _I, _I, _I, _P, _P],
    "tm_motion_attrs": [_I, _PI],
    "tm_vif_blocks": [_I, _I],
    "tm_vif_tile_attrs": [_I, _PI],
    "tm_vif_level": [_P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I, _P, _P],
    "tm_adm_blocks": [_I, _I, _I, _I],
    "tm_adm_tile_attrs": [_PI],
    "tm_adm_level": [_P, _I, _I, _I, _PF, _F, _F, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P, _I, _P],
    "tm_integer_vif_blocks": [_I, _I],
    "tm_integer_vif_attrs": [_I, _I, _I, _I, _PI],
    "tm_integer_vif_level": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _PI, _P, _P, _I, _P, _P, _P],
    "tm_integer_adm_blocks": [_I, _I, _I, _I],
    "tm_integer_adm_attrs": [_I, _I, _I, _PI],
    "tm_integer_adm_level": [_P, _I, _I, _I, _I, _I, _I, _PI, _F, _F, _F, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P, _I,
                             _P, _P],
    "tm_blur_probe_blocks": [_I, _I],
    "tm_blur_probe_attrs": [_PI],
    "tm_blur_probe": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
}


def _nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's default."""
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "turbo_metrics_tpu_torch/csrc at first use"
    )


def source_key(csrc: Path = CSRC) -> str:
    """Hash of the flags, the source list and every file under ``csrc``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + SOURCES).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(path.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The compiled kernels, built and loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.build_log = ""  # nvcc/ptxas output of the build (registers, spills)
        self.build_seconds = 0.0

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                with profiling.span("tm.library.load"):
                    self._lib = self._load()
            return self._lib

    def path(self) -> Path:
        """The library's file, built first where needed."""
        self.get()
        return self._path()

    @staticmethod
    def _path() -> Path:
        return BUILD_DIR / f"libtm_kernels_{source_key()}.so"

    def _load(self) -> ctypes.CDLL:
        path = self._path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.monotonic()
            self._build(path)
            self.build_seconds = time.monotonic() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib

    def _build(self, path: Path) -> None:
        """One nvcc per source, all started together, then one link."""
        profiling.count("library_builds")
        nvcc = _nvcc()
        tag = f"{path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(SOURCES, objs)
        ]
        logs, failed = [], []
        for s, p in zip(SOURCES, procs):
            logs.append(f"== {s}\n{p.communicate()[0]}")
            if p.returncode != 0:
                failed.append(f"{s} ({p.returncode})")
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        if not failed:
            res = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            logs.append(f"== link\n{res.stdout}{res.stderr}")
            if res.returncode != 0:
                failed.append(f"link ({res.returncode})")
        for o in objs:
            o.unlink(missing_ok=True)
        self.build_log = "\n".join(logs)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{self.build_log}")
        os.replace(tmp, path)


LIBRARY = KernelLibrary()


def check(status: int, what: str) -> None:
    """Raise if a C entry point ``what`` reported a CUDA error; while the
    recording is on, count the call as ``launches.<what>``."""
    if profiling.recording():
        profiling.count(f"launches.{what}")
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


@contextlib.contextmanager
def launch_stream(dev: torch.device):
    """The raw handle of ``dev``'s current stream, with ``dev`` the calling
    thread's current device for the block: the library's entry points launch
    on the current device, which must be the one that holds their tensors
    and the stream.  Where ``dev`` is current already nothing is switched."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        yield torch.cuda.current_stream(dev).cuda_stream
        return
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream
