"""Build the CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in the package's git-ignored ``_build/`` directory under a name
keyed on a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import time: the CPU tests
import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ssimulacra2_scale.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (name, argtypes): every entry point returns a cudaError_t as int.
_SIGNATURES = {
    "tm_level_blocks": [_I, _I],
    "tm_yuv420_to_xyb": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I, _P, _P, _P, _P],
    "tm_rgb_to_xyb": [_P, _I, _I, _I, _P, _P, _P, _P],
    "tm_level_sums": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
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


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
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
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        path = BUILD_DIR / f"libtm_kernels_{_source_key()}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
            cmd += [str(CSRC / s) for s in SOURCES]
            t0 = time.monotonic()
            res = subprocess.run(cmd, capture_output=True, text=True)
            self.build_seconds = time.monotonic() - t0
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{self.build_log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib


LIBRARY = KernelLibrary()


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
