"""The routes of the plain VMAF-feature, XPSNR and conversion entries.

ops/vif.py ``vif_scale_stats``, ops/adm.py ``adm_stats``, ops/vmaf_motion.py
``integer_blur`` and ``motion_stats``, ops/xpsnr_ops.py
``xpsnr_block_stats`` and ops/colorspace.py ``yuv420_to_linear_rgb`` take
the ``backend`` keyword of their JAX namesakes.  The port honours three of
JAX's names: None (the default, as "auto"), "jnp" (the plain torch version,
anywhere) and "pallas" (the kernel wrappers of ops/kernels/, which run
their plain twins on a CPU tensor).
None and "auto" pick the kernels on a CUDA tensor and the plain version on
any other.  JAX's "interpret" runs the Pallas interpreter, which the port
has no counterpart of: it raises, as every other unknown name does.

JAX defaults ADM and motion to jnp on every platform because XLA's fusion
measured faster than its Pallas kernels on the TPU (turbo_metrics_tpu/ops/
adm.py ``default_backend``, ops/vmaf_motion.py ``_default_backend``).  That
is a TPU measurement: on an H100 #18 and #16 take a small fraction of the
plain versions' time (PERF.md section 6, rows 16 and 18), so here the
kernels are the default on CUDA for every entry.

Past the backend, each entry has its gate, as its docstring says: VIF,
ADM and motion take their kernels where JAX's gate lets its Pallas kernels
take the call (``wide_planes``: batched 3-D planes whose smaller side is at
least 32), and every kernel takes only its input types; anything else runs
the plain version.  The gates read shapes, types and devices, never values.
"""

from __future__ import annotations

import torch

BACKENDS = (None, "auto", "jnp", "pallas")

# JAX's gate for its Pallas VIF, ADM and motion kernels (min(h, w) >= 32).
MIN_SIDE = 32

_U32 = 0xFFFFFFFF


def kernel_route(backend, device) -> bool:
    """Whether ``backend`` names the kernels for a tensor on ``device``
    (module docstring); ``ValueError`` for a name the port does not take."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend in (None, "auto"):
        return torch.device(device).type == "cuda"
    return backend == "pallas"


def batched_planes(*planes: torch.Tensor) -> bool:
    """Whether every plane is (B, h, w), all of one shape: what a kernel's
    pair or batch is stacked from."""
    shape = planes[0].shape
    return len(shape) == 3 and all(p.shape == shape for p in planes)


def wide_planes(*planes: torch.Tensor) -> bool:
    """JAX's gate: ``batched_planes`` whose smaller side is at least 32."""
    return batched_planes(*planes) and min(planes[0].shape[-2:]) >= MIN_SIDE


def f32_pair(ref: torch.Tensor, dis: torch.Tensor) -> torch.Tensor:
    """The contiguous (2, B, h, w) f32 pair that VIF's and ADM's kernels read,
    made by one copy."""
    return torch.stack([ref.to(torch.float32), dis.to(torch.float32)])


def code_pair(ref: torch.Tensor, dis: torch.Tensor, depth: int) -> torch.Tensor:
    """The contiguous (2, B, h, w) pair of luma codes that K-int-VIF and
    K-int-ADM read: the inputs' own type where both share one the kernels
    take (uint8, uint16, int32); otherwise (another integer type, or f32
    code values) cast as the JAX package casts them, to uint32 truncating,
    and narrowed to the narrowest type the kernels take that holds
    ``depth`` bits: uint8 up to 8 bits, else uint16.  Codes must lie below
    2^depth, as they do for the plain version's result to mean anything."""
    from turbo_metrics_tpu_torch.ops.kernels.xpsnr import DTYPE_CODES

    if ref.dtype == dis.dtype and ref.dtype in DTYPE_CODES:
        return torch.stack([ref, dis])
    narrow = torch.uint8 if depth <= 8 else torch.uint16
    # In int32 on the way: torch casts int64 to uint8 by wrapping, but has
    # few uint16 operations.
    return torch.stack([(t.to(torch.int64) & _U32).to(torch.int32).to(narrow) for t in (ref, dis)])
