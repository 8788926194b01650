"""Grouped expert GEMM — the MoE hot loop.

Replaces the TPU kernel ``src/repro/kernels/moe_gemm.py::moe_gemm``
(``_kernel``).  The CUDA kernel is ``csrc/moe_gemm.cu``: bound by the bytes
of the expert weights at decode (403 MB per GEMM at qwen3 width, ~120 us at
3.35 TB/s), tiled 32 x 64 in shared memory with an f32 accumulator and
masked ragged C and F edges.

On a CPU tensor the wrapper computes the plain version
(``ref.ref_moe_gemm``); on a CUDA tensor it launches the kernel or raises.
``moe_gemm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_moe_gemm

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_gemm_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.moe_gemm_launch.restype = i


def moe_gemm(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, D), w: (E, D, F) -> (E, C, F) in xe's dtype (f32 accumulate)."""
    if xe.device.type == "cpu":
        return ref_moe_gemm(xe, w)
    for name, x in (("xe", xe), ("w", w)):
        if x.device.type != "cuda" or x.dtype not in _DTYPE_CODE or x.dim() != 3 \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-d f32/bf16 CUDA tensor, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    e, c, d = xe.shape
    if w.dtype != xe.dtype or w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"moe_gemm: xe {tuple(xe.shape)} {xe.dtype} does not "
                         f"match w {tuple(w.shape)} {w.dtype}")
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=xe.dtype, device=xe.device)
    if out.numel() == 0:
        return out
    lib = _build.load("moe_gemm", _bind)
    rc = lib.moe_gemm_launch(xe.data_ptr(), w.data_ptr(), out.data_ptr(),
                             e, c, d, f, _DTYPE_CODE[xe.dtype],
                             torch.cuda.current_stream(xe.device).cuda_stream)
    _build.check(lib, rc, "moe_gemm")
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0
