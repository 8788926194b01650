"""Grouped expert GEMM — the MoE hot loop.

Replaces the TPU kernel ``src/repro/kernels/moe_gemm.py::moe_gemm``
(``_kernel``).  The CUDA kernels are in ``csrc/moe_gemm.cu``; both are bound
by the bytes of the expert weights (403 MB per GEMM at qwen3 width, ~120 us
at 3.35 TB/s).  bf16 runs a weight-streaming tensor-core kernel: C is the
MMA's N dimension, each block streams a (D x 128) weight panel through a
4-stage ``cp.async`` ring of 64-deep tiles.  f32 keeps the CUDA-core kernel
(32 x 64 tiles), since TF32 tensor cores would miss the f32 gate; the dtype
decides which kernel runs.

On a CPU tensor the wrapper computes the plain version
(``ref.ref_moe_gemm``); on a CUDA tensor it launches the kernel or raises.
``moe_gemm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_moe_gemm

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# bf16 tensor-core kernel (csrc/moe_gemm.cu kTcBF, kTcBK, kTcStages, kPad)
BF16_BLOCK_F = 128      # output features per block
BF16_BLOCK_K = 64       # depth of one pipeline stage
BF16_STAGES = 4
_PAD = 8                # bf16 elements of row padding in shared memory
MAX_N_TILES = 8         # at most 8 x 8 = 64 rows of C per block
# f32 CUDA-core kernel (csrc/moe_gemm.cu kBC, kBF, kBK)
F32_BLOCK_C, F32_BLOCK_F, F32_BLOCK_K = 32, 64, 32


@dataclass(frozen=True)
class Plan:
    """How one call is launched: rows of C, features and depth per block,
    the grid (F-tiles, C-tiles, E) and the dynamic shared memory in bytes."""
    block_c: int
    block_f: int
    block_k: int
    grid: Tuple[int, int, int]
    smem: int

    @property
    def n_tiles(self) -> int:
        return self.block_c // 8


def check_bf16_shapes(d: int, f: int) -> None:
    """The bf16 kernel copies 16-byte rows: D and F must be multiples of 8."""
    if d % 8 or f % 8:
        raise ValueError(f"moe_gemm bf16: D={d} and F={f} must be multiples of 8 "
                         "(the kernel copies 16-byte rows)")


def launch_plan(e: int, c: int, d: int, f: int, dtype: torch.dtype) -> Plan:
    """The grid and shared memory of one launch, as ``csrc/moe_gemm.cu``
    computes them.  bf16 blocks take ceil(C / 8) N tiles of 8 rows, at most
    ``MAX_N_TILES``, so the accumulators stay in registers at any C."""
    if dtype == torch.float32:
        return Plan(F32_BLOCK_C, F32_BLOCK_F, F32_BLOCK_K,
                    (-(-f // F32_BLOCK_F), -(-c // F32_BLOCK_C), e), 0)
    check_bf16_shapes(d, f)
    n_tiles = min(max(-(-c // 8), 1), MAX_N_TILES)
    block_c = 8 * n_tiles
    smem = BF16_STAGES * (BF16_BLOCK_K * (BF16_BLOCK_F + _PAD)
                          + block_c * (BF16_BLOCK_K + _PAD)) * 2
    return Plan(block_c, BF16_BLOCK_F, BF16_BLOCK_K,
                (-(-f // BF16_BLOCK_F), -(-c // block_c), e), smem)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_gemm_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.moe_gemm_launch.restype = i
    lib.moe_gemm_bf16_smem_bytes.argtypes = [i]
    lib.moe_gemm_bf16_smem_bytes.restype = i
    for n in range(1, MAX_N_TILES + 1):          # the library and the plan agree
        plan = launch_plan(1, 8 * n, 8, 8, torch.bfloat16)
        if lib.moe_gemm_bf16_smem_bytes(n) != plan.smem:
            raise RuntimeError(f"moe_gemm: csrc/moe_gemm.cu needs "
                               f"{lib.moe_gemm_bf16_smem_bytes(n)} B of shared memory "
                               f"for {n} N tiles, the launch plan {plan.smem}")


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
    plan = launch_plan(e, c, d, f, xe.dtype)
    if xe.dtype == torch.bfloat16 and (xe.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("moe_gemm bf16: xe and w must start on a 16-byte boundary")
    out = torch.empty((e, c, f), dtype=xe.dtype, device=xe.device)
    if out.numel() == 0:
        return out
    lib = _build.load("moe_gemm", _bind)
    rc = lib.moe_gemm_launch(xe.data_ptr(), w.data_ptr(), out.data_ptr(),
                             e, c, d, f, plan.n_tiles, _DTYPE_CODE[xe.dtype],
                             torch.cuda.current_stream(xe.device).cuda_stream)
    _build.check(lib, rc, "moe_gemm")
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0
