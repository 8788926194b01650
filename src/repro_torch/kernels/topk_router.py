"""Replica-aware fused MoE router: softmax + top-k + slot map + capacity
positions.

Replaces the TPU kernel ``src/repro/kernels/topk_router.py::
topk_router_replicated`` (``_call`` / ``_kernel``).  The CUDA kernel is
``csrc/topk_router.cu``: bound by bytes, it runs as two launches (a warp
per token for softmax and top-k; a block per physical slot for the
token-major capacity positions), so that no running count depends on the
order in which blocks run.

On a CPU tensor the wrapper computes the plain version
(``ref.ref_topk_router_replicated``); on a CUDA tensor it launches the
kernel or raises.  ``topk_router_replicated.launches`` counts calls that
launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_topk_router_replicated

MAX_K = 16      # csrc/topk_router.cu kMaxK


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_router_launch.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.topk_router_launch.restype = i


def topk_router_replicated(logits: torch.Tensor, k: int,
                           replica_slots: torch.Tensor,
                           replica_count: torch.Tensor, num_slots: int):
    """logits: (T, E) f32; replica_slots: (E, max_rep) int32 physical slots
    per logical expert (padded with the primary); replica_count: (E,) int32;
    num_slots: S = E + R.  Returns (gates (T,k) f32, ids (T,k) int32 logical,
    slots (T,k) int32 physical, pos (T,k) int32 position within slot)."""
    if logits.device.type == "cpu":
        return ref_topk_router_replicated(logits, k, replica_slots,
                                          replica_count, num_slots)
    t, e = logits.shape
    for name, x, dt, nd in (("logits", logits, torch.float32, 2),
                            ("replica_slots", replica_slots, torch.int32, 2),
                            ("replica_count", replica_count, torch.int32, 1)):
        if x.device.type != "cuda" or x.dtype != dt or x.dim() != nd \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {nd}-d {dt} CUDA "
                             f"tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if replica_slots.shape[0] != e or replica_count.shape[0] != e:
        raise ValueError("replica tables must have one row per expert")
    if not 1 <= k <= min(e, MAX_K):
        raise ValueError(f"k={k} outside [1, min(E={e}, {MAX_K})]")
    if num_slots < e:
        raise ValueError(f"num_slots={num_slots} < E={e}")
    dev = logits.device
    gates = torch.empty((t, k), dtype=torch.float32, device=dev)
    ids, slots, pos = (torch.empty((t, k), dtype=torch.int32, device=dev)
                       for _ in range(3))
    if t == 0:
        return gates, ids, slots, pos
    lib = _build.load("topk_router", _bind)
    rc = lib.topk_router_launch(
        logits.data_ptr(), replica_slots.data_ptr(), replica_count.data_ptr(),
        gates.data_ptr(), ids.data_ptr(), slots.data_ptr(), pos.data_ptr(),
        t, e, k, replica_slots.shape[1], num_slots,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "topk_router_replicated")
    topk_router_replicated.launches += 1
    return gates, ids, slots, pos


topk_router_replicated.launches = 0
