"""Fused MoE router: softmax + top-k + capacity positions, with and without
a replicated slot map.

Replaces the TPU kernels ``src/repro/kernels/topk_router.py::
topk_router_replicated`` and ``topk_router`` (both ``_call`` / ``_kernel``;
``topk_router`` is ``_call`` with identity tables).  The CUDA kernel is
``csrc/topk_router.cu``: bound by bytes, it runs as two launches (a warp
per token for softmax and top-k; a block per physical slot for the
token-major capacity positions), so that no running count depends on the
order in which blocks run.  ``topk_router`` launches the same kernel with
identity tables (expert e in slot e, one copy each), cached per device.

On a CPU tensor each wrapper computes its plain version
(``ref.ref_topk_router_replicated`` / ``ref.ref_topk_router``); on a CUDA
tensor it launches the kernel or raises.  Each wrapper's ``launches``
counts the calls that launched the kernel through it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_topk_router, ref_topk_router_replicated

MAX_K = 16      # csrc/topk_router.cu kMaxK

# (device, E) -> identity (replica_slots (E, 1), replica_count (E,)) int32
_IDENTITY: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_router_launch.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.topk_router_launch.restype = i


def _launch(logits: torch.Tensor, k: int, replica_slots: torch.Tensor,
            replica_count: torch.Tensor, num_slots: int, owner):
    """Check the CUDA operands, launch ``topk_router_launch`` and count the
    launch on the wrapper ``owner``; returns (gates, ids, slots, pos)."""
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
    _build.check(lib, rc, owner.__name__)
    owner.launches += 1
    return gates, ids, slots, pos


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
    return _launch(logits, k, replica_slots, replica_count, num_slots,
                   topk_router_replicated)


def topk_router(logits: torch.Tensor, k: int):
    """logits: (T, E) f32.  Returns (gates (T,k) f32, ids (T,k) int32,
    pos (T,k) int32 position within expert): the identity-placement router,
    where expert e is slot e."""
    if logits.device.type == "cpu":
        return ref_topk_router(logits, k)
    if logits.device.type != "cuda" or logits.dim() != 2:
        raise ValueError(f"logits must be a 2-d CUDA tensor, got "
                         f"{tuple(logits.shape)} on {logits.device}")
    e = logits.shape[1]
    key = (logits.device, e)
    if key not in _IDENTITY:
        eye = torch.arange(e, dtype=torch.int32, device=logits.device)
        _IDENTITY[key] = (eye[:, None].contiguous(), torch.ones_like(eye))
    slots_tbl, count = _IDENTITY[key]
    gates, ids, _slots, pos = _launch(logits, k, slots_tbl, count, e, topk_router)
    return gates, ids, pos


topk_router_replicated.launches = 0
topk_router.launches = 0
