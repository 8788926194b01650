"""Fused MoE router: softmax + top-k + capacity positions, with and without
a replicated slot map.

Replaces the TPU kernels ``src/repro/kernels/topk_router.py::
topk_router_replicated`` and ``topk_router`` (both ``_call`` / ``_kernel``;
``topk_router`` is ``_call`` with identity tables).  The CUDA kernel is
``csrc/topk_router.cu``: one launch a call, over one thread-block cluster
of ``n`` CTAs.  ``route_plan`` lays the tokens out, in token-major order,
over rounds, CTAs, warps and ``m`` consecutive tokens a warp; each warp
computes its tokens' softmax and top-k in registers and ranks its own
selections per physical slot, each CTA sums its warps, and the CTAs of the
cluster read each other's per-slot counts through distributed shared
memory, so the capacity positions need no second launch, no atomics and
no device workspace.  ``topk_router`` launches the identity instantiation,
which reads no tables.

On a CPU tensor each wrapper computes its plain version
(``ref.ref_topk_router_replicated`` / ``ref.ref_topk_router``); on a CUDA
tensor it launches the kernel or raises.  Each wrapper's ``launches``
counts the calls that launched the kernel through it (one launch each).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_topk_router, ref_topk_router_replicated

MAX_K = 16                # csrc/topk_router.cu kMaxK
MAX_E = 256               # csrc/topk_router.cu kMaxPerLane * 32 probabilities a warp holds
MAX_CLUSTER = 8           # the portable thread-block cluster size
MAX_WARPS = 32            # csrc/topk_router.cu kMaxWarps: 1024 threads a CTA
MAX_PER_WARP = 16         # consecutive tokens one warp routes in a round
TOKENS_PER_CTA = 32       # the cluster takes one more CTA per 32 tokens, up to 8
_MAX_DYN_SMEM = 232_448   # dynamic shared memory one H100 block may use, opted in


class RoutePlan(NamedTuple):
    """One launch: ``ctas`` CTAs in one cluster, ``warps`` warps a CTA,
    ``per_warp`` consecutive tokens a warp, ``rounds`` passes over the
    cluster, ``smem`` bytes of dynamic shared memory a CTA.  Token i is in
    round i // (ctas * warps * per_warp), then CTA, then warp, then place
    in the warp, each contiguous."""
    ctas: int
    warps: int
    per_warp: int
    rounds: int
    smem: int


def smem_bytes(warps: int, per_warp: int, k: int, e: int, num_slots: int) -> int:
    """A CTA's shared memory (csrc/topk_router.cu): each selection's (slot,
    rank in warp) as 8 bytes, then per-warp slot counts, two CTA
    histograms (one per round parity), the offsets and the carry per slot,
    and the replica tables staged (counts, and at most S - E + 1 slots an
    expert)."""
    return (8 * warps * per_warp * k + 4 * (warps + 4) * num_slots
            + 4 * e * (num_slots - e + 2))


@functools.lru_cache(maxsize=512)
def route_plan(t: int, e: int, k: int, num_slots: int, *, ctas: Optional[int] = None,
               warps: Optional[int] = None, per_warp: Optional[int] = None) -> RoutePlan:
    """The launch plan for T = ``t`` tokens, from shapes alone.  By default
    a CTA per ``TOKENS_PER_CTA`` tokens (at most 8: on the card, more CTAs
    were faster at every T swept), one token a warp until a CTA has 32
    warps, then up to 16 tokens a warp: decode (T = 8) is one CTA of 8
    warps, and every prefill bucket up to 1024 tokens is one round.
    ``ctas``, ``warps`` and ``per_warp`` override the choice (the cluster
    size sweep, and tests that force several rounds)."""
    if not 1 <= k <= min(e, MAX_K):
        raise ValueError(f"k={k} outside [1, min(E={e}, {MAX_K})]")
    if not e <= num_slots or e > MAX_E:
        raise ValueError(f"E={e}, num_slots={num_slots}: need E <= {MAX_E} "
                         f"and num_slots >= E")
    n = ctas or min(MAX_CLUSTER, max(1, -(-t // TOKENS_PER_CTA)))
    per_cta = max(1, -(-t // n))
    m = per_warp or min(MAX_PER_WARP, -(-per_cta // (warps or MAX_WARPS)))
    w = warps or min(MAX_WARPS, -(-per_cta // m))
    if not (1 <= n <= MAX_CLUSTER and 1 <= w <= MAX_WARPS and m >= 1):
        raise ValueError(f"plan ctas={n} warps={w} per_warp={m} out of range")
    smem = smem_bytes(w, m, k, e, num_slots)
    if smem > _MAX_DYN_SMEM:
        raise ValueError(f"router plan needs {smem} B of shared memory a CTA "
                         f"(> {_MAX_DYN_SMEM}): warps={w} per_warp={m} S={num_slots}")
    return RoutePlan(n, w, m, max(1, -(-t // (n * w * m))), smem)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_router_launch.argtypes = [p] * 7 + [i] * 10 + [p]
    lib.topk_router_launch.restype = i


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if x.device.type != "cuda" or x.dtype != dtype or x.dim() != ndim \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype} CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _launch(logits: torch.Tensor, k: int, replica_slots: Optional[torch.Tensor],
            replica_count: Optional[torch.Tensor], num_slots: Optional[int],
            plan: Optional[RoutePlan], owner):
    """Check the CUDA operands, launch ``topk_router_launch`` once and count
    the launch on the wrapper ``owner``.  Identity placement (num_slots = E)
    when ``replica_slots`` is None.  The outputs are planes of one int32
    buffer, gates viewed as f32: (gates, ids, slots, pos), or (gates, ids,
    pos)."""
    _check("logits", logits, torch.float32, 2)
    t, e = logits.shape
    replicated = replica_slots is not None
    if not replicated:
        num_slots = e
    else:
        _check("replica_slots", replica_slots, torch.int32, 2)
        _check("replica_count", replica_count, torch.int32, 1)
        if replica_slots.shape[0] != e or replica_count.shape[0] != e:
            raise ValueError("replica tables must have one row per expert")
        if replica_slots.shape[1] > num_slots - e + 1:
            raise ValueError(f"replica_slots has {replica_slots.shape[1]} columns; an "
                             f"expert has at most S - E + 1 = {num_slots - e + 1} copies")
    plan = plan or route_plan(t, e, k, num_slots)
    out = torch.empty((4 if replicated else 3, t, k), dtype=torch.int32,
                      device=logits.device)
    gates, *ints = out.unbind(0)      # one call for the views (slicing is slower)
    planes = (gates.view(torch.float32), *ints)
    if t == 0:
        return planes
    lib = _build.load("topk_router", _bind)
    rc = lib.topk_router_launch(
        logits.data_ptr(), replica_slots.data_ptr() if replicated else None,
        replica_count.data_ptr() if replicated else None, planes[0].data_ptr(),
        planes[1].data_ptr(), planes[2].data_ptr() if replicated else None,
        planes[-1].data_ptr(), t, e, k,
        replica_slots.shape[1] if replicated else 1, num_slots, *plan,
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(lib, rc, owner.__name__)
    owner.launches += 1
    return planes


def topk_router_replicated(logits: torch.Tensor, k: int,
                           replica_slots: torch.Tensor,
                           replica_count: torch.Tensor, num_slots: int, *,
                           plan: Optional[RoutePlan] = None):
    """logits: (T, E) f32; replica_slots: (E, max_rep) int32 physical slots
    per logical expert (padded with the primary); replica_count: (E,) int32;
    num_slots: S = E + R.  Returns (gates (T,k) f32, ids (T,k) int32 logical,
    slots (T,k) int32 physical, pos (T,k) int32 position within slot).
    ``plan`` replaces ``route_plan``'s for a CUDA launch; the plain path
    has no plan."""
    if logits.device.type == "cpu":
        return ref_topk_router_replicated(logits, k, replica_slots,
                                          replica_count, num_slots)
    return _launch(logits, k, replica_slots, replica_count, num_slots, plan,
                   topk_router_replicated)


def topk_router(logits: torch.Tensor, k: int, *, plan: Optional[RoutePlan] = None):
    """logits: (T, E) f32.  Returns (gates (T,k) f32, ids (T,k) int32,
    pos (T,k) int32 position within expert): the identity-placement router,
    where expert e is slot e.  ``plan`` as in ``topk_router_replicated``."""
    if logits.device.type == "cpu":
        return ref_topk_router(logits, k)
    return _launch(logits, k, None, None, None, plan, topk_router)


topk_router_replicated.launches = 0
topk_router.launches = 0
