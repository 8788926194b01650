"""Entry points of the kernel layer, mirroring ``repro.kernels.ops``.

``expert_ffn`` is the drop-in replacement for ``models.moe._expert_ffn``
(gated FFN as three grouped GEMMs) used when ``dispatch_mode="fused"``.
There is no interpret switch: each kernel wrapper computes its plain
version for CPU tensors and launches its CUDA kernel for CUDA tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.topk_router import topk_router, topk_router_replicated


def expert_ffn(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """(E, C, d) -> (E, C, d) gated FFN via grouped-GEMM kernels."""
    gate = moe_gemm(xe, params["w_gate"])
    up = moe_gemm(xe, params["w_up"])
    act = F.silu(gate.float()).to(xe.dtype) * up
    return moe_gemm(act, params["w_down"])


def route(logits: torch.Tensor, k: int):
    """Fused router with the identity placement: (gates, ids, per-expert
    capacity positions)."""
    return topk_router(logits.contiguous(), k)


def route_replicated(logits: torch.Tensor, k: int, replica_slots: torch.Tensor,
                     replica_count: torch.Tensor, num_slots: int):
    """Replica-aware fused router (gates, logical ids, physical slots, per-slot
    capacity positions) — the routing half of the fused MoE step."""
    return topk_router_replicated(logits.contiguous(), k,
                                  replica_slots.int().contiguous(),
                                  replica_count.int().contiguous(), num_slots)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """(B, Hq, D) x (B, S, Hkv, D) slot cache -> (B, Hq, D)."""
    return flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                        lengths.int().contiguous(), softcap=softcap)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *, k_scale=None, v_scale=None,
                           softcap: float = 0.0) -> torch.Tensor:
    """(B, Hq, D) x (P, BS, Hkv, D) pool + (B, NB) block tables -> (B, Hq, D)."""
    return flash_decode_paged(q.contiguous(), k_pages, v_pages,
                              block_tables.int().contiguous(),
                              lengths.int().contiguous(),
                              k_scale=k_scale, v_scale=v_scale, softcap=softcap)


__all__ = ["moe_gemm", "flash_decode", "flash_decode_paged", "topk_router",
           "topk_router_replicated", "expert_ffn", "route", "route_replicated",
           "decode_attention", "paged_decode_attention"]
