"""Hand-written Hopper kernels of the port: paged and slot-cache
flash-decode, the top-k router (replica-aware and identity-placement) and
the grouped expert GEMM.

CUDA C++ sources live in ``csrc/`` and are built by ``_build`` with nvcc at
first use; each kernel has its plain PyTorch version in ``ref.py`` and its
entry point in ``ops.py``.
"""
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.topk_router import topk_router, topk_router_replicated
from repro_torch.kernels.ops import (decode_attention, expert_ffn,
                                     paged_decode_attention, route,
                                     route_replicated)

KERNELS = (flash_decode_paged, topk_router_replicated, moe_gemm, flash_decode,
           topk_router)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["flash_decode", "flash_decode_paged", "moe_gemm", "topk_router",
           "topk_router_replicated", "decode_attention", "expert_ffn",
           "paged_decode_attention", "route", "route_replicated",
           "KERNELS", "reset_launch_counts"]
