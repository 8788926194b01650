"""Needed work of ``moe_gemm`` (``repro_torch/kernels/moe_gemm.py``,
``csrc/moe_gemm.cu``): one MoE layer's call runs as many launches as its
layout says (``moe_launches``: SwiGLU's gate and up, d -> f, and down,
f -> d).  A launch needs the weights of the experts
that at least one routed token reached, read once, and its token rows in
and out; the padding up to the capacity and the experts no token reached
are not needed."""
from __future__ import annotations

from bench.roofline.peaks import least_seconds

KERNEL = "tc_gemm_kernel"          # the bf16 kernel's name in the device trace


def launch_work(d: int, f: int, reached: int, selections: int, itemsize: int = 2):
    """(bytes, flops) of one launch over a (d, f) weight per expert."""
    nbytes = (reached * d * f + selections * (d + f)) * itemsize
    return nbytes, 2 * selections * d * f


def layer_seconds(d: int, f: int, reached: int, selections: int, launches: int,
                  itemsize: int = 2) -> float:
    """The least time of one layer's ``launches`` launches."""
    nbytes, flops = launch_work(d, f, reached, selections, itemsize)
    return launches * least_seconds(nbytes, flops)
