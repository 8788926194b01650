"""Kernels (kernels/moe_gemm.py, csrc/moe_gemm.cu): the least time of the
profiled launches' needed work (``roofline/moe_gemm.py``) over their
device time in the trace, in %."""
from bench.roofline.moe_gemm import KERNEL


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds_of(KERNEL)
    return 100.0 * run.bounds["moe_gemm"] / t if t > 0 else None
