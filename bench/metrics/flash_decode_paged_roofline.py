"""Kernels (kernels/flash_decode.py, csrc/flash_decode_paged.cu): the least
time of the profiled decode steps' needed K/V reads
(``roofline/flash_decode_paged.py``) over the device time of the split and
merge passes in the trace, in %."""
from bench.roofline.flash_decode_paged import KERNELS


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds_of(*KERNELS)
    return 100.0 * run.bounds["flash_decode_paged"] / t if t > 0 else None
