"""Needed work of ``flash_decode_paged`` (``repro_torch/kernels/
flash_decode.py``, ``csrc/flash_decode_paged.cu``): one decode step of one
layer reads the resident K and V of each active row once (its length
including the token the step appends), and each query and output row once;
the free rows and the pages past a row's length are not needed."""
from __future__ import annotations

from typing import Sequence

from bench.roofline.peaks import least_seconds

KERNELS = ("split_kernel", "merge_kernel")   # rt::split:: passes in the device trace


def launch_work(lengths: Sequence[int], hq: int, hkv: int, d: int, itemsize: int = 2):
    """(bytes, flops) of one layer's call over the active rows' lengths."""
    total = int(sum(lengths))
    nbytes = (2 * total * hkv * d + 2 * len(lengths) * hq * d) * itemsize
    return nbytes, 4 * total * hq * d


def layer_seconds(lengths: Sequence[int], hq: int, hkv: int, d: int,
                  itemsize: int = 2) -> float:
    return least_seconds(*launch_work(lengths, hq, hkv, d, itemsize))
