"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A share of one of
them is stated beside the card's ``power.limit`` (``device.power_limit`` in
the result line)."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float8": 1979e12,
              "float32": 67e12}


def least_seconds(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type (the
    roofline arithmetic of ``chip_smoke._bound``)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
