"""Int8 quantisation, ported from ``repro.training.compression``.

Only ``quantize_int8`` is ported so far: the paged KV cache stores int8
pages with it.  Gradient compression waits for the training slice.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale): symmetric per-tensor scale
    max(|g|) / 127 (floored at 1e-12 / 127), round half to even."""
    scale = torch.clamp(torch.max(torch.abs(g.float())), min=1e-12) / 127.0
    x = torch.round(g.float() / scale)
    return torch.clamp(x, -127, 127).to(torch.int8), scale
