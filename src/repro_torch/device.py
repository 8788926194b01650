"""Device selection shared by the port's entry points.

Every entry point (``init_params``, ``PagedKVCache``, ``TorchBackend``,
``Engine``) runs on the card unless the caller asks for the CPU.  Asking for
the card where there is none raises; nothing falls back silently.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None, meta_ok: bool = False) -> torch.device:
    """``None`` means the card.  On the card, float32 matrix products and
    convolutions run in full float32: TF32 is switched off, because the
    router logits are an f32 product and TF32 there changes expert ids.
    ``meta_ok`` admits the meta device, where tensors have shapes and no
    storage (``models.model.abstract_params``)."""
    dev = torch.device("cuda" if device is None else device)
    if meta_ok and dev.type == "meta":
        return dev
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
