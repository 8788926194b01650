"""Weight bridge: the reference's parameter tree, given as nested dicts (and
lists) of numpy arrays, to the port's tensors in the same layout.

PyTorch cannot replay ``jax.random``, so every numerics comparison feeds
both packages the reference's weights through this bridge.  ``bfloat16``
arrays (numpy's ``ml_dtypes`` extension type, which ``torch.from_numpy``
cannot take) go through float32, which holds every bfloat16 value exactly.
``adamw_state_from_numpy`` carries the optimizer's state across the same
way.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import device as devlib
from repro_torch.training.optimizer import AdamWState


def _tensor(a, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32))).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts / lists of numpy arrays -> the same structure of tensors
    on ``device`` (the card by default).  ``dtype=None`` keeps each array's
    dtype (bfloat16 stays bfloat16); a given ``dtype`` casts every floating
    leaf to it."""
    dev = devlib.resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _tensor(x, dev, dtype)

    return conv(tree)


def adamw_state_from_numpy(step, m: Any, v: Any, device=None):
    """The reference's AdamW state (a step count and two moment trees of
    numpy arrays) as the port's ``AdamWState`` on ``device`` (the card by
    default), every moment keeping its dtype."""
    dev = devlib.resolve(device)
    return AdamWState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
                      m=params_from_numpy(m, dev), v=params_from_numpy(v, dev))
