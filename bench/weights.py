"""Seeded random weights, drawn on the device from ``--seed`` leaf by leaf
and layer by layer in the type they are served in.

Both sides take their weights from here: the harness stacks them into the
port's parameter tree (``program_params``), and the reference draws the
same leaves again, one layer at a time (``layer``), so it takes no tensor
the program holds.  A leaf of layer ``l`` is drawn with its own generator
seeded from (seed, leaf, l), so a layer's numbers do not depend on how
many other layers are drawn, or in which order.  Which leaves there are,
and the tree the port holds them in, the configuration's layout says
(``bench/layouts/<architecture>.py``).

Norm scales are drawn too (std 0.1 around the ``1 + scale`` of the port's
RMS norm), so that a norm applied wrongly shows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from bench import spec
from bench.traffic import subseed

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
NORM_STD = 0.1


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    std: float
    dtype: torch.dtype


def dtype(config: dict) -> torch.dtype:
    return _DTYPES[config["torch_dtype"]]


def draw(leaf: Leaf, seed: int, layer: Optional[int], device, out=None) -> torch.Tensor:
    """N(0, std^2) in the leaf's type from the leaf's own generator; into
    ``out`` (a tensor of the leaf's shape) when given."""
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, "weights", leaf.name, -1 if layer is None else layer))
    t = torch.empty(leaf.shape, dtype=leaf.dtype, device=device) if out is None else out
    return t.normal_(0.0, leaf.std, generator=g)


def layer(config: dict, seed: int, l: int, device, dtype_=None) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s leaves, cast to ``dtype_`` when given (the reference's
    float32)."""
    out = {}
    for leaf in spec.layout_module(config).layer_leaves(config, l):
        t = draw(leaf, seed, l, device)
        out[leaf.name] = t if dtype_ is None else t.to(dtype_)
    return out


def globals_(config: dict, seed: int, device, dtype_=None) -> Dict[str, torch.Tensor]:
    out = {}
    for leaf in spec.layout_module(config).global_leaves(config):
        t = draw(leaf, seed, None, device)
        out[leaf.name] = t if dtype_ is None else t.to(dtype_)
    return out


# ---------------------------------------------------------------- the port's tree

@dataclasses.dataclass
class Draw:
    """What a layout's ``program_params`` draws the port's tree with."""
    config: dict
    seed: int
    device: object

    def globals_(self) -> Dict[str, torch.Tensor]:
        return globals_(self.config, self.seed, self.device)

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        return layer(self.config, self.seed, l, self.device)

    def stack(self, layers) -> Dict[str, torch.Tensor]:
        """The leaves of ``layers`` (alike) stacked on a leading axis: each
        allocated once and drawn slice by slice, so no leaf is held twice."""
        layers = list(layers)
        out = {}
        for leaf in spec.layout_module(self.config).layer_leaves(self.config, layers[0]):
            buf = torch.empty((len(layers),) + leaf.shape, dtype=leaf.dtype, device=self.device)
            for i, l in enumerate(layers):
                draw(leaf, self.seed, l, self.device, out=buf[i])
            out[leaf.name] = buf
        return out


def program_params(config: dict, seed: int, device) -> dict:
    """The port's parameter tree (models/model.py), as the configuration's
    layout builds it (``bench/layouts/<architecture>.py``)."""
    return spec.layout_module(config).program_params(config, Draw(config, seed, device))
