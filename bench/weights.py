"""Seeded random weights, drawn on the device from ``--seed`` leaf by leaf
and layer by layer in the type they are served in.

Both sides take their weights from here: the harness stacks them into the
port's parameter tree (``program_params``), and the reference draws the
same leaves again, one layer at a time (``layer``), so it takes no tensor
the program holds.  A leaf of layer ``l`` is drawn with its own generator
seeded from (seed, leaf, l), so a layer's numbers do not depend on how
many other layers are drawn, or in which order.

Norm scales are drawn too (std 0.1 around the ``1 + scale`` of the port's
RMS norm), so that a norm applied wrongly shows.  The router's weight is
float32, as the port keeps it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

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


def n_experts(config: dict) -> int:
    return config.get("num_experts", config.get("n_routed_experts", 0))


def first_dense(config: dict) -> int:
    return config.get("first_k_dense_replace", 0)


def is_moe_layer(config: dict, l: int) -> bool:
    return n_experts(config) > 0 and l >= first_dense(config)


def global_leaves(config: dict) -> List[Leaf]:
    d, v, dt = config["hidden_size"], config["vocab_size"], dtype(config)
    return [Leaf("embedding", (v, d), d ** -0.5, dt),
            Leaf("unembedding", (v, d), d ** -0.5, dt),
            Leaf("final_norm", (d,), NORM_STD, dt)]


def layer_leaves(config: dict, l: int) -> List[Leaf]:
    d, dt = config["hidden_size"], dtype(config)
    out = [Leaf("attn_norm", (d,), NORM_STD, dt), Leaf("ffn_norm", (d,), NORM_STD, dt)]
    h = config["num_attention_heads"]
    if config["architecture"] == "deepseek_v2":
        rq, rkv = config["q_lora_rank"], config["kv_lora_rank"]
        dn, dr, dv = (config["qk_nope_head_dim"], config["qk_rope_head_dim"],
                      config["v_head_dim"])
        out += [Leaf("wq_a", (d, rq), d ** -0.5, dt), Leaf("q_norm", (rq,), NORM_STD, dt),
                Leaf("wq_b", (rq, h, dn + dr), rq ** -0.5, dt),
                Leaf("wkv_a", (d, rkv + dr), d ** -0.5, dt),
                Leaf("kv_norm", (rkv,), NORM_STD, dt),
                Leaf("wkv_b", (rkv, h, dn + dv), rkv ** -0.5, dt),
                Leaf("wo", (h, dv, d), (h * dv) ** -0.5, dt)]
    else:
        hkv, hd = config["num_key_value_heads"], config["head_dim"]
        out += [Leaf("wq", (d, h, hd), d ** -0.5, dt), Leaf("wk", (d, hkv, hd), d ** -0.5, dt),
                Leaf("wv", (d, hkv, hd), d ** -0.5, dt),
                Leaf("wo", (h, hd, d), (h * hd) ** -0.5, dt)]
    if is_moe_layer(config, l):
        e, f = n_experts(config), config["moe_intermediate_size"]
        out += [Leaf("w_router", (d, e), d ** -0.5, torch.float32),
                Leaf("w_gate", (e, d, f), d ** -0.5, dt), Leaf("w_up", (e, d, f), d ** -0.5, dt),
                Leaf("w_down", (e, f, d), f ** -0.5, dt)]
        fs = f * config.get("n_shared_experts", 0)
        if fs:
            out += [Leaf("shared_w_gate", (d, fs), d ** -0.5, dt),
                    Leaf("shared_w_up", (d, fs), d ** -0.5, dt),
                    Leaf("shared_w_down", (fs, d), fs ** -0.5, dt)]
    else:
        f = config["intermediate_size"]
        out += [Leaf("ffn_w_gate", (d, f), d ** -0.5, dt), Leaf("ffn_w_up", (d, f), d ** -0.5, dt),
                Leaf("ffn_w_down", (f, d), f ** -0.5, dt)]
    return out


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
    for leaf in layer_leaves(config, l):
        t = draw(leaf, seed, l, device)
        out[leaf.name] = t if dtype_ is None else t.to(dtype_)
    return out


def globals_(config: dict, seed: int, device, dtype_=None) -> Dict[str, torch.Tensor]:
    out = {}
    for leaf in global_leaves(config):
        t = draw(leaf, seed, None, device)
        out[leaf.name] = t if dtype_ is None else t.to(dtype_)
    return out


# ---------------------------------------------------------------- the port's tree

def _block(config: dict, w: Dict[str, torch.Tensor], l: int) -> dict:
    """Layer ``l``'s leaves in the port's block layout (models/blocks.py)."""
    if config["architecture"] == "deepseek_v2":
        attn = {k: w[k] for k in ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")}
    else:
        attn = {k: w[k] for k in ("wq", "wk", "wv", "wo")}
    p = {"attn_norm": {"scale": w["attn_norm"]}, "attn": attn,
         "ffn_norm": {"scale": w["ffn_norm"]}}
    if is_moe_layer(config, l):
        p["moe"] = {k: w[k] for k in ("w_router", "w_gate", "w_up", "w_down")}
        if "shared_w_gate" in w:
            p["moe"]["shared"] = {k: w["shared_" + k] for k in ("w_gate", "w_up", "w_down")}
    else:
        p["ffn"] = {k: w["ffn_" + k] for k in ("w_gate", "w_up", "w_down")}
    return p


def program_params(config: dict, seed: int, device) -> dict:
    """The port's parameter tree (models/model.py): ``embed``, ``final_norm``,
    a ``prologue`` list of the leading dense layers and the stacked
    ``blocks``.  Each stacked leaf is allocated once and drawn slice by
    slice, so no leaf is held twice."""
    g = globals_(config, seed, device)
    params = {"embed": {"embedding": g["embedding"], "unembedding": g["unembedding"]},
              "final_norm": {"scale": g["final_norm"]}}
    n_pro, n = first_dense(config), config["num_hidden_layers"]
    if n_pro:
        params["prologue"] = [_block(config, layer(config, seed, l, device), l)
                              for l in range(n_pro)]
    stacked = {}
    leaves = layer_leaves(config, n_pro)
    for leaf in leaves:
        buf = torch.empty((n - n_pro,) + leaf.shape, dtype=leaf.dtype, device=device)
        for i, l in enumerate(range(n_pro, n)):
            draw(leaf, seed, l, device, out=buf[i])
        stacked[leaf.name] = buf
    params["blocks"] = _block(config, stacked, n_pro)
    return params
