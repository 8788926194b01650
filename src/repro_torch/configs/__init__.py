"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

Every architecture of the reference (the ten assigned ones plus the paper's
own Qwen3-30B-A3B) is a module exposing CONFIG (the exact published config)
and smoke_config() (a reduced same-family variant for CPU tests), with the
values of ``repro.configs``.  All of them feed the simulator's cost model,
and ``models.model`` runs every one.  ``at_depth`` cuts a config's depth
(chip_smoke's cuts) and ``depth_pair`` gives the reference's two probe
depths.  ``get_cell``, ``input_specs`` (meta-device stand-ins for a cell's
inputs) and ``dryrun_cells`` serve the dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import torch

from repro_torch.models.config import (SHAPE_CELLS, ModelConfig, ShapeCell,
                                       cell_applicable)

_MODULES = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "internvl2-26b": "internvl2_26b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-370m": "mamba2_370m",
    "granite-3-8b": "granite_3_8b",
    "granite-20b": "granite_20b",
    "gemma2-2b": "gemma2_2b",
    "qwen2-72b": "qwen2_72b",
    "whisper-medium": "whisper_medium",
    "qwen3-30b-a3b": "qwen3_30b_a3b",   # the paper's model (not an assigned cell)
}

ASSIGNED_ARCHS = tuple(a for a in _MODULES if a != "qwen3-30b-a3b")


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def get_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(f"unknown shape cell {name!r}")


# =============================================================================
# input stand-ins (meta tensors; no allocation) — the dry run's contract
# =============================================================================

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell,
                max_seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input of the given cell, with
    the reference's shapes and dtypes.

    train:   {tokens, labels} (+ modality stubs)
    prefill: {tokens} (+ modality stubs) — the step builds its own cache
    decode:  {tokens (B,1), cache_pos (B,)} — the step closes over cache specs
    """
    b, s = cell.global_batch, cell.seq_len
    out: Dict[str, torch.Tensor] = {}
    if cell.kind == "train":
        out["tokens"] = _sds((b, s), torch.int32)
        out["labels"] = _sds((b, s), torch.int32)
    elif cell.kind == "prefill":
        out["tokens"] = _sds((b, s), torch.int32)
    elif cell.kind == "decode":
        out["tokens"] = _sds((b, 1), torch.int32)
        out["cache_pos"] = _sds((b,), torch.int32)
    else:
        raise ValueError(cell.kind)

    # modality frontends are stubs: precomputed embeddings arrive as inputs
    if cfg.family == "vlm" and cell.kind != "decode":
        out["vision_embeds"] = _sds((b, cfg.vision_prefix_len, cfg.d_model), cfg.adtype)
    if cfg.is_encoder_decoder and cell.kind != "decode":
        # stub log-mel frame embeddings; encoder length bounded by the cell seq
        enc_len = min(cfg.encoder_len, s) if cell.kind == "prefill" else min(s, 4096)
        out["frames"] = _sds((b, enc_len, cfg.d_model), cfg.adtype)
    return out


def dryrun_cells(arch: str) -> List[ShapeCell]:
    """The shape cells that apply to an arch."""
    cfg = get_config(arch)
    return [c for c in SHAPE_CELLS if cell_applicable(cfg, c)[0]]


def depth_pair(cfg: ModelConfig):
    """Two reduced depths at which the fully-unrolled module is compiled for
    the roofline measurement; per-step cost is affine in depth, so the full-
    depth cost is the (exact) linear extrapolation.  Depths are chosen so the
    layer-pattern period (MoE interleave, gemma2 local/global, zamba2 shared-
    attn period + epilogue) is preserved.
    """
    if cfg.is_hybrid:
        k = cfg.shared_attn_every
        epi = cfg.num_layers % k
        return (k + epi, 2 * k + epi)
    if cfg.is_moe and cfg.moe_every > 1:
        return (2 * cfg.moe_every, 4 * cfg.moe_every)
    if cfg.is_moe and cfg.first_k_dense > 0:
        return (cfg.first_k_dense + 2, cfg.first_k_dense + 4)
    if cfg.local_global_period > 1:
        p = cfg.local_global_period
        return (2 * p, 4 * p)
    return (4, 8)


def at_depth(cfg: ModelConfig, depth: int) -> ModelConfig:
    """The same architecture at a reduced layer count (roofline probes)."""
    kw = {"num_layers": depth}
    if cfg.is_encoder_decoder:
        kw["num_encoder_layers"] = depth
    return cfg.replace(**kw)


__all__ = ["ASSIGNED_ARCHS", "list_archs", "get_config", "get_smoke_config",
           "get_cell", "input_specs", "dryrun_cells", "depth_pair", "at_depth"]
