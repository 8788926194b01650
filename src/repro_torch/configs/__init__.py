"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

Every architecture of the reference (the ten assigned ones plus the paper's
own Qwen3-30B-A3B) is a module exposing CONFIG (the exact published config)
and smoke_config() (a reduced same-family variant for CPU tests), with the
values of ``repro.configs``.  All of them feed the simulator's cost model,
and ``models.model`` runs every one.  ``at_depth`` cuts a config's depth
(chip_smoke's cuts) and ``depth_pair`` gives the reference's two probe
depths; the dry-run's input stand-ins (``input_specs``, ``dryrun_cells``)
wait for the dry-run slice (ROADMAP.md, Queue 1 item 16e).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

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
           "depth_pair", "at_depth"]
