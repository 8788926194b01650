"""Shard-wise checkpointing with a manifest, ported from
``repro.training.checkpoint`` with the same on-disk layout, so a checkpoint
written by either package restores in the other:

  <dir>/step_<N:08d>/
    manifest.json          # step, num_leaves, a tree description, and per
                           # leaf its index, path, file, shape and dtype
    leaf_00000.npy ...     # one .npy per leaf, in the reference's order

Leaves come in JAX's flatten order and carry its path strings
(``repro_torch.tree``).  bfloat16 leaves are stored as a uint16 view with
dtype "bfloat16" and restored through an int16 view (numpy has no
bfloat16 without ``ml_dtypes``, which the port does not import).  A
checkpoint is written into ``step_<N>.tmp`` and renamed into place with
its manifest written last, so a crash mid-save never leaves a manifest
that points at missing leaves; only directories with a manifest count.

A state on the store (``distributed/sharding.py``) saves as the whole
state: every rank calls ``save_checkpoint``, each stored leaf is gathered
whole, one leaf at a time, and only the ``writer`` writes it; a restore
into a stored ``like`` keeps each rank's block of every leaf.  So the files
do not depend on the mesh, and either package reads them.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.context import Stored, _narrow, gather
from repro_torch.tree import _is_namedtuple, flatten_with_paths, leaves, unflatten


def _describe(tree) -> str:
    """The tree's structure with ``*`` for each leaf (the role of the
    reference's ``str(treedef)``; restore reads the leaf records only)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}({', '.join(_describe(v) for v in tree)})"
    if isinstance(tree, list):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_describe(v) for v in tree) + ",)"
    return "*"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str | Path, step: int, state: Any,
                    keep: int = 3, writer: bool = True) -> Optional[Path]:
    """Write ``state`` as step ``step``; keep the newest ``keep``.  Every
    rank of a stored state calls it (the gathers are collectives); only
    the ``writer`` touches the disk and gets the path back."""
    directory = Path(directory)
    out = directory / f"step_{step:08d}"
    flat = flatten_with_paths(state)
    if not writer:
        for _, leaf in flat:
            if isinstance(leaf, Stored):
                gather(leaf)
        return None
    directory.mkdir(parents=True, exist_ok=True)
    work = Path(str(out) + ".tmp")
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)

    manifest = {"step": int(step), "num_leaves": len(flat),
                "treedef": _describe(state), "leaves": []}
    for i, (name, leaf) in enumerate(flat):
        arr, logical_dtype = _to_numpy(gather(leaf) if isinstance(leaf, Stored) else leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(work / fname, arr)
        manifest["leaves"].append({
            "index": i, "path": name, "file": fname,
            "shape": list(arr.shape), "dtype": logical_dtype,
        })
    (work / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if out.exists():
        shutil.rmtree(out)
    os.rename(work, out)
    _gc(directory, keep)
    return out


def _gc(directory: Path, keep: int) -> None:
    steps = sorted(d for d in directory.glob("step_*") if (d / "manifest.json").exists())
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(d, ignore_errors=True)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for d in directory.glob("step_*"):
        if (d / "manifest.json").exists():   # only complete checkpoints
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str | Path, like: Any,
                       step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore into the structure of ``like`` (a tree of tensors, whole or
    stored): each leaf lands on its ``like`` leaf's device and dtype, a
    stored one as this rank's block.  Returns (step, state).  Raises on a
    leaf count or a leaf shape that differs from ``like``'s."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves_like = leaves(like)
    if len(leaves_like) != manifest["num_leaves"]:
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                         f"expected {len(leaves_like)}")
    out = []
    for rec, want in zip(manifest["leaves"], leaves_like):
        arr = np.load(d / rec["file"])
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"leaf {rec['path']}: shape {arr.shape} != {tuple(want.shape)}")
        t = _from_numpy(arr, rec["dtype"])
        if isinstance(want, Stored):
            part = _narrow(t, want.block()).to(device=want.device, dtype=want.dtype)
            out.append(want.with_local(part.contiguous()))
        else:
            out.append(t.to(device=want.device, dtype=want.dtype))
    return step, unflatten(like, out)
