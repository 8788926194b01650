#!/usr/bin/env python3
"""Digests of the weights a cell's configuration draws: each leaf's path,
shape, type and the sha256 of its bytes, over the port's tree
(``weights.program_params``) and over each layer as the reference draws it
(``weights.layer``).  Two harnesses that draw alike print the same digests.

    python3 bench/digest.py --workload <cell> --seed <n> [--root <checkout>]

``--root`` takes the harness of another checkout (a parent's ``git
archive``) and digests it with this file, so both sides are read alike.
On the card the weights are drawn at the cell's full widths.
"""
from __future__ import annotations

import hashlib
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Tuple


def leaf_sha(t) -> str:
    """sha256 of a tensor's bytes, read to the host a slice at a time."""
    import torch
    h = hashlib.sha256()
    for part in (t if t.dim() > 1 else [t]):
        h.update(part.contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def flat(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, tensor) of every leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def lines(tree, pool=None) -> List[str]:
    leaves = list(flat(tree))
    shas = (pool.map if pool else map)(leaf_sha, [t for _, t in leaves])
    return [f"{p} {tuple(t.shape)} {str(t.dtype).replace('torch.', '')} {s}"
            for (p, t), s in zip(leaves, shas)]


def sha(texts: List[str]) -> str:
    return hashlib.sha256("\n".join(texts).encode()).hexdigest()


def digest(config: dict, seed: int, device) -> Dict[str, object]:
    """``program``: the port's tree, with ``program_lines`` leaf by leaf;
    ``layers``: one digest a layer, and ``layers_all`` over them.  Leaves
    are hashed eight at a time (``hashlib`` and the copies to the host let
    go of the interpreter's lock)."""
    import gc

    import torch

    from bench import weights
    with ThreadPoolExecutor(8) as pool:
        params = weights.program_params(config, seed, device)
        program = lines(params, pool)
        del params
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        layers = [sha(lines(weights.layer(config, seed, l, device), pool))
                  for l in range(config["num_hidden_layers"])]
    return {"program": sha(program), "layers_all": sha(layers), "layers": layers,
            "program_lines": program}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    a = ap.parse_args(argv)
    sys.path[:0] = [a.root]
    import json

    import torch

    from bench import spec
    config = spec.find_cell(a.workload, Path(a.root)).config
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = digest(config, a.seed, device)
    print(json.dumps({"workload": a.workload, "seed": a.seed, "root": a.root, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
