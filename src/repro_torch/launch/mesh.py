"""Mesh construction of the port, from ``repro.launch.mesh``.

``make_mesh`` joins the started default process group, or starts one:
from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``)
when it is set, else as a single rank over a ``FileStore`` in a fresh
temporary directory (no network).  On the card the group runs NCCL (with
gloo beside it for CPU tensors); ``device="cpu"`` runs gloo alone.
Nothing here runs when the module is imported.

The production meshes (16 x 16 and 2 x 16 x 16 ranks) and the dry run
that lowers every cell on them wait for the last slice of the port
(ROADMAP.md, Queue 1 item 16e).
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import torch

from repro_torch import device as devlib
from repro_torch.distributed.context import Mesh


def _start_group(dev: torch.device) -> None:
    """Start the default process group; it is destroyed when the process
    exits."""
    import torch.distributed as dist
    backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        atexit.register(shutil.rmtree, tmp, True)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    atexit.register(lambda: dist.is_initialized() and dist.destroy_process_group())


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ``torch.distributed``'s
    ranks (rank r at the row-major coordinates of r), starting the process
    group if none is.  The group must hold exactly ``prod(shape)`` ranks,
    and a mesh on the card a group that runs NCCL."""
    import torch.distributed as dist
    dev = devlib.resolve(device)
    if not dist.is_initialized():
        _start_group(dev)
    elif dev.type == "cuda" and "nccl" not in str(dist.get_backend()).lower():
        raise RuntimeError(f"the started process group runs {dist.get_backend()}; a mesh "
                           "on the card needs NCCL")
    return Mesh.over_process_group(tuple(shape), tuple(axes))


def batch_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
