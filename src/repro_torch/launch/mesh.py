"""Mesh construction of the port, from ``repro.launch.mesh``.

``make_mesh`` joins the started default process group, or starts one:
from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``)
when it is set, else as a single rank over a ``FileStore`` in a fresh
temporary directory (no network).  On the card the group runs NCCL (with
gloo beside it for CPU tensors); ``device="cpu"`` runs gloo alone.
Nothing here runs when the module is imported.

``make_production_mesh`` gives the reference's production meshes (16 x 16
and 2 x 16 x 16 ranks).  They exist only as shapes, or over the fake
process group that the dry run (``launch/dryrun.py``) starts in its own
process, where every collective returns at once.  Everything else that
runs collectives refuses that group (``refuse_fake_group``), so it can
never stand in for a real one.
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


def fake_group_is_up() -> bool:
    import torch.distributed as dist
    return dist.is_initialized() and str(dist.get_backend()).lower() == "fake"


def refuse_fake_group(what: str) -> None:
    """Raise if the started process group is the dry run's fake one."""
    if fake_group_is_up():
        raise RuntimeError(f"{what}: the started process group is the dry run's fake one, "
                           "whose collectives move nothing")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 ranks ("data", "model"), or 2 x 16 x 16 = 512 ("pod",
    "data", "model"): over the dry run's fake process group when it is up,
    else a shape-only mesh as rank 0."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if fake_group_is_up():
        return Mesh.over_process_group(shape, axes)
    return Mesh(shape, axes, rank=0)


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ``torch.distributed``'s
    ranks (rank r at the row-major coordinates of r), starting the process
    group if none is.  The group must hold exactly ``prod(shape)`` ranks,
    and a mesh on the card a group that runs NCCL."""
    import torch.distributed as dist
    refuse_fake_group("make_mesh")
    dev = devlib.resolve(device)
    if not dist.is_initialized():
        _start_group(dev)
    elif dev.type == "cuda" and "nccl" not in str(dist.get_backend()).lower():
        raise RuntimeError(f"the started process group runs {dist.get_backend()}; a mesh "
                           "on the card needs NCCL")
    return Mesh.over_process_group(tuple(shape), tuple(axes))


def batch_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
