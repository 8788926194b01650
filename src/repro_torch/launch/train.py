"""Training driver of the port, from ``repro.launch.train``:

    python -m repro_torch.launch.train --arch <id> [--steps N] [--batch B]
        [--seq S] [--ckpt-dir DIR] [--ckpt-every K] [--full-config]
        [--seed N] [--device cuda|cpu]

The reference's loop: data -> train_step -> metrics -> periodic
checkpoint.  Every run starts by probing the checkpoint directory and
resumes from the newest complete manifest (checkpoints are written
atomically, see ``training/checkpoint.py``); the token stream is a pure
function of the step, so a resumed run replays the batches an
uninterrupted one would have seen.  It runs on the card unless
``device="cpu"``.

As in the reference, every run goes through a mesh and its shard context
(``launch.mesh.make_mesh``, ``launch.steps.make_ctx``): ``mesh_shape``
defaults to (1, n), n the ranks of the started process group (1 when none
is started, as on one card), so a MoE trains through the expert-parallel
path.  A larger mesh runs one rank a process over ``torch.distributed``
(torchrun, or a group the caller started).  The params, the AdamW moments
and each batch live on the store (``distributed/sharding.py``): a rank
holds its block of every leaf its spec splits.  The batch goes to the step
as stored, so each rank computes on its block of the global batch (its
rows over the "data" axis); the loss is the global one on every rank and
rank 0 logs it.  A checkpoint gathers each leaf whole to rank 0, which
writes it, and a resume keeps each rank's block.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as devlib
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.placement import perm_to_slot_map, static_placement
from repro_torch.launch import steps as S
from repro_torch.distributed.sharding import input_shardings, place
from repro_torch.launch.mesh import make_mesh, refuse_fake_group
from repro_torch.models import model as M
from repro_torch.models.config import ShapeCell
from repro_torch.training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import AdamWConfig, init_adamw


def train(arch: str, steps: int = 200, batch: int = 8, seq: int = 128,
          ckpt_dir: str = "", ckpt_every: int = 50, smoke: bool = True,
          mesh_shape=None, log_every: int = 10, seed: int = 0, device=None):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    newest checkpoint) and return the losses of the steps this call ran."""
    import torch.distributed as dist
    refuse_fake_group("train")
    dev = devlib.resolve(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cell = ShapeCell("train_custom", seq, batch, "train")
    opt_cfg = AdamWConfig(moment_dtype="float32", warmup_steps=10,
                          decay_steps=max(steps, 2))
    data = TokenStream(DataConfig(vocab_size=cfg.vocab_size, global_batch=batch,
                                  seq_len=seq, seed=seed))

    if mesh_shape is None:
        mesh_shape = (1, dist.get_world_size() if dist.is_initialized() else 1)
    mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    ctx = S.make_ctx(mesh)
    writer = mesh.rank == 0

    fn, (pspec, _), _ = S.make_train_step(cfg, ctx, cell, opt_cfg, remat=False)
    params = place(M.init_params(cfg, seed=seed, device=dev), pspec, mesh)
    opt_state = init_adamw(params, opt_cfg)
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        start, (params, opt_state) = restore_checkpoint(ckpt_dir, (params, opt_state))
        print(f"[train] resumed from step {start}")

    losses = []
    t0 = time.time()
    for step in range(start, steps):
        b = data.batch_at(step)
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if cfg.is_moe:
            # training uses the unreplicated layout of the static placement
            inv = perm_to_slot_map(static_placement(cfg.num_experts,
                                                    min(ctx.tp, cfg.num_experts)))
            batch_dev["placements"] = torch.from_numpy(inv).to(dev).expand(
                cfg.num_moe_layers(), cfg.num_experts)
        if cfg.family == "vlm":
            batch_dev["vision_embeds"] = torch.zeros(
                (batch, cfg.vision_prefix_len, cfg.d_model), dtype=cfg.adtype, device=dev)
        if cfg.is_encoder_decoder:
            batch_dev["frames"] = torch.zeros(
                (batch, min(cfg.encoder_len, seq), cfg.d_model), dtype=cfg.adtype, device=dev)
        batch_dev = place(batch_dev, input_shardings(cfg, ctx, cell, batch_dev), mesh)
        params, opt_state, metrics = fn(params, opt_state, batch_dev)
        losses.append(float(metrics["loss"]))
        if writer and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)")
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, (params, opt_state), writer=writer)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, (params, opt_state), writer=writer)
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-30b-a3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    losses = train(args.arch, args.steps, args.batch, args.seq, args.ckpt_dir,
                   args.ckpt_every, smoke=not args.full_config, seed=args.seed,
                   device=args.device)
    print(f"[train] done; first loss {losses[0]:.4f} last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
