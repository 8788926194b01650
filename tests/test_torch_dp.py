"""Batch blocks: the port's ctx'd steps on a stored batch compute on each
rank's rows only, against the JAX reference on the same mesh, on the CPU.

The port runs as gloo ranks forked in a subprocess, one group per mesh:
(2, 1) and (2, 2) ("data", "model") and (2, 2, 1) ("pod", "data",
"model").  The reference runs in two subprocesses per mesh (half the
archs each) with 8 forced host devices on a directly built
``jax.sharding.Mesh``, its steps jitted (as tests/test_torch_store.py runs
them).  Both start from the port's seed-0 weights of the qwen3,
deepseek-v2, gemma2, mamba2 and whisper smoke configs (f32) and exchange
``.npz`` files.

* Training: three steps of ``launch.train`` (on the pod mesh, its loop by
  hand: ``train()`` builds a ("data", "model") mesh, as the reference's
  does) against the reference's ``make_train_step``: every loss, and the
  final params and moments from the checkpoint the ranks wrote; and the
  gradients at the initial weights on step 0's batch (the reference's
  from its first step's first moment).  All within f32 2e-4.
* Serving: the prefill step's first tokens and two decode steps' tokens
  identical, the prefill's and each decode step's logits within 2e-4.
* Rows: on rank 0 of (2, 1) every block of every arch sees half the
  global batch.
* ``moe_apply`` under batch blocks on (2, 2) (5 experts, which the model
  axis does not divide), at a capacity that drops: the loss, gradients
  and statistics equal the reference's global-capacity ones, and a block
  that keeps by its own positions drops otherwise.
* A whole cache under batch blocks is refused (one rank, no group).
* MoE statistics on (2, 1), on a batch whose two data shards route
  differently (one shard repeats one token): the load-balance and z losses
  and the expert counts equal the reference's, and the mean of the
  per-shard load-balance losses (each rank's statistics on its own shard
  alone) falls outside the 2e-4 gate.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as TC
from repro_torch.training.optimizer import AdamWConfig, init_adamw

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-30b-a3b", "deepseek-v2-236b", "gemma2-2b", "mamba2-370m", "whisper-medium")
MOE_ARCHS = ("qwen3-30b-a3b", "deepseek-v2-236b")
MESHES = {"2x1": [[2, 1], ["data", "model"]], "2x2": [[2, 2], ["data", "model"]],
          "2x2x1": [[2, 2, 1], ["pod", "data", "model"]]}
CONST = dict(archs=ARCHS, moe_archs=MOE_ARCHS, meshes=MESHES, steps=3, batch=4, seq=16,
             prompt=14, decode=2)
TOL = dict(rtol=2e-4, atol=2e-4)

# Shared by both scripts: the constants, the train loop's settings and
# batches (``launch.train``'s), and the serving inputs.
_COMMON = r'''
import json, os, sys
import numpy as np
OUT = sys.argv[1]
C = json.load(open(os.path.join(OUT, "const.json")))
B, SEQ, STEPS, PROMPT, NDEC = C["batch"], C["seq"], C["steps"], C["prompt"], C["decode"]


def serve_inputs(cfg):
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.normal(size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out


def local_moe_cfg(get_smoke_config):
    """qwen3's smoke config with 5 experts, which a model axis of 2 does
    not divide (every MoE layer runs ``moe_apply``), and capacity factor
    0.5 (selections drop across the blocks)."""
    return get_smoke_config("qwen3-30b-a3b").replace(num_experts=5, capacity_factor=0.5)


def skewed_tokens(cfg):
    """Shard 0 repeats one token, shard 1 is random: they route apart."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    toks[:B // 2] = 5
    return toks
'''

_PORT = _COMMON + r'''
import tempfile
from unittest import mock
import torch, torch.distributed as dist, torch.multiprocessing as mp


def stored_batch(cfg, ctx, cell, data, step):
    """``launch.train``'s batch of ``step``, stored by its specs."""
    from repro_torch.core.placement import perm_to_slot_map, static_placement
    from repro_torch.distributed.sharding import input_shardings, place
    b = {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}
    if cfg.is_moe:
        inv = perm_to_slot_map(static_placement(cfg.num_experts, min(ctx.tp, cfg.num_experts)))
        b["placements"] = torch.from_numpy(inv).expand(cfg.num_moe_layers(), cfg.num_experts)
    if cfg.is_encoder_decoder:
        b["frames"] = torch.zeros((B, min(cfg.encoder_len, SEQ), cfg.d_model), dtype=cfg.adtype)
    return place(b, input_shardings(cfg, ctx, cell, b), ctx.mesh)


def loss_of(cfg):
    """``make_train_step``'s loss."""
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M

    def loss(p, batch):
        kw = {k: batch[k] for k in ("frames",) if k in batch}
        logits, aux = M.forward_train(p, cfg, batch["tokens"],
                                      placements=batch.get("placements"), **kw)
        out = S.cross_entropy(logits, batch["labels"])
        if cfg.is_moe:
            out = out + cfg.router_aux_coef * aux["load_balance_loss"] \
                + cfg.router_z_coef * aux["router_z_loss"]
        return out
    return loss


def setup(arch, ctx):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.models.config import ShapeCell
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.optimizer import AdamWConfig
    cfg = get_smoke_config(arch)
    cell = ShapeCell("train_custom", SEQ, B, "train")
    opt = AdamWConfig(moment_dtype="float32", warmup_steps=10, decay_steps=max(STEPS, 2))
    data = TokenStream(DataConfig(vocab_size=cfg.vocab_size, global_batch=B, seq_len=SEQ,
                                  seed=0))
    return cfg, cell, opt, data


def train_by_hand(arch, ctx, ckpt):
    """``launch.train``'s loop on ``ctx``'s mesh (any axes)."""
    from repro_torch.distributed.sharding import place
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.optimizer import init_adamw
    cfg, cell, opt, data = setup(arch, ctx)
    fn, (pspec, _), _ = S.make_train_step(cfg, ctx, cell, opt, remat=False)
    params = place(M.init_params(cfg, seed=0, device="cpu"), pspec, ctx.mesh)
    state = init_adamw(params, opt)
    losses = []
    for step in range(STEPS):
        params, state, m = fn(params, state, stored_batch(cfg, ctx, cell, data, step))
        losses.append(float(m["loss"]))
    save_checkpoint(ckpt, STEPS, (params, state), writer=ctx.mesh.rank == 0)
    return losses


def gradients(arch, ctx, rows):
    """The gradient tree (gathered whole) at the initial weights on step 0's
    batch, through ``batch_view`` and ``value_and_grad`` as the train step
    runs them; ``rows`` collects the batch each block sees."""
    from repro_torch.distributed.context import gather, shard_ctx
    from repro_torch.distributed.sharding import param_specs, place
    from repro_torch.launch import steps as S
    from repro_torch.models import blocks as Bk
    from repro_torch.models import model as M
    from repro_torch.tree import flatten_with_paths
    cfg, cell, opt, data = setup(arch, ctx)
    params = place(M.init_params(cfg, seed=0, device="cpu"), param_specs(cfg, ctx), ctx.mesh)
    bctx, batch = S.batch_view(ctx, stored_batch(cfg, ctx, cell, data, 0))

    def spy(name):
        real = getattr(Bk, name)

        def call(p, c, x, *a, **kw):
            rows.append(int(x.shape[0]))
            return real(p, c, x, *a, **kw)
        return mock.patch.object(Bk, name, call)

    with shard_ctx(bctx), spy("attn_block_full"), spy("mamba_block_full"), \
            spy("cross_block_full"), spy("encoder_block_full"):
        loss, grads = S.value_and_grad(loss_of(cfg), params, batch, ctx=bctx)
    return float(loss), {p: gather(g).numpy() for p, g in flatten_with_paths(grads)}


def clone_tree(tree):
    from repro_torch.distributed.context import Stored
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.with_local(tree.local.clone()) if isinstance(tree, Stored) else tree.clone()


def serve(arch, ctx):
    """The ctx'd prefill step and NDEC decode steps on a stored batch:
    tokens, and the logits of the same calls under ``batch_view``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.context import gather, shard_ctx
    from repro_torch.distributed.sharding import (cache_specs, input_shardings, param_specs,
                                                  place, stored_zeros)
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeCell
    cfg = get_smoke_config(arch)
    mesh, total = ctx.mesh, PROMPT + NDEC
    params = place(M.init_params(cfg, seed=0, device="cpu"), param_specs(cfg, ctx), mesh)
    pl = S.placements_input(cfg, "cpu")
    inp = {k: torch.from_numpy(v) for k, v in serve_inputs(cfg).items()}
    pcell, dcell = ShapeCell("p", total, B, "prefill"), ShapeCell("d", total, B, "decode")

    def placed(batch, cell):
        if pl is not None:
            batch["placements"] = pl
        return place(batch, input_shardings(cfg, ctx, cell, batch), mesh)

    def rows_of(x):
        return mesh.all_gather(x, ctx.batch_axes, dim=0).numpy()

    out = {}
    pb = placed(dict(inp), pcell)
    first, cache = S.make_prefill_step(cfg, ctx, pcell)[0](params, pb)
    bctx, lb = S.batch_view(ctx, pb)
    scratch = stored_zeros(M.cache_shapes(cfg, B, total), cache_specs(cfg, ctx, B, total), mesh,
                           cfg.adtype, "cpu")
    with torch.no_grad(), shard_ctx(bctx):
        logits, _, _ = M.prefill(params, cfg, lb["tokens"], scratch, placements=lb.get("placements"),
                                 **{k: lb[k] for k in ("frames",) if k in lb})
    out["prefill_logits"] = rows_of(logits)
    nxt = gather(first)
    out["first"] = nxt.numpy()
    dec = S.make_decode_step(cfg, ctx, dcell)[0]
    toks = []
    for i in range(NDEC):
        db = placed({"tokens": nxt[:, None],
                     "cache_pos": torch.full((B,), PROMPT + i, dtype=torch.int32)}, dcell)
        bctx, lb = S.batch_view(ctx, db)
        with torch.no_grad(), shard_ctx(bctx):
            lg, _, _ = M.decode_step(params, cfg, lb["tokens"], clone_tree(cache),
                                     lb["cache_pos"], placements=lb.get("placements"))
        out[f"decode_logits.{i}"] = rows_of(lg)
        nxt, cache = dec(params, cache, db)
        nxt = gather(nxt)
        toks.append(nxt.numpy())
    out["tokens"] = np.stack(toks)
    return out


def moe_stats(arch, ctx):
    """The forward's MoE statistics on the skewed batch under batch blocks,
    and each rank's statistics of its own shard alone (``sum_blocks``
    planted to scale the rank's sums as if every shard were its own)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import context as CX
    from repro_torch.distributed.sharding import input_shardings, param_specs, place
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeCell
    cfg = get_smoke_config(arch)
    params = place(M.init_params(cfg, seed=0, device="cpu"), param_specs(cfg, ctx), ctx.mesh)
    cell = ShapeCell("t", SEQ, B, "train")
    batch = {"tokens": torch.from_numpy(skewed_tokens(cfg)),
             "placements": S.placements_input(cfg, "cpu")}
    bctx, lb = S.batch_view(ctx, place(batch, input_shardings(cfg, ctx, cell, batch), ctx.mesh))

    def run():
        with torch.no_grad(), CX.shard_ctx(bctx):
            _, _, aux = M.forward(params, cfg, lb["tokens"], placements=lb["placements"],
                                  stats=True)
        return {k: aux[k].numpy() for k in ("load_balance_loss", "router_z_loss",
                                            "expert_counts")}

    out = run()
    own = lambda x, c=None: x * (c or CX.current_ctx()).dp
    with mock.patch.object(CX, "sum_blocks", own):
        out["own_shard_lb"] = run()["load_balance_loss"]
    return out


def local_moe(ctx):
    """``local_moe_cfg`` on the skewed batch: the loss and gradients (as
    ``gradients``), the forward's statistics, and the dropped fraction with
    each block's earlier-blocks offset planted to 0 (each block then keeps
    by its own positions)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.context import gather, shard_ctx
    from repro_torch.distributed.sharding import input_shardings, param_specs, place
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.models import moe as MoE
    from repro_torch.models.config import ShapeCell
    from repro_torch.tree import flatten_with_paths
    cfg = local_moe_cfg(get_smoke_config)
    params = place(M.init_params(cfg, seed=0, device="cpu"), param_specs(cfg, ctx), ctx.mesh)
    toks = skewed_tokens(cfg)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    cell = ShapeCell("t", SEQ, B, "train")
    bctx, lb = S.batch_view(ctx, place(batch, input_shardings(cfg, ctx, cell, batch), ctx.mesh))
    with shard_ctx(bctx):
        loss, grads = S.value_and_grad(loss_of(cfg), params, lb, ctx=bctx)

    def stats():
        with torch.no_grad(), shard_ctx(bctx):
            return M.forward(params, cfg, lb["tokens"], stats=True)[2]

    aux = stats()
    zero = lambda slot_idx, ns, c: torch.zeros_like(slot_idx)
    with mock.patch.object(MoE, "_earlier_blocks", zero):
        fault = stats()["dropped_frac"]
    out = {f"local_moe.grad.{p}": gather(g).numpy() for p, g in flatten_with_paths(grads)}
    out.update({f"local_moe.aux.{k}": aux[k].numpy() for k in
                ("load_balance_loss", "router_z_loss", "expert_counts", "dropped_frac")})
    out["local_moe.loss"] = loss.numpy()
    out["local_moe.fault_dropped"] = fault.numpy()
    return out


def work(rank, world, store, name):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    shape, axes = C["meshes"][name]
    mesh = make_mesh(shape, axes, device="cpu")
    ctx = S.make_ctx(mesh)
    res, arrays = {}, {}
    for arch in C["archs"]:
        ckpt = os.path.join(OUT, f"ckpt_{name}_{arch}")
        if len(shape) == 2:
            losses = train(arch, steps=STEPS, batch=B, seq=SEQ, mesh_shape=tuple(shape),
                           device="cpu", log_every=1000, ckpt_dir=ckpt)
        else:
            losses = train_by_hand(arch, ctx, ckpt)
        rows = []
        loss0, grads = gradients(arch, ctx, rows)
        res[arch] = {"losses": losses, "loss0": loss0, "rows": rows}
        arrays.update({f"{arch}.grad.{p}": g for p, g in grads.items()})
        arrays.update({f"{arch}.{k}": v for k, v in serve(arch, ctx).items()})
        if name == "2x1" and arch in C["moe_archs"]:
            st = moe_stats(arch, ctx)
            res[arch]["own_shard_lb"] = float(st.pop("own_shard_lb"))
            arrays.update({f"{arch}.aux.{k}": v for k, v in st.items()})
    if name == "2x2":
        arrays.update(local_moe(ctx))
    every = [None] * world
    dist.all_gather_object(every, res)
    if rank == 0:
        np.savez(os.path.join(OUT, f"port_{name}.npz"), **arrays)
        json.dump(every, open(os.path.join(OUT, f"port_{name}.json"), "w"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    ctxs = []
    for name, (shape, _) in C["meshes"].items():
        store = os.path.join(tempfile.mkdtemp(), "store")
        ctxs.append(mp.start_processes(work, args=(int(np.prod(shape)), store, name),
                                       nprocs=int(np.prod(shape)), start_method="fork",
                                       join=False))
    for c in ctxs:
        while not c.join():
            pass
    print("PORT_OK")
'''

# The reference on one mesh (argv[2]): its make_train_step (the first
# step's first moment and grad norm give its gradient), its prefill and
# decode steps with the logits of the same calls, and its forward's MoE
# statistics.
_REFERENCE = _COMMON + r'''
import pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.core.placement import perm_to_slot_map, static_placement
from repro.distributed.context import shard_ctx
from repro.launch import steps as S
from repro.models import model as M
from repro.models.config import ShapeCell
from repro.training.data import DataConfig, TokenStream
from repro.training.optimizer import AdamWConfig, init_adamw

def loss_of(cfg):
    """``make_train_step``'s loss."""
    def loss_fn(p, batch):
        kw = {k: batch[k] for k in ("frames",) if k in batch}
        logits, aux = M.forward_train(p, cfg, batch["tokens"],
                                      placements=batch.get("placements"), **kw)
        loss = S.cross_entropy(logits, batch["labels"])
        if cfg.is_moe:
            loss = loss + cfg.router_aux_coef * aux["load_balance_loss"] \
                + cfg.router_z_coef * aux["router_z_loss"]
        return loss
    return loss_fn


def init_of(tag):
    return jax.tree.map(jnp.asarray, pickle.load(open(os.path.join(OUT, f"init_{tag}.pkl"), "rb")))


name, part = sys.argv[2], int(sys.argv[3])       # the mesh, and which half of the work
shape, axes = C["meshes"][name]
mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), tuple(axes))
ctx = S.make_ctx(mesh)
out = {}
for arch in C["archs"][part::2]:
    cfg = get_smoke_config(arch)
    init = init_of(arch)
    opt = AdamWConfig(moment_dtype="float32", warmup_steps=10, decay_steps=max(STEPS, 2))
    data = TokenStream(DataConfig(vocab_size=cfg.vocab_size, global_batch=B, seq_len=SEQ, seed=0))
    inv = perm_to_slot_map(static_placement(cfg.num_experts, min(ctx.tp, cfg.num_experts))) \
        if cfg.is_moe else None

    with mesh:
        fn, _, _ = S.make_train_step(cfg, ctx, ShapeCell("train_custom", SEQ, B, "train"), opt,
                                     remat=False)

        jfn = jax.jit(fn)
        params, state, losses = init, init_adamw(init, opt), []
        for step in range(STEPS):
            b = {k: jnp.asarray(v) for k, v in data.batch_at(step).items()}
            if cfg.is_moe:
                b["placements"] = jnp.broadcast_to(jnp.asarray(inv),
                                                   (cfg.num_moe_layers(), cfg.num_experts))
            if cfg.is_encoder_decoder:
                b["frames"] = jnp.zeros((B, min(cfg.encoder_len, SEQ), cfg.d_model), cfg.adtype)
            params, state, m = jfn(params, state, b)
            losses.append(float(m["loss"]))
            if step == 0:       # the first moment holds the step's clipped gradient
                out[f"{arch}.grad_norm0"] = np.asarray(m["grad_norm"])
                for p, g in jax.tree_util.tree_flatten_with_path(state.m)[0]:
                    out[f"{arch}.m1.{jax.tree_util.keystr(p)}"] = np.asarray(g)
        for p, x in jax.tree_util.tree_flatten_with_path((params, state))[0]:
            out[f"{arch}.state.{jax.tree_util.keystr(p)}"] = np.asarray(x)
        out[f"{arch}.losses"] = np.asarray(losses)

        total = PROMPT + NDEC
        pre, _, _ = S.make_prefill_step(cfg, ctx, ShapeCell("p", total, B, "prefill"))
        dec, _, _ = S.make_decode_step(cfg, ctx, ShapeCell("d", total, B, "decode"))
        pl = (jnp.broadcast_to(jnp.arange(cfg.num_experts, dtype=jnp.int32),
                               (cfg.num_moe_layers(), cfg.num_experts)) if cfg.is_moe else None)

        def serve(p, inp):
            extra = {"placements": pl} if pl is not None else {}
            fkw = {k: inp[k] for k in ("frames",) if k in inp}
            first, cache = pre(p, {**inp, **extra})
            with shard_ctx(ctx):
                logits, _, _ = M.prefill(p, cfg, inp["tokens"], M.init_cache(cfg, B, total),
                                         placements=pl, **fkw)
            nxt, toks, dlog = first, [], []
            for i in range(NDEC):
                pos = jnp.full((B,), PROMPT + i, jnp.int32)
                with shard_ctx(ctx):
                    lg, _, _ = M.decode_step(p, cfg, nxt[:, None], cache, pos, placements=pl)
                dlog.append(lg)
                nxt, cache = dec(p, cache, {"tokens": nxt[:, None], "cache_pos": pos, **extra})
                toks.append(nxt)
            return first, logits, jnp.stack(toks), dlog

        first, logits, toks, dlog = jax.jit(serve)(
            init, {k: jnp.asarray(v) for k, v in serve_inputs(cfg).items()})
        out[f"{arch}.first"], out[f"{arch}.prefill_logits"] = np.asarray(first), np.asarray(logits)
        out[f"{arch}.tokens"] = np.asarray(toks)
        for i, lg in enumerate(dlog):
            out[f"{arch}.decode_logits.{i}"] = np.asarray(lg)

        if name == "2x1" and arch in C["moe_archs"]:
            def stats(p, t):
                with shard_ctx(ctx):
                    return M.forward(p, cfg, t, placements=pl, stats=True)[2]
            aux = jax.jit(stats)(init, jnp.asarray(skewed_tokens(cfg)))
            for k in ("load_balance_loss", "router_z_loss", "expert_counts"):
                out[f"{arch}.aux.{k}"] = np.asarray(aux[k])
if name == "2x2" and part == 1:
    cfg = local_moe_cfg(get_smoke_config)
    init = init_of("local_moe")
    toks = skewed_tokens(cfg)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(np.roll(toks, -1, 1))}

    def grads_and_stats(p, b):
        with shard_ctx(ctx):
            return (jax.value_and_grad(loss_of(cfg))(p, b),
                    M.forward(p, cfg, b["tokens"], stats=True)[2])

    with mesh:
        (loss, grads), aux = jax.jit(grads_and_stats)(init, batch)
    out["local_moe.loss"] = np.asarray(loss)
    for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"local_moe.grad.{jax.tree_util.keystr(p)}"] = np.asarray(g)
    for k in ("load_balance_loss", "router_z_loss", "expert_counts", "dropped_frac"):
        out[f"local_moe.aux.{k}"] = np.asarray(aux[k])
np.savez(os.path.join(OUT, f"ref_{name}_{part}.npz"), **out)
print("REFERENCE_OK")
'''


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _run(args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(ROOT)), "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    (d / "const.json").write_text(json.dumps(CONST))
    inits = {arch: get_smoke_config(arch) for arch in ARCHS}
    inits["local_moe"] = get_smoke_config("qwen3-30b-a3b").replace(num_experts=5,
                                                                    capacity_factor=0.5)
    for tag, cfg in inits.items():
        with open(d / f"init_{tag}.pkl", "wb") as f:
            pickle.dump(_numpy_tree(TM.init_params(cfg, seed=0, device="cpu")), f)
    (d / "port.py").write_text(_PORT)
    (d / "reference.py").write_text(_REFERENCE)
    procs = {"PORT": [_run([str(d / "port.py"), str(d)])],
             "REFERENCE": [_run([str(d / "reference.py"), str(d), name, str(part)])
                           for name in MESHES for part in (0, 1)]}
    for tag, group in procs.items():
        for proc in group:
            stdout, stderr = proc.communicate(timeout=400)
            assert proc.returncode == 0 and f"{tag}_OK" in stdout, \
                f"{tag}: rc {proc.returncode}\n{stdout[-2000:]}\n{stderr[-4000:]}"
    port = {n: (json.loads((d / f"port_{n}.json").read_text()),
                dict(np.load(d / f"port_{n}.npz"))) for n in MESHES}
    ref = {n: {**np.load(d / f"ref_{n}_0.npz"), **np.load(d / f"ref_{n}_1.npz")} for n in MESHES}
    return d, port, ref


def _state_like(arch):
    params = TM.init_params(get_smoke_config(arch), seed=0, device="cpu")
    return params, init_adamw(params, AdamWConfig(moment_dtype="float32"))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_steps_match_reference(runs, mesh, arch):
    """Every rank's losses, then the final params and moments (restored
    from the ranks' checkpoint) within 2e-4 of the reference's."""
    from repro_torch.tree import flatten_with_paths
    d, port, ref = runs
    r = ref[mesh]
    for res in port[mesh][0]:
        np.testing.assert_allclose(res[arch]["losses"], r[f"{arch}.losses"], **TOL)
    _, state = TC.restore_checkpoint(d / f"ckpt_{mesh}_{arch}", _state_like(arch))
    flat = flatten_with_paths(state)
    want = {k[len(f"{arch}.state."):]: v for k, v in r.items()
            if k.startswith(f"{arch}.state.")}
    assert sorted(p for p, _ in flat) == sorted(want)
    for path, leaf in flat:
        np.testing.assert_allclose(leaf.numpy(), want[path], **TOL, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_match_reference(runs, mesh, arch):
    """The gradients at the initial weights on step 0's batch: every leaf
    of the port's (gathered from its blocks) within 2e-4 of the gradient of
    the reference's first train step (its first moment over (1 - b1),
    unclipped by its grad norm), and the loss."""
    _, port, ref = runs
    res, got = port[mesh]
    r = ref[mesh]
    opt = AdamWConfig()
    scale = min(1.0, opt.grad_clip / max(float(r[f"{arch}.grad_norm0"]), 1e-9))
    want = {f"{arch}.grad.{k[len(arch) + 4:]}": v.astype(np.float64) / (1 - opt.b1) / scale
            for k, v in r.items() if k.startswith(f"{arch}.m1.")}
    assert sorted(k for k in got if k.startswith(f"{arch}.grad.")) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)
    for rank in res:
        np.testing.assert_allclose(rank[arch]["loss0"], r[f"{arch}.losses"][0], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_serving_steps_match_reference(runs, mesh, arch):
    """The prefill step's first tokens and the decode steps' tokens
    identical; the logits of the prefill and of every decode step within
    2e-4."""
    _, port, ref = runs
    got, r = port[mesh][1], ref[mesh]
    np.testing.assert_array_equal(got[f"{arch}.first"], r[f"{arch}.first"])
    np.testing.assert_array_equal(got[f"{arch}.tokens"], r[f"{arch}.tokens"])
    np.testing.assert_allclose(got[f"{arch}.prefill_logits"], r[f"{arch}.prefill_logits"],
                               **TOL)
    for i in range(CONST["decode"]):
        np.testing.assert_allclose(got[f"{arch}.decode_logits.{i}"],
                                   r[f"{arch}.decode_logits.{i}"], **TOL)


def test_each_rank_computes_half_the_batch(runs):
    """On rank 0 of (2, 1) every block of every arch (its training
    forward) sees B / 2 rows; on (2, 2, 1) B / 4."""
    _, port, _ = runs
    for mesh, rows in (("2x1", CONST["batch"] // 2), ("2x2x1", CONST["batch"] // 4)):
        for arch in ARCHS:
            seen = port[mesh][0][0][arch]["rows"]
            assert seen and set(seen) == {rows}, (mesh, arch, seen)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_statistics_are_global(runs, arch):
    """On (2, 1), shards that route apart: the load-balance and z losses
    within 2e-4 of the reference's and the expert counts equal; the mean
    of the per-shard load-balance losses falls outside the gate."""
    _, port, ref = runs
    res, got = port["2x1"]
    r = ref["2x1"]
    for k in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(got[f"{arch}.aux.{k}"], r[f"{arch}.aux.{k}"], **TOL)
    np.testing.assert_array_equal(got[f"{arch}.aux.expert_counts"],
                                  r[f"{arch}.aux.expert_counts"])
    per_shard = np.mean([rank[arch]["own_shard_lb"] for rank in res])
    assert not np.allclose(per_shard, r[f"{arch}.aux.load_balance_loss"], **TOL)


def test_moe_apply_under_batch_blocks_keeps_the_global_capacity(runs):
    """On (2, 2), 5 experts (``moe_apply`` in every MoE layer) at capacity
    factor 0.5 on shards that route apart: the loss, every gradient, the
    router losses within 2e-4 of the reference's, the expert counts and
    the dropped fraction equal; with each block's offset planted to 0 the
    dropped fraction differs (the global positions decide the drops)."""
    _, port, ref = runs
    got, r = port["2x2"][1], ref["2x2"]
    want = {k: v for k, v in r.items() if k.startswith("local_moe.")}
    assert sorted(k for k in got if k.startswith("local_moe.") and k != "local_moe.fault_dropped") \
        == sorted(want)
    for k, v in want.items():
        if k.endswith(("expert_counts", "dropped_frac")):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)
    assert np.all(r["local_moe.aux.dropped_frac"] > 0)          # every MoE layer drops
    assert np.any(got["local_moe.fault_dropped"] != r["local_moe.aux.dropped_frac"])


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ["qwen3-30b-a3b", "deepseek-v2-236b", "mamba2-370m"])
def test_a_whole_cache_is_refused_under_batch_blocks(arch, kind):
    """Under batch blocks a whole (unstored) cache holds every row where
    the activations hold the rank's: the sequence-sharded decodes (GQA,
    MLA) and an opened cache (prefill, the SSM decode) refuse it before
    any collective runs."""
    from repro_torch.distributed.context import Mesh, ShardCtx, shard_ctx
    cfg = get_smoke_config(arch)
    ctx = ShardCtx(mesh=Mesh((1, 1), ("data", "model"), rank=0), batch_axes=("data",),
                   batch_blocks=True)
    params = TM.init_params(cfg, seed=0, device="cpu")
    cache = TM.init_cache(cfg, 2, 8, device="cpu")
    with shard_ctx(ctx), torch.no_grad(), pytest.raises(ValueError, match="whole .*cache"):
        if kind == "decode":
            TM.decode_step(params, cfg, torch.zeros((2, 1), dtype=torch.long), cache,
                           torch.zeros(2, dtype=torch.int32))
        else:
            TM.prefill(params, cfg, torch.zeros((2, 4), dtype=torch.long), cache)
