"""The model axis: the port's ctx'd steps compute every dense layer on its
"model" blocks, against the JAX reference's GSPMD on the same mesh, on the
CPU.

The port runs as gloo ranks forked in one subprocess, one group per mesh:
(1, 2) and (2, 2) ("data", "model").  The reference runs in three
subprocesses per mesh (a third of the cases each) with 8 forced host devices on a
directly built ``jax.sharding.Mesh`` (``jax.make_mesh``'s Explicit axes
would make its ``with_sharding_constraint`` raise on this jax, and its
``_seq_constraint`` / ``_head_constraint`` would never run), its steps
jitted.  Both start from the port's seed-0 weights (f32) of six smoke
configs, each built with the same ``replace`` in both packages:

* qwen3: GQA heads over "model" (cut (b)), its MoE layers taking the
  tokens whole over "model" between sequence-parallel residuals (cut (a)),
  the vocab-parallel embedding, head and loss (cut (d));
* gemma2: window, softcaps and the tied embedding;
* deepseek-v2: MLA's heads over ``wq_b``/``wkv_b``, its dense prologue and
  shared experts;
* mamba2 with 129 tokens of vocabulary, which "model" does not divide:
  the SSD heads (cut (c)) and the embedding split over ``d``;
* zamba2: the shared attention block between mamba blocks;
* qwen2 with 3 query heads and 1 kv head, which "model" does not divide:
  the context-parallel attention on the rank's block of the sequence in
  prefill and training, the whole layer in decode, and ``bq``/``bk``/``bv``.

For each, on both meshes: the prefill step's first tokens and two decode
steps' tokens identical; the prefill's and each decode step's logits, the
loss and every gradient leaf at the initial weights on one batch (the
reference's from its first step's first moment over (1 - b1), unclipped by
its grad norm), and the params after that ``make_train_step`` step, within
f32 2e-4.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
CASES = {"qwen3": ["qwen3-30b-a3b", {}],
         "gemma2": ["gemma2-2b", {}],
         "deepseek": ["deepseek-v2-236b", {}],
         "mamba2": ["mamba2-370m", {"vocab_size": 129}],
         "zamba2": ["zamba2-1.2b", {}],
         "heads3": ["qwen2-72b", {"num_heads": 3, "num_kv_heads": 1}]}
MESHES = {"1x2": [1, 2], "2x2": [2, 2]}
CONST = dict(cases=CASES, meshes=MESHES, batch=4, seq=16, prompt=14, decode=2)
TOL = dict(rtol=2e-4, atol=2e-4)
PARTS = 3                      # reference subprocesses a mesh, a third of the cases each

# Shared by both scripts: the constants, the configs and the inputs.
_COMMON = r'''
import json, os, sys
import numpy as np
OUT = sys.argv[1]
C = json.load(open(os.path.join(OUT, "const.json")))
B, SEQ, PROMPT, NDEC = C["batch"], C["seq"], C["prompt"], C["decode"]


def cfg_of(get_smoke_config, tag):
    base, kw = C["cases"][tag]
    return get_smoke_config(base).replace(**kw)


def train_batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def prompt(cfg):
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
'''

_PORT = _COMMON + r'''
import tempfile
import torch, torch.distributed as dist, torch.multiprocessing as mp


def loss_of(cfg):
    """``make_train_step``'s loss: the vocab-parallel cross-entropy."""
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M

    def loss(p, batch):
        logits, aux = M.forward_train(p, cfg, batch["tokens"],
                                      placements=batch.get("placements"), vocab_blocks=True)
        out = S.cross_entropy(logits, batch["labels"])
        if cfg.is_moe:
            out = out + cfg.router_aux_coef * aux["load_balance_loss"] \
                + cfg.router_z_coef * aux["router_z_loss"]
        return out
    return loss


def clone_tree(tree):
    from repro_torch.distributed.context import Stored
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.with_local(tree.local.clone()) if isinstance(tree, Stored) else tree.clone()


def run_case(tag, ctx):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.context import gather, shard_ctx
    from repro_torch.distributed.sharding import (cache_specs, input_shardings, param_specs,
                                                  place, stored_zeros)
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeCell
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.tree import flatten_with_paths
    cfg = cfg_of(get_smoke_config, tag)
    mesh, out = ctx.mesh, {}
    params = place(M.init_params(cfg, seed=0, device="cpu"), param_specs(cfg, ctx), mesh)
    pl = S.placements_input(cfg, "cpu")

    def placed(batch, cell):
        if pl is not None:
            batch["placements"] = pl
        return place(batch, input_shardings(cfg, ctx, cell, batch), mesh)

    def rows_of(x):
        return mesh.all_gather(x, ctx.batch_axes, dim=0).numpy()

    # one train step, and the gradients at the initial weights
    cell = ShapeCell("t", SEQ, B, "train")
    batch = placed({k: torch.from_numpy(v).long() for k, v in train_batch(cfg).items()}, cell)
    bctx, lb = S.batch_view(ctx, batch)
    with shard_ctx(bctx):
        loss, grads = S.value_and_grad(loss_of(cfg), params, lb, ctx=bctx)
    out["loss"] = loss.numpy()
    out.update({f"grad.{p}": gather(g).numpy() for p, g in flatten_with_paths(grads)})
    opt = AdamWConfig(moment_dtype="float32", warmup_steps=10, decay_steps=2)
    fn = S.make_train_step(cfg, ctx, cell, opt, remat=False)[0]
    new, _, m = fn(params, init_adamw(params, opt), batch)
    out["step_loss"] = m["loss"].numpy()
    out.update({f"param.{p}": gather(x).numpy() for p, x in flatten_with_paths(new)})

    # serving: the prefill step, then decode steps; the logits of the same calls
    total = PROMPT + NDEC
    pcell, dcell = ShapeCell("p", total, B, "prefill"), ShapeCell("d", total, B, "decode")
    pb = placed({"tokens": torch.from_numpy(prompt(cfg))}, pcell)
    first, cache = S.make_prefill_step(cfg, ctx, pcell)[0](params, pb)
    bctx, lb = S.batch_view(ctx, pb)
    scratch = stored_zeros(M.cache_shapes(cfg, B, total), cache_specs(cfg, ctx, B, total), mesh,
                           cfg.adtype, "cpu")
    with torch.no_grad(), shard_ctx(bctx):
        logits = M.prefill(params, cfg, lb["tokens"], scratch, placements=lb.get("placements"))[0]
    out["prefill_logits"] = rows_of(logits)
    nxt = gather(first)
    out["first"] = nxt.numpy()
    dec, toks = S.make_decode_step(cfg, ctx, dcell)[0], []
    for i in range(NDEC):
        db = placed({"tokens": nxt[:, None],
                     "cache_pos": torch.full((B,), PROMPT + i, dtype=torch.int32)}, dcell)
        bctx, lb = S.batch_view(ctx, db)
        with torch.no_grad(), shard_ctx(bctx):
            lg = M.decode_step(params, cfg, lb["tokens"], clone_tree(cache), lb["cache_pos"],
                               placements=lb.get("placements"))[0]
        out[f"decode_logits.{i}"] = rows_of(lg)
        nxt, cache = dec(params, cache, db)
        nxt = gather(nxt)
        toks.append(nxt.numpy())
    out["tokens"] = np.stack(toks)
    return out


def work(rank, world, store, name):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh
    ctx = S.make_ctx(make_mesh(tuple(C["meshes"][name]), ("data", "model"), device="cpu"))
    arrays = {}
    for tag in C["cases"]:
        arrays.update({f"{tag}.{k}": v for k, v in run_case(tag, ctx).items()})
    if rank == 0:
        np.savez(os.path.join(OUT, f"port_{name}.npz"), **arrays)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    ctxs = []
    for name, shape in C["meshes"].items():
        store = os.path.join(tempfile.mkdtemp(), "store")
        ctxs.append(mp.start_processes(work, args=(int(np.prod(shape)), store, name),
                                       nprocs=int(np.prod(shape)), start_method="fork",
                                       join=False))
    for c in ctxs:
        while not c.join():
            pass
    print("PORT_OK")
'''

# The reference on one mesh (argv[2]), part argv[3] of argv[4] of the
# cases: one make_train_step step (its first moment gives the gradients),
# its prefill and decode steps with the logits of the same calls.
_REFERENCE = _COMMON + r'''
import pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.distributed.context import shard_ctx
from repro.launch import steps as S
from repro.models import model as M
from repro.models.config import ShapeCell
from repro.training.optimizer import AdamWConfig, init_adamw


name, part, PARTS = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
shape = C["meshes"][name]
mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), ("data", "model"))
ctx = S.make_ctx(mesh)
out = {}
for tag in list(C["cases"])[part::PARTS]:
    cfg = cfg_of(get_smoke_config, tag)
    init = jax.tree.map(jnp.asarray, pickle.load(open(os.path.join(OUT, f"init_{tag}.pkl"), "rb")))
    pl = (jnp.broadcast_to(jnp.arange(cfg.num_experts, dtype=jnp.int32),
                           (cfg.num_moe_layers(), cfg.num_experts)) if cfg.is_moe else None)
    extra = {"placements": pl} if pl is not None else {}
    batch = {**{k: jnp.asarray(v) for k, v in train_batch(cfg).items()}, **extra}
    with mesh:
        opt = AdamWConfig(moment_dtype="float32", warmup_steps=10, decay_steps=2)
        fn, _, _ = S.make_train_step(cfg, ctx, ShapeCell("t", SEQ, B, "train"), opt, remat=False)
        new, state, m = jax.jit(fn)(init, init_adamw(init, opt), batch)
        out[f"{tag}.step_loss"] = np.asarray(m["loss"])
        for p, x in jax.tree_util.tree_flatten_with_path(new)[0]:
            out[f"{tag}.param.{jax.tree_util.keystr(p)}"] = np.asarray(x)
        # the first moment holds the step's gradient, times (1 - b1) and the
        # clip scale of its norm
        scale = min(1.0, opt.grad_clip / max(float(m["grad_norm"]), 1e-9))
        for p, x in jax.tree_util.tree_flatten_with_path(state.m)[0]:
            out[f"{tag}.grad.{jax.tree_util.keystr(p)}"] = \
                np.asarray(x).astype(np.float64) / (1 - opt.b1) / scale

        total = PROMPT + NDEC
        pre, _, _ = S.make_prefill_step(cfg, ctx, ShapeCell("p", total, B, "prefill"))
        dec, _, _ = S.make_decode_step(cfg, ctx, ShapeCell("d", total, B, "decode"))

        def serve(p, toks):
            first, cache = pre(p, {"tokens": toks, **extra})
            with shard_ctx(ctx):
                logits, _, _ = M.prefill(p, cfg, toks, M.init_cache(cfg, B, total), placements=pl)
            nxt, seq, dlog = first, [], []
            for i in range(NDEC):
                pos = jnp.full((B,), PROMPT + i, jnp.int32)
                with shard_ctx(ctx):
                    lg, _, _ = M.decode_step(p, cfg, nxt[:, None], cache, pos, placements=pl)
                dlog.append(lg)
                nxt, cache = dec(p, cache, {"tokens": nxt[:, None], "cache_pos": pos, **extra})
                seq.append(nxt)
            return first, logits, jnp.stack(seq), dlog

        first, logits, toks, dlog = jax.jit(serve)(init, jnp.asarray(prompt(cfg)))
    out[f"{tag}.first"], out[f"{tag}.prefill_logits"] = np.asarray(first), np.asarray(logits)
    out[f"{tag}.tokens"] = np.asarray(toks)
    for i, lg in enumerate(dlog):
        out[f"{tag}.decode_logits.{i}"] = np.asarray(lg)
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


def _cfg(tag):
    base, kw = CASES[tag]
    return get_smoke_config(base).replace(**kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    (d / "const.json").write_text(json.dumps(CONST))
    for tag in CASES:
        with open(d / f"init_{tag}.pkl", "wb") as f:
            pickle.dump(_numpy_tree(TM.init_params(_cfg(tag), seed=0, device="cpu")), f)
    (d / "port.py").write_text(_PORT)
    (d / "reference.py").write_text(_REFERENCE)
    procs = {"PORT": [_run([str(d / "port.py"), str(d)])],
             "REFERENCE": [_run([str(d / "reference.py"), str(d), name, str(part), str(PARTS)])
                           for name in MESHES for part in range(PARTS)]}
    for tag, group in procs.items():
        for proc in group:
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0 and f"{tag}_OK" in stdout, \
                f"{tag}: rc {proc.returncode}\n{stdout[-2000:]}\n{stderr[-4000:]}"
    port = {n: dict(np.load(d / f"port_{n}.npz")) for n in MESHES}
    ref = {n: {k: v for part in range(PARTS) for k, v in np.load(d / f"ref_{n}_{part}.npz").items()}
           for n in MESHES}
    return port, ref


def _leaves(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


@pytest.mark.parametrize("tag", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_match_reference(runs, mesh, tag):
    """The loss and every gradient leaf at the initial weights, the
    port's vocab-parallel loss through ``value_and_grad`` against the
    reference's first train step."""
    port, ref = runs
    got, want = port[mesh], ref[mesh]
    np.testing.assert_allclose(got[f"{tag}.loss"], want[f"{tag}.step_loss"], **TOL)
    g, w = _leaves(got, f"{tag}.grad."), _leaves(want, f"{tag}.grad.")
    assert sorted(g) == sorted(w) and g
    for k in w:
        np.testing.assert_allclose(g[k], w[k], **TOL, err_msg=k)


@pytest.mark.parametrize("tag", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_step_matches_reference(runs, mesh, tag):
    """One ``make_train_step`` step: the loss, and every updated param."""
    port, ref = runs
    got, want = port[mesh], ref[mesh]
    np.testing.assert_allclose(got[f"{tag}.step_loss"], want[f"{tag}.step_loss"], **TOL)
    g, w = _leaves(got, f"{tag}.param."), _leaves(want, f"{tag}.param.")
    assert sorted(g) == sorted(w) and g
    for k in w:
        np.testing.assert_allclose(g[k], w[k], **TOL, err_msg=k)


@pytest.mark.parametrize("tag", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_serving_matches_reference(runs, mesh, tag):
    """The prefill step's first tokens and the decode steps' tokens
    identical; the prefill's and each decode step's logits within 2e-4."""
    port, ref = runs
    got, want = port[mesh], ref[mesh]
    np.testing.assert_array_equal(got[f"{tag}.first"], want[f"{tag}.first"])
    np.testing.assert_array_equal(got[f"{tag}.tokens"], want[f"{tag}.tokens"])
    np.testing.assert_allclose(got[f"{tag}.prefill_logits"], want[f"{tag}.prefill_logits"], **TOL)
    for i in range(CONST["decode"]):
        key = f"{tag}.decode_logits.{i}"
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_every_case_runs_the_model_axis():
    """Each case takes the path it is here for on a model axis of 2: the
    heads of qwen3, gemma2, deepseek-v2 and zamba2 divide it, qwen2's 3 do
    not; mamba2's SSD heads divide it and its 129-token vocabulary does
    not, so its embedding is split over ``d``."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.launch.steps import make_ctx
    ctx = make_ctx(Mesh((1, 2), ("data", "model")))
    for tag in ("qwen3", "gemma2", "deepseek", "zamba2"):
        assert _cfg(tag).num_heads % 2 == 0, tag
    assert _cfg("heads3").num_heads % 2 == 1 and _cfg("heads3").qkv_bias
    m = _cfg("mamba2")
    assert m.ssm_heads % 2 == 0 and m.vocab_size % 2 == 1
    assert tuple(param_specs(m, ctx)["embed"]["embedding"]) == (None, "model")
