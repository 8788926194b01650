"""The store (``repro_torch.distributed.sharding.place`` and friends) on
gloo ranks, against the port's whole-tensor runs and the JAX reference, on
the meshes (2, 2), (1, 2) and (2, 1) ("data", "model").

* Serving: the ctx'd prefill and decode steps of the qwen3 and deepseek-v2
  smoke configs in f32 give the same logits and tokens, bit for bit, on
  the store as with whole tensors (the stored weights are gathered whole
  where a layer uses them, the sharded regions take their blocks as
  stored, the sequence-sharded decodes write the rank's cache chunk only).
* Bytes: on every rank, the storage the store holds (each storage once)
  equals ``local_bytes`` of it and the dry run's per-rank argument bytes
  for the same cell and mesh, for a train and a decode cell.
* Training: three steps of ``launch.train`` on the store match the
  reference's ``make_train_step`` on the same mesh (its directly built
  ``Mesh`` with forced host devices) within f32 2e-4, params and moments
  (``global_norm`` sums partial squares over the ranks, so not bit for
  bit), from the port's initial weights.
* Checkpoints: the (1, 2) and (2, 1) runs' checkpoints, saved from two
  ranks, restore into one rank of the port and into the reference.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.context import Mesh, P
from repro_torch.distributed.sharding import place
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as TC
from repro_torch.training.optimizer import AdamWConfig, init_adamw

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((2, 2), (1, 2), (2, 1))
SERVE_ARCHS = ("qwen3-30b-a3b", "deepseek-v2-236b")
TRAIN = dict(arch="qwen3-30b-a3b", steps=3, batch=4, seq=16)
TOL = dict(rtol=2e-4, atol=2e-4)

_PORT = """
    import json, os, sys, tempfile
    import torch, torch.distributed as dist, torch.multiprocessing as mp
    MESHES, SERVE_ARCHS, TRAIN = {meshes}, {serve_archs}, {train}

    def serve(cfg, ctx, params, stored):
        from repro_torch.distributed.sharding import gather, input_shardings, place
        from repro_torch.launch import steps as S
        from repro_torch.models.config import ShapeCell
        b, p, n = 4, 8, 4
        toks = torch.randint(0, cfg.vocab_size, (b, p), generator=torch.Generator().manual_seed(1))
        pl = S.placements_input(cfg, "cpu")
        pre = S.make_prefill_step(cfg, ctx, ShapeCell("p", p, b, "prefill"))[0]
        batch = {{"tokens": toks, "placements": pl}}
        first, _ = pre(params, batch)
        # a cache with room for n more positions, filled by the model's prefill
        from repro_torch.distributed.context import shard_ctx
        from repro_torch.distributed.sharding import cache_specs, stored_zeros
        from repro_torch.models import model as M
        if stored:
            cache = stored_zeros(M.cache_shapes(cfg, b, p + n), cache_specs(cfg, ctx, b, p + n),
                                 ctx.mesh, cfg.adtype, "cpu")
        else:
            cache = M.init_cache(cfg, b, p + n, device="cpu")
        with torch.no_grad(), shard_ctx(ctx):
            logits, _, _ = M.prefill(params, cfg, toks, cache, placements=pl)
        dcell = ShapeCell("d", p + n, b, "decode")
        dec = S.make_decode_step(cfg, ctx, dcell)[0]
        nxt, out = gather(first), [gather(first)]
        for i in range(n):
            d = {{"tokens": nxt[:, None], "placements": pl,
                 "cache_pos": torch.full((b,), p + i, dtype=torch.int32)}}
            if stored:
                d = place(d, input_shardings(cfg, ctx, dcell, d), ctx.mesh)
            nxt, cache = dec(params, cache, d)
            nxt = gather(nxt)
            out.append(nxt)
        return logits, torch.stack(out)

    def storage_bytes(tree):
        from repro_torch.distributed.sharding import local_of
        from repro_torch.tree import leaves
        seen = {{}}
        for t in map(local_of, leaves(tree)):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())

    def store_bytes(cfg, ctx, rank, shape):
        from repro_torch.configs import input_specs
        from repro_torch.distributed.context import Mesh
        from repro_torch.distributed.sharding import (cache_specs, local_bytes, param_specs,
                                                      place, stored_zeros)
        from repro_torch.launch import dryrun as D, steps as S
        from repro_torch.models import model as M
        from repro_torch.models.config import ShapeCell
        from repro_torch.training.optimizer import AdamWConfig, init_adamw
        out = {{}}
        for cell in (ShapeCell("t", 16, 4, "train"), ShapeCell("d", 32, 4, "decode")):
            specs = input_specs(cfg, cell)
            batch, bshard = S.train_inputs(cfg, ctx, cell, {{
                k: torch.zeros(v.shape, dtype=v.dtype) for k, v in specs.items()}})
            params = place(M.init_params(cfg, device="cpu"), param_specs(cfg, ctx), ctx.mesh)
            if cell.kind == "train":
                args = [params, init_adamw(params, AdamWConfig()), place(batch, bshard, ctx.mesh)]
            else:
                cache = stored_zeros(M.cache_shapes(cfg, 4, 32), cache_specs(cfg, ctx, 4, 32),
                                     ctx.mesh, cfg.adtype, "cpu")
                args = [params, cache, place(batch, bshard, ctx.mesh)]
            dctx = S.make_ctx(Mesh(shape, ("data", "model"), rank=rank))
            want, _ = D.argument_bytes(D.build_cell(cfg, cell, dctx)[1])
            out[cell.kind] = [storage_bytes(args), local_bytes(args), want]
        return out

    def work(rank, world, store, shape, result, ckpt):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{{store}}", rank=rank,
                                world_size=world)
        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed.sharding import param_specs, place
        from repro_torch.launch import steps as S
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.train import train
        from repro_torch.models import model as M
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        ctx = S.make_ctx(mesh)
        res = {{}}
        for arch in SERVE_ARCHS:
            cfg = get_smoke_config(arch).replace(dtype="float32")
            lw, tw = serve(cfg, ctx, M.init_params(cfg, seed=0, device="cpu"), False)
            sp = place(M.init_params(cfg, seed=0, device="cpu"), param_specs(cfg, ctx), mesh)
            ls, ts = serve(cfg, ctx, sp, True)
            res[arch] = [bool(torch.equal(lw, ls)), bool(torch.equal(tw, ts)),
                         float((lw - ls).abs().max())]
        res["bytes"] = store_bytes(get_smoke_config(TRAIN["arch"]), ctx, rank, shape)
        kw = {{k: v for k, v in TRAIN.items() if k != "arch"}}
        res["losses"] = train(TRAIN["arch"], mesh_shape=shape, device="cpu", log_every=1000,
                              ckpt_dir=ckpt, **kw)
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            with open(result, "w") as f:
                json.dump(every, f)
        dist.barrier()
        dist.destroy_process_group()

    for shape in MESHES:
        world = shape[0] * shape[1]
        store = os.path.join(tempfile.mkdtemp(), "store")
        tag = f"{{shape[0]}}x{{shape[1]}}"
        mp.start_processes(work, args=(world, store, shape, f"{{sys.argv[1]}}/{{tag}}.json",
                                       f"{{sys.argv[1]}}/ckpt_{{tag}}"),
                           nprocs=world, start_method="fork")
    print("PORT_OK")
"""

# The reference's train loop (its own train() is red on this jax), per mesh,
# from the port's initial weights; the final state is written as .npz.
_REFERENCE = """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_smoke_config
    from repro.core.placement import perm_to_slot_map, static_placement
    from repro.launch import steps as S
    from repro.models.config import ShapeCell
    from repro.training.data import DataConfig, TokenStream
    from repro.training.optimizer import AdamWConfig, init_adamw
    MESHES, TRAIN = {meshes}, {train}
    with open(sys.argv[2], "rb") as f:
        init = pickle.load(f)
    cfg = get_smoke_config(TRAIN["arch"])
    opt = AdamWConfig(moment_dtype="float32", warmup_steps=10,
                      decay_steps=max(TRAIN["steps"], 2))
    data = TokenStream(DataConfig(vocab_size=cfg.vocab_size, global_batch=TRAIN["batch"],
                                  seq_len=TRAIN["seq"], seed=0))
    for shape in MESHES:
        n = shape[0] * shape[1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
        ctx = S.make_ctx(mesh)
        inv = perm_to_slot_map(static_placement(cfg.num_experts,
                                                min(ctx.tp, cfg.num_experts)))
        with mesh:
            fn, _, _ = S.make_train_step(
                cfg, ctx, ShapeCell("train_custom", TRAIN["seq"], TRAIN["batch"], "train"),
                opt, remat=False)
            jfn = jax.jit(fn)
            params = jax.tree.map(jnp.asarray, init)
            state = init_adamw(params, opt)
            losses = []
            for step in range(TRAIN["steps"]):
                b = {{k: jnp.asarray(v) for k, v in data.batch_at(step).items()}}
                b["placements"] = jnp.broadcast_to(
                    jnp.asarray(inv), (cfg.num_moe_layers(), cfg.num_experts))
                params, state, m = jfn(params, state, b)
                losses.append(float(m["loss"]))
        flat, _ = jax.tree_util.tree_flatten_with_path((params, state))
        out = {{jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}}
        out["losses"] = np.asarray(losses)
        np.savez(f"{{sys.argv[1]}}/ref_{{shape[0]}}x{{shape[1]}}.npz", **out)
    print("REFERENCE_OK")
"""


def _script(body: str) -> str:
    return textwrap.dedent(body.format(meshes=repr(MESHES), serve_archs=repr(SERVE_ARCHS),
                                       train=repr(TRAIN)))


def _run(args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(ROOT)), "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    init = TM.init_params(get_smoke_config(TRAIN["arch"]), seed=0, device="cpu")
    with open(d / "init.pkl", "wb") as f:
        pickle.dump(_numpy_tree(init), f)
    (d / "port.py").write_text(_script(_PORT))
    (d / "reference.py").write_text(_script(_REFERENCE))
    procs = {"PORT": _run([str(d / "port.py"), str(d)]),
             "REFERENCE": _run([str(d / "reference.py"), str(d), str(d / "init.pkl")])}
    for tag, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0 and f"{tag}_OK" in stdout, \
            f"{tag}: rc {proc.returncode}\nstdout:\n{stdout[-2000:]}\nstderr:\n{stderr[-4000:]}"
    port = {_tag(s): json.loads((d / f"{_tag(s)}.json").read_text()) for s in MESHES}
    ref = {_tag(s): dict(np.load(d / f"ref_{_tag(s)}.npz")) for s in MESHES}
    return d, port, ref


@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_store_serving_is_bit_identical_to_whole_tensors(runs, shape, arch):
    _, port, _ = runs
    for rank, res in enumerate(port[_tag(shape)]):
        same_logits, same_tokens, err = res[arch]
        assert same_logits and same_tokens, (rank, err)


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_store_bytes_equal_local_bytes_and_dry_run(runs, shape, kind):
    _, port, _ = runs
    got = [res["bytes"][kind] for res in port[_tag(shape)]]
    assert len(got) == shape[0] * shape[1]
    for storage, local, dry in got:
        assert storage == local == dry
    assert got[0][0] == got[-1][0]          # even blocks: every rank holds as much


def _restored(path: Path, like):
    return TC.restore_checkpoint(path, like)[1]


def _like_state():
    cfg = get_smoke_config(TRAIN["arch"])
    params = TM.init_params(cfg, seed=0, device="cpu")
    return params, init_adamw(params, AdamWConfig(moment_dtype="float32"))


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_store_train_matches_reference(runs, shape):
    """Three train steps on the store: losses and the final params and
    moments (from the checkpoint the ranks wrote) within 2e-4 of the
    reference's on the same mesh."""
    from repro_torch.tree import flatten_with_paths
    d, port, ref = runs
    r = ref[_tag(shape)]
    for res in port[_tag(shape)]:
        np.testing.assert_allclose(res["losses"], r["losses"], rtol=2e-4, atol=0)
    state = _restored(d / f"ckpt_{_tag(shape)}", _like_state())
    flat = flatten_with_paths(state)
    assert sorted(p for p, _ in flat) == sorted(k for k in r if k != "losses")
    for path, leaf in flat:
        np.testing.assert_allclose(leaf.numpy(), r[path], **TOL, err_msg=path)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=_tag)
def test_checkpoint_from_two_ranks_restores_in_one_rank_and_reference(runs, shape):
    """The two-rank run's checkpoint restores whole into one rank of the
    port (and again onto a (1, 2) store as rank 1's blocks) and into the
    reference, with the same leaves."""
    import jax
    from repro.training import checkpoint as JC
    from repro_torch.tree import flatten_with_paths
    d, _, _ = runs
    path = d / f"ckpt_{_tag(shape)}"
    whole = _restored(path, _like_state())
    params, opt = _like_state()
    jlike = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), _numpy_tree(
        {"p": params, "m": opt.m, "v": opt.v}))
    from repro.training.optimizer import AdamWState
    jstep, jstate = JC.restore_checkpoint(path, (jlike["p"], AdamWState(
        step=np.zeros((), np.int32), m=jlike["m"], v=jlike["v"])))
    assert jstep == TRAIN["steps"]
    jflat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    jleaves = {jax.tree_util.keystr(p): np.asarray(x) for p, x in jflat}
    for p, leaf in flatten_with_paths(whole):
        np.testing.assert_array_equal(leaf.numpy(), jleaves[p], err_msg=p)
    # onto a store, as rank 1 of (1, 2): each stored leaf keeps its block
    from repro_torch.distributed.context import Stored
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.launch.steps import make_ctx
    mesh = Mesh((1, 2), ("data", "model"), rank=1)
    pspec = param_specs(get_smoke_config(TRAIN["arch"]), make_ctx(mesh))
    sp = place(params, pspec, mesh)
    got = _restored(path, (sp, init_adamw(sp, AdamWConfig(moment_dtype="float32"))))
    n_stored = 0
    for (p, leaf), (_, want) in zip(flatten_with_paths(got), flatten_with_paths(whole)):
        if isinstance(leaf, Stored):
            n_stored += 1
            block = want
            for dim, start, size in leaf.block():
                block = block.narrow(dim, start, size)
            assert torch.equal(leaf.local, block), p
        else:
            assert torch.equal(leaf, want), p
    assert n_stored > 0


def test_place_refuses_an_uneven_block():
    """A spec that splits a dimension the axis does not divide is refused
    (the spec trees never do: they split only where ``divides``)."""
    mesh = Mesh((1, 2), ("data", "model"), rank=0)
    with pytest.raises(ValueError, match="does not split"):
        place({"w": torch.zeros(3, 4)}, {"w": P("model", None)}, mesh)
    out = place({"w": torch.arange(8.0).reshape(4, 2)}, {"w": P("model", None)}, mesh)
    assert out["w"].local.tolist() == [[0.0, 1.0], [2.0, 3.0]]
    assert out["w"].shape == (4, 2)
