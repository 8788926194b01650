"""The port's multi-rank compute against the JAX reference on the CPU.

The reference runs in a subprocess with 8 forced host devices (jax locks
the device count at its first use, as in tests/test_perf_opts.py), on
directly built ``jax.sharding.Mesh``es; the port runs as gloo ranks, one
process each, forked in their own subprocess.  Both read the same inputs
(the reference's weights and seeded numpy data, written to an ``.npz``) and
write their results to ``.npz`` files that the tests compare:

* ``moe_apply_sharded`` on the (2, 4) and (1, 4) ("data", "model") meshes,
  every ``ep_mode`` ("gather", "tokengather", "a2a", "auto"), with the
  identity placement (S = E = 8) and a replicated one (S = E + R = 12):
  output within f32 2e-4 of the reference's on the same mesh and of the
  port's single-rank ``moe_apply``, expert ids and counts exactly equal;
  and with a capacity that drops tokens, against the reference on the
  same mesh (the a2a body's per-chunk capacity differs from one rank's);
* the sequence-sharded GQA decode (softcap, with and without the window)
  and MLA decode (absorbed and naive) on (2, 4), output and cache;
* ``compressed_psum`` over a "pod" axis of 2: plain, int8, int8 after
  top-k with error feedback;
* ``launch.train`` on meshes (1, 2) and (2, 1), from the port's initial
  weights, against the reference's train loop on the same meshes (its
  ``make_train_step`` jitted under a directly built mesh, as
  tests/test_torch_training.py runs it): every step's loss within 2e-4.
  On (1, 2) the losses also equal the port's own (1, 1) run; on (2, 1)
  each data shard routes its tokens under its own capacity, in both
  packages, so the run differs from (1, 1).
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import moe as JMoE
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
MODES = ("gather", "tokengather", "a2a", "auto")
MESHES = {"2x4": (2, 4), "1x4": (1, 4)}
PLACEMENTS = ("identity", "replicated")
SLOT_MAP = np.array([0, 1, 2, 3, 4, 5, 6, 7, 3, 0, 5, 3], np.int32)   # S = 12

MOE_KW = dict(name="m", family="moe", num_layers=2, d_model=32, num_heads=4,
              num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64, num_experts=8,
              moe_top_k=2, moe_d_ff=16, dtype="float32")
GQA_KW = dict(name="g", family="dense", num_layers=1, d_model=32, num_heads=4,
              num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64, sliding_window=6,
              local_global_period=2, attn_logit_softcap=50.0, dtype="float32")
MLA_KW = dict(name="d", family="moe", num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=128, attention_type="mla",
              q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
              v_head_dim=16, num_experts=8, moe_top_k=2, moe_d_ff=32, dtype="float32")
B, SEQ, S_CACHE = 8, 16, 16
CAPACITY = {"free": 8.0, "drop": 1.0}
TRAIN = dict(arch="qwen3-30b-a3b", steps=4, batch=2, seq=16)
TRAIN_MESHES = ((1, 2), (2, 1))

_COMMON = """
    import sys
    import numpy as np
    CONFIGS, TRAIN, TRAIN_MESHES = {configs}, {train}, {train_meshes}
    SLOT_MAP = np.array({slot_map}, np.int32)
    MODES, MESHES, CAPACITY = {modes}, {meshes}, {capacity}
    inp = dict(np.load(sys.argv[1]))
    out = {{}}

    def tree(prefix):
        return {{k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}}
"""

# The reference: every case on its meshes, one jitted call each.
_REFERENCE = _COMMON + """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.distributed.context import ShardCtx, shard_ctx, shard_map_compat
    from repro.models import attention as A
    from repro.models.config import ModelConfig
    from repro.models.moe import ExpertPlacement
    from repro.models.moe_sharded import moe_apply_sharded
    from repro.training import compression as C

    def mesh_of(shape, names):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)

    x = jnp.asarray(inp["x"])
    for mname, shape in MESHES.items():
        mesh = mesh_of(shape, ("data", "model"))
        for cname, cf in CAPACITY.items():
            cfg = ModelConfig(**CONFIGS["moe"], capacity_factor=cf)
            for pname in ("identity", "replicated"):
                p = tree(f"moe.{{pname}}.")
                inv = jnp.arange(8, dtype=jnp.int32) if pname == "identity" \\
                    else jnp.asarray(SLOT_MAP)
                for mode in MODES:
                    ctx = ShardCtx(mesh=mesh, batch_axes=("data",), ep_mode=mode,
                                   seq_parallel=False)
                    with mesh, shard_ctx(ctx):
                        y, aux = jax.jit(lambda p, xx, inv: moe_apply_sharded(
                            p, cfg, xx, ExpertPlacement.from_slot_map(inv, 8), ctx,
                            True))(p, x, inv)
                    key = f"moe.{{mname}}.{{cname}}.{{pname}}.{{mode}}"
                    out[key + ".y"] = np.asarray(y)
                    out[key + ".ids"] = np.asarray(aux["expert_ids"])
                    out[key + ".counts"] = np.asarray(aux["expert_counts"])

    mesh = mesh_of((2, 4), ("data", "model"))
    ctx = ShardCtx(mesh=mesh, batch_axes=("data",), seq_parallel=False)
    gcfg = ModelConfig(**CONFIGS["gqa"])
    for local in (True, False):
        with mesh, shard_ctx(ctx):
            o, c = jax.jit(lambda p, xx, c, pos: A.gqa_decode(p, gcfg, xx, c, pos, local))(
                tree("gqa.p."), inp["gqa.x"], tree("gqa.cache."), inp["gqa.pos"])
        out[f"gqa.{{local}}.out"] = np.asarray(o)
        out[f"gqa.{{local}}.k"], out[f"gqa.{{local}}.v"] = np.asarray(c["k"]), np.asarray(c["v"])
    mcfg = ModelConfig(**CONFIGS["mla"])
    for absorb in (True, False):
        with mesh, shard_ctx(ctx):
            o, c = jax.jit(lambda p, xx, c, pos: A.mla_decode(p, mcfg, xx, c, pos, absorb))(
                tree("mla.p."), inp["mla.x"], tree("mla.cache."), inp["mla.pos"])
        out[f"mla.{{absorb}}.out"] = np.asarray(o)
        out[f"mla.{{absorb}}.ckv"] = np.asarray(c["ckv"])
        out[f"mla.{{absorb}}.krope"] = np.asarray(c["krope"])

    pods = mesh_of((2,), ("pod",))
    grads = tree("psum.")
    for name, kw in (("plain", {{}}), ("int8", dict(int8=True)),
                     ("topk_int8", dict(int8=True, frac=0.2))):
        def body(g):
            g = jax.tree.map(lambda a: a[0], g)
            st = C.topk_init(g) if "frac" in kw else None
            red, st = C.compressed_psum(g, "pod", state=st, **kw)
            res = st.residual if st is not None else g
            return red, jax.tree.map(lambda a: a[None], res)
        with pods:
            red, res = jax.jit(shard_map_compat(body, mesh=pods, in_specs=(P("pod"),),
                                                out_specs=(P(), P("pod"))))(grads)
        for k in red:
            out[f"psum.{{name}}.{{k}}"] = np.asarray(red[k])
            out[f"psum.{{name}}.res.{{k}}"] = np.asarray(res[k])

    # the reference's train() loop (its own is red on this jax), per mesh
    import pickle
    from repro.configs import get_smoke_config
    from repro.core.placement import perm_to_slot_map, static_placement
    from repro.launch import steps as S
    from repro.models.config import ShapeCell
    from repro.training.data import DataConfig, TokenStream
    from repro.training.optimizer import AdamWConfig, init_adamw
    with open(sys.argv[3], "rb") as f:
        init = pickle.load(f)
    tcfg = get_smoke_config(TRAIN["arch"])
    opt = AdamWConfig(moment_dtype="float32", warmup_steps=10,
                      decay_steps=max(TRAIN["steps"], 2))
    data = TokenStream(DataConfig(vocab_size=tcfg.vocab_size, global_batch=TRAIN["batch"],
                                  seq_len=TRAIN["seq"], seed=0))
    for shape in TRAIN_MESHES:
        mesh = mesh_of(shape, ("data", "model"))
        ctx = S.make_ctx(mesh)
        inv = perm_to_slot_map(static_placement(tcfg.num_experts,
                                                min(ctx.tp, tcfg.num_experts)))
        with mesh:
            fn, _, _ = S.make_train_step(
                tcfg, ctx, ShapeCell("train_custom", TRAIN["seq"], TRAIN["batch"], "train"),
                opt, remat=False)
            jfn = jax.jit(fn)
            params = jax.tree.map(jnp.asarray, init)
            state = init_adamw(params, opt)
            losses = []
            for step in range(TRAIN["steps"]):
                b = {{k: jnp.asarray(v) for k, v in data.batch_at(step).items()}}
                b["placements"] = jnp.broadcast_to(
                    jnp.asarray(inv), (tcfg.num_moe_layers(), tcfg.num_experts))
                params, state, m = jfn(params, state, b)
                losses.append(float(m["loss"]))
        out[f"train.{{shape}}"] = np.asarray(losses)
    np.savez(sys.argv[2], **out)
    print("REFERENCE_OK")
"""

# The port: gloo ranks forked from this process, rank 0 writes the results.
_PORT = _COMMON + """
    import os, tempfile
    import torch, torch.distributed as dist, torch.multiprocessing as mp

    def work(rank, world, store, shape, result):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{{store}}", rank=rank,
                                world_size=world)
        from repro_torch.distributed.context import Mesh, ShardCtx, shard_ctx
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import attention as A
        from repro_torch.models.config import ModelConfig
        from repro_torch.models.convert import params_from_numpy
        from repro_torch.models.moe import ExpertPlacement
        from repro_torch.models.moe_sharded import moe_apply_sharded
        from repro_torch.training import compression as C

        def t(a):
            return params_from_numpy(a, "cpu")

        mname = [k for k, v in MESHES.items() if tuple(v) == tuple(shape)][0]
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        x = t(inp["x"])
        for cname, cf in CAPACITY.items():
            cfg = ModelConfig(**CONFIGS["moe"], capacity_factor=cf)
            for pname in ("identity", "replicated"):
                p = t(tree(f"moe.{{pname}}."))
                inv = np.arange(8, dtype=np.int32) if pname == "identity" else SLOT_MAP
                for mode in MODES:
                    ctx = ShardCtx(mesh=mesh, batch_axes=("data",), ep_mode=mode,
                                   seq_parallel=False)
                    with torch.no_grad():
                        y, aux = moe_apply_sharded(
                            p, cfg, x, ExpertPlacement.from_slot_map(inv, 8), ctx, True)
                    key = f"moe.{{mname}}.{{cname}}.{{pname}}.{{mode}}"
                    out[key + ".y"] = y.numpy()
                    out[key + ".ids"] = aux["expert_ids"].numpy()
                    out[key + ".counts"] = aux["expert_counts"].numpy()

        if tuple(shape) == (2, 4):
            ctx = ShardCtx(mesh=mesh, batch_axes=("data",), seq_parallel=False)
            gcfg = ModelConfig(**CONFIGS["gqa"])
            for local in (True, False):
                cache = t(tree("gqa.cache."))
                with torch.no_grad(), shard_ctx(ctx):
                    o, c = A.gqa_decode(t(tree("gqa.p.")), gcfg, t(inp["gqa.x"]), cache,
                                        t(inp["gqa.pos"]), local)
                out[f"gqa.{{local}}.out"] = o.numpy()
                out[f"gqa.{{local}}.k"], out[f"gqa.{{local}}.v"] = c["k"].numpy(), c["v"].numpy()
            mcfg = ModelConfig(**CONFIGS["mla"])
            for absorb in (True, False):
                cache = t(tree("mla.cache."))
                with torch.no_grad(), shard_ctx(ctx):
                    o, c = A.mla_decode(t(tree("mla.p.")), mcfg, t(inp["mla.x"]), cache,
                                        t(inp["mla.pos"]), absorb)
                out[f"mla.{{absorb}}.out"] = o.numpy()
                out[f"mla.{{absorb}}.ckv"] = c["ckv"].numpy()
                out[f"mla.{{absorb}}.krope"] = c["krope"].numpy()

            # planted faults, each outside the reference on these ranks: the
            # decode without its pmax (each rank keeps its own running max),
            # and the MoE body without its rank offset (every rank takes rank
            # 0's slots; the body asks axis_index("model") by name, the
            # region's slicing by a tuple of names, which stays right)
            from unittest import mock
            with mock.patch.object(Mesh, "pmax", lambda self, x, axes: x.detach().clone()):
                with torch.no_grad(), shard_ctx(ctx):
                    o, _ = A.gqa_decode(t(tree("gqa.p.")), gcfg, t(inp["gqa.x"]),
                                        t(tree("gqa.cache.")), t(inp["gqa.pos"]), True)
                out["fault.no_pmax"] = o.numpy()
            real_index = Mesh.axis_index
            rank0 = lambda self, axes: 0 if axes == "model" else real_index(self, axes)
            with mock.patch.object(Mesh, "axis_index", rank0), torch.no_grad():
                y, _ = moe_apply_sharded(t(tree("moe.identity.")),
                                         ModelConfig(**CONFIGS["moe"], capacity_factor=8.0),
                                         x, None, ShardCtx(mesh=mesh, batch_axes=("data",),
                                                           seq_parallel=False))
                out["fault.rank0"] = y.numpy()

            pods = Mesh.over_process_group((2, 4), ("pod", "model"))
            pod = pods.axis_index("pod")
            for name, kw in (("plain", {{}}), ("int8", dict(int8=True)),
                             ("topk_int8", dict(int8=True, frac=0.2))):
                g = {{k: t(v[pod]) for k, v in tree("psum.").items()}}
                st = C.topk_init(g) if "frac" in kw else None
                red, st = C.compressed_psum(g, "pod", state=st, mesh=pods, **kw)
                res = st.residual if st is not None else g
                res = {{k: pods.all_gather(v[None], "pod", dim=0) for k, v in res.items()}}
                for k in red:
                    out[f"psum.{{name}}.{{k}}"] = red[k].numpy()
                    out[f"psum.{{name}}.res.{{k}}"] = res[k].numpy()
        if rank == 0:
            np.savez(result, **out)
        dist.barrier()
        dist.destroy_process_group()

    for shape in MESHES.values():
        world = int(np.prod(shape))
        store = os.path.join(tempfile.mkdtemp(), "store")
        result = sys.argv[2].replace(".npz", f".{{shape[0]}}x{{shape[1]}}.npz")
        mp.start_processes(work, args=(world, store, shape, result), nprocs=world,
                           start_method="fork")
    print("PORT_OK")
"""

# launch.train on one and on two gloo ranks; rank 0 writes the losses.
_TRAIN = """
    import json, os, sys, tempfile
    import torch, torch.distributed as dist, torch.multiprocessing as mp
    KW, TRAIN_MESHES = {train}, {train_meshes}

    def work(rank, world, store, shapes, result):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{{store}}", rank=rank,
                                world_size=world)
        from repro_torch.launch.train import train
        arch = KW["arch"]
        kw = {{k: v for k, v in KW.items() if k != "arch"}}
        losses = {{str(s): train(arch, mesh_shape=s, device="cpu", log_every=1000, **kw)
                  for s in shapes}}
        if rank == 0:
            with open(result, "w") as f:
                json.dump(losses, f)
        dist.barrier()
        dist.destroy_process_group()

    for world, shapes in ((1, [(1, 1)]), (2, list(TRAIN_MESHES))):
        store = os.path.join(tempfile.mkdtemp(), "store")
        mp.start_processes(work, args=(world, store, shapes, f"{{sys.argv[1]}}.{{world}}.json"),
                           nprocs=world, start_method="fork")
    print("TRAIN_OK")
"""


def _script(body: str) -> str:
    return textwrap.dedent(body.format(
        configs=repr({"moe": MOE_KW, "gqa": GQA_KW, "mla": MLA_KW}),
        slot_map=SLOT_MAP.tolist(), modes=repr(MODES), meshes=repr(MESHES),
        capacity=repr(CAPACITY), train=repr(TRAIN), train_meshes=repr(TRAIN_MESHES)))


def _inputs() -> dict:
    """The reference's weights (jax.random.key(0)) and seeded numpy data."""
    rng = np.random.default_rng(0)
    moe = jax.tree.map(np.asarray, JMoE.init_moe(
        jax.random.key(0), JaxModelConfig(**MOE_KW, capacity_factor=1.0)))
    # tokens pushed towards expert 0, so that capacity 1 drops in every body
    toward = moe["w_router"][:, 0] / np.linalg.norm(moe["w_router"][:, 0])
    inp = {"x": (rng.normal(size=(B, SEQ, MOE_KW["d_model"])) + 3.0 * toward
                 ).astype(np.float32)}
    for pname in PLACEMENTS:
        slots = np.arange(8) if pname == "identity" else SLOT_MAP
        for k, v in moe.items():
            inp[f"moe.{pname}.{k}"] = v[slots] if k != "w_router" else v
    gqa = jax.tree.map(np.asarray, JA.init_gqa(jax.random.key(1), JaxModelConfig(**GQA_KW)))
    inp.update({f"gqa.p.{k}": v for k, v in gqa.items()})
    inp["gqa.x"] = rng.normal(size=(B, 1, GQA_KW["d_model"])).astype(np.float32)
    for k in ("k", "v"):
        inp[f"gqa.cache.{k}"] = rng.normal(size=(B, S_CACHE, 2, 8)).astype(np.float32)
    # write positions on every rank's chunk, the chunk edges included
    inp["gqa.pos"] = np.array([0, 3, 4, 7, 8, 11, 12, 15], np.int32)
    mla = jax.tree.map(np.asarray, JA.init_mla(jax.random.key(2), JaxModelConfig(**MLA_KW)))
    inp.update({f"mla.p.{k}": v for k, v in mla.items()})
    inp["mla.x"] = rng.normal(size=(B, 1, MLA_KW["d_model"])).astype(np.float32)
    inp["mla.cache.ckv"] = rng.normal(size=(B, S_CACHE, 16)).astype(np.float32)
    inp["mla.cache.krope"] = rng.normal(size=(B, S_CACHE, 8)).astype(np.float32)
    inp["mla.pos"] = np.array([15, 12, 11, 8, 7, 4, 3, 0], np.int32)
    inp["psum.a"] = rng.normal(size=(2, 5, 7)).astype(np.float32)
    inp["psum.b"] = (rng.normal(size=(2, 33)) * 10).astype(np.float32)
    return inp


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _run(args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(ROOT)), "OMP_NUM_THREADS": "1"}
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))


def _wait(proc, tag: str) -> None:
    stdout, stderr = proc.communicate(timeout=240)
    assert proc.returncode == 0 and f"{tag}_OK" in stdout, \
        f"{tag}: rc {proc.returncode}\nstdout:\n{stdout[-2000:]}\nstderr:\n{stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    init = TM.init_params(get_smoke_config(TRAIN["arch"]), seed=0, device="cpu")
    with open(d / "init.pkl", "wb") as f:
        pickle.dump(_numpy_tree(init), f)
    for name, body in (("reference", _REFERENCE), ("port", _PORT), ("train", _TRAIN)):
        (d / f"{name}.py").write_text(_script(body))
    procs = [(_run([str(d / "reference.py"), str(d / "inputs.npz"), str(d / "ref.npz"),
                    str(d / "init.pkl")]), "REFERENCE"),
             (_run([str(d / "port.py"), str(d / "inputs.npz"), str(d / "port.npz")]), "PORT"),
             (_run([str(d / "train.py"), str(d / "train")]), "TRAIN")]
    for proc, tag in procs:
        _wait(proc, tag)
    port = {}
    for shape in MESHES.values():
        port.update(dict(np.load(d / f"port.{shape[0]}x{shape[1]}.npz")))
    losses = {}
    for world in (1, 2):
        losses.update(json.loads((d / f"train.{world}.json").read_text()))
    return inp, dict(np.load(d / "ref.npz")), port, losses


def _single_rank_moe(inp, pname):
    """The port's single-rank moe_apply (gather dispatch, dropless)."""
    cfg = ModelConfig(**MOE_KW, capacity_factor=CAPACITY["free"])
    p = params_from_numpy({k: inp[f"moe.{pname}.{k}"] for k in
                           ("w_router", "w_gate", "w_up", "w_down")}, "cpu")
    inv = np.arange(8, dtype=np.int32) if pname == "identity" else SLOT_MAP
    with torch.no_grad():
        y, aux = TMoE.moe_apply(p, cfg, torch.from_numpy(inp["x"]),
                                TMoE.ExpertPlacement.from_slot_map(inv, 8), "gather", True)
    return y.numpy(), aux


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pname", PLACEMENTS)
@pytest.mark.parametrize("mname", list(MESHES))
def test_moe_sharded_matches_reference_and_single_rank(results, mname, pname, mode):
    inp, ref, port, _ = results
    key = f"moe.{mname}.free.{pname}.{mode}"
    np.testing.assert_allclose(port[key + ".y"], ref[key + ".y"], **TOL)
    np.testing.assert_array_equal(port[key + ".ids"], ref[key + ".ids"])
    np.testing.assert_array_equal(port[key + ".counts"], ref[key + ".counts"])
    y1, aux1 = _single_rank_moe(inp, pname)
    np.testing.assert_allclose(port[key + ".y"], y1, **TOL)
    np.testing.assert_array_equal(port[key + ".ids"], aux1["expert_ids"].numpy())
    np.testing.assert_array_equal(port[key + ".counts"], aux1["expert_counts"].numpy())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pname", PLACEMENTS)
@pytest.mark.parametrize("mname", list(MESHES))
def test_moe_sharded_capacity_drops_match_reference(results, mname, pname, mode):
    """Capacity factor 1: tokens drop, each body by its own capacity rule
    (the a2a body's per-chunk capacity, the token gather's gathered token
    count); the port's outputs equal the reference's on the same mesh."""
    _, ref, port, _ = results
    key = f"moe.{mname}.drop.{pname}.{mode}"
    np.testing.assert_allclose(port[key + ".y"], ref[key + ".y"], **TOL)
    np.testing.assert_array_equal(port[key + ".ids"], ref[key + ".ids"])
    np.testing.assert_array_equal(port[key + ".counts"], ref[key + ".counts"])


def test_moe_sharded_drops_tokens_at_capacity_one(results):
    """The capacity-1 cases do drop: their outputs differ from the dropless
    ones, so the cases above test the capacity rules."""
    _, _, port, _ = results
    for mname in MESHES:
        for mode in MODES:
            key = f"moe.{mname}.{{}}.identity.{mode}.y"
            assert not np.allclose(port[key.format("drop")], port[key.format("free")],
                                   **TOL), (mname, mode)


@pytest.mark.parametrize("local", [True, False])
def test_seqsharded_gqa_decode_matches_reference_and_single_rank(results, local):
    inp, ref, port, _ = results
    for k in ("out", "k", "v"):
        np.testing.assert_allclose(port[f"gqa.{local}.{k}"], ref[f"gqa.{local}.{k}"],
                                   **TOL, err_msg=k)
    cfg = ModelConfig(**GQA_KW)
    p = params_from_numpy({k[6:]: v for k, v in inp.items() if k.startswith("gqa.p.")}, "cpu")
    cache = {k: torch.from_numpy(inp[f"gqa.cache.{k}"].copy()) for k in ("k", "v")}
    with torch.no_grad():
        o, c = TA.gqa_decode(p, cfg, torch.from_numpy(inp["gqa.x"]), cache,
                             torch.from_numpy(inp["gqa.pos"]), local)
    np.testing.assert_allclose(port[f"gqa.{local}.out"], o.numpy(), **TOL)
    np.testing.assert_array_equal(port[f"gqa.{local}.k"], c["k"].numpy())
    np.testing.assert_array_equal(port[f"gqa.{local}.v"], c["v"].numpy())


@pytest.mark.parametrize("absorb", [True, False])
def test_seqsharded_mla_decode_matches_reference_and_single_rank(results, absorb):
    inp, ref, port, _ = results
    for k in ("out", "ckv", "krope"):
        np.testing.assert_allclose(port[f"mla.{absorb}.{k}"], ref[f"mla.{absorb}.{k}"],
                                   **TOL, err_msg=k)
    cfg = ModelConfig(**MLA_KW)
    p = params_from_numpy({k[6:]: v for k, v in inp.items() if k.startswith("mla.p.")}, "cpu")
    cache = {k: torch.from_numpy(inp[f"mla.cache.{k}"].copy()) for k in ("ckv", "krope")}
    with torch.no_grad():
        o, c = TA.mla_decode(p, cfg, torch.from_numpy(inp["mla.x"]), cache,
                             torch.from_numpy(inp["mla.pos"]), absorb)
    np.testing.assert_allclose(port[f"mla.{absorb}.out"], o.numpy(), **TOL)
    np.testing.assert_array_equal(port[f"mla.{absorb}.ckv"], c["ckv"].numpy())


@pytest.mark.parametrize("fault,want", [("no_pmax", "gqa.True.out"),
                                        ("rank0", "moe.2x4.free.identity.gather.y")])
def test_planted_faults_fall_outside_the_reference(results, fault, want):
    """On the gloo ranks the gates above reject a decode without its pmax
    and an expert-parallel MoE without its rank offset (on one rank both
    collectives are the identity, so only several ranks show them)."""
    _, ref, port, _ = results
    assert not np.allclose(port[f"fault.{fault}"], ref[want], **TOL)


@pytest.mark.parametrize("name", ["plain", "int8", "topk_int8"])
def test_compressed_psum_matches_reference(results, name):
    inp, ref, port, _ = results
    for k in ("a", "b"):
        np.testing.assert_allclose(port[f"psum.{name}.{k}"], ref[f"psum.{name}.{k}"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(port[f"psum.{name}.res.{k}"],
                                   ref[f"psum.{name}.res.{k}"], rtol=1e-6, atol=1e-6)
    if name == "plain":
        np.testing.assert_allclose(port["psum.plain.a"], inp["psum.a"].sum(0), rtol=1e-6)


@pytest.mark.parametrize("shape", TRAIN_MESHES)
def test_train_on_two_ranks_matches_reference(results, shape):
    _, ref, _, losses = results
    got = losses[str(shape)]
    assert len(got) == TRAIN["steps"]
    np.testing.assert_allclose(got, ref[f"train.{shape}"], rtol=2e-4, atol=0)
    if shape[0] == 1:
        np.testing.assert_allclose(got, losses["(1, 1)"], rtol=2e-4, atol=0)
