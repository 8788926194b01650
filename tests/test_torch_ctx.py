"""The port's step makers under a shard context at world size 1 (one gloo
rank) against the reference's under a directly built (1, 1) ``Mesh``
(``jax.make_mesh`` gives Explicit axes on this jax, whose sharding
constraints raise), for all eleven smoke configs in f32, with the
reference's weights bridged through ``models/convert.py``.

Under a context both packages take the sharded paths even on one rank:
every MoE layer the expert-parallel ``moe_apply_sharded``, every slot
decode the sequence-sharded one.  Checked: the prefill step's first tokens and cache; two
decode steps' tokens and cache; the spec trees the makers return (the
train step: tests/test_torch_ctx_train.py).  Then
gemma2 under ``paired_lg`` against the port without it (the same
numbers: the flag has no effect in the port) and against the reference's
paired stack, ``remat_policy``
"dots" and "full" against "none" (equal gradients), and ``mla_absorb``
reaching the absorbed decode through the context.

Tolerance: f32 2e-4 (tests/test_kernels.py); tokens exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import list_archs
from repro.distributed.context import ShardCtx as JaxShardCtx
from repro.distributed.context import shard_ctx as jax_shard_ctx
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.config import ShapeCell as JaxShapeCell
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.context import shard_ctx
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.config import ShapeCell
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import flatten_with_paths, unflatten

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = tuple(list_archs())
B, SEQ, N_DEC = 2, 8, 2
OPT = dict(lr=1e-3, warmup_steps=0, decay_steps=100, moment_dtype="float32")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind in "fV" else a


def _jax_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def _extras(cfg, total: int, seed: int = 1) -> dict:
    """Placements (identity), vision embeddings and frames as the model
    takes them, seeded."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_moe:
        out["placements"] = np.broadcast_to(np.arange(cfg.num_experts, dtype=np.int32),
                                            (cfg.num_moe_layers(), cfg.num_experts)).copy()
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(size=(B, cfg.vision_prefix_len, cfg.d_model)
                                          ).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.normal(size=(B, min(cfg.encoder_len, total), cfg.d_model)
                                   ).astype(np.float32)
    return out


def _leaves(tree, jax_side: bool) -> dict:
    if jax_side:
        return {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    return dict(flatten_with_paths(tree))


def _assert_trees(got, want, **tol):
    g, w = _leaves(got, False), _leaves(want, True)
    assert list(g) == list(w)
    for k in w:
        np.testing.assert_allclose(_np(g[k]), _np(w[k]), **(tol or TOL), err_msg=k)


def _spec_tuples(tree) -> list:
    from jax.sharding import PartitionSpec
    flat = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [tuple(s) for s in flat]


def _port_spec_tuples(tree) -> list:
    from repro_torch.distributed.context import P
    if isinstance(tree, P):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _port_spec_tuples(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _port_spec_tuples(v)]
    return []


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_under_ctx_match_reference(mesh, arch):
    """make_prefill_step and make_decode_step with a context: first tokens
    and cache of the prefill, then a prefill into a longer cache and
    N_DEC decode steps, tokens and cache; the returned spec trees."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    vis = cfg.vision_prefix_len if cfg.family == "vlm" else 0
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    extra = _extras(cfg, SEQ)
    pcell, dcell = ("p", SEQ, B, "prefill"), ("d", SEQ + N_DEC, B, "decode")
    jparams = JM.init_params(jax.random.key(0), jcfg)
    jmesh = _jax_mesh()
    jctx = JS.make_ctx(jmesh)
    fkw = {k: v for k, v in extra.items() if k in ("vision_embeds", "frames")}

    with jmesh:
        jpre, jcspecs, jpout = JS.make_prefill_step(jcfg, jctx, JaxShapeCell(*pcell))
        jdec, jdspecs, _ = JS.make_decode_step(jcfg, jctx, JaxShapeCell(*dcell))

        def ref(p, toks, extra):
            first, cache = jpre(p, {"tokens": toks, **extra})
            with jax_shard_ctx(jctx):
                _, big, _ = JM.prefill(p, jcfg, toks, JM.init_cache(jcfg, B, SEQ + vis + N_DEC),
                                       placements=extra.get("placements"),
                                       **{k: extra[k] for k in fkw})
            nxt, outs = first, []
            for i in range(N_DEC):
                pos = jnp.full((B,), SEQ + vis + i, jnp.int32)
                nxt, big = jdec(p, big, {"tokens": nxt[:, None], "cache_pos": pos,
                                         "placements": extra.get("placements")})
                outs.append(nxt)
            return first, cache, jnp.stack(outs), big

        jfirst, jcache, jtoks, jbig = jax.jit(ref)(
            jparams, jnp.asarray(toks), jax.tree.map(jnp.asarray, extra))

    ctx = TS.make_ctx(mesh)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    pre, cspecs, pout = TS.make_prefill_step(cfg, ctx, ShapeCell(*pcell))
    dec, dspecs, _ = TS.make_decode_step(cfg, ctx, ShapeCell(*dcell))
    first, cache = pre(params, {"tokens": torch.from_numpy(toks), **textra})
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    _assert_trees(cache, jcache)

    big = TM.init_cache(cfg, B, SEQ + vis + N_DEC, device="cpu")
    with torch.no_grad(), shard_ctx(ctx):
        TM.prefill(params, cfg, torch.from_numpy(toks), big,
                   placements=textra.get("placements"), **{k: textra[k] for k in fkw})
    nxt, outs = first, []
    for i in range(N_DEC):
        pos = torch.full((B,), SEQ + vis + i, dtype=torch.int32)
        nxt, big = dec(params, big, {"tokens": nxt[:, None], "cache_pos": pos,
                                     "placements": textra.get("placements")})
        outs.append(nxt)
    np.testing.assert_array_equal(torch.stack(outs).numpy(), np.asarray(jtoks))
    _assert_trees(big, jbig)

    assert _port_spec_tuples(cspecs) == _spec_tuples(jcspecs)
    assert _port_spec_tuples(dspecs) == _spec_tuples(jdspecs)
    assert tuple(pout[0]) == tuple(jpout[0])


# ----------------------------------------------------------------------------- gemma2 paired

def _gemma():
    return jax_smoke_config("gemma2-2b"), get_smoke_config("gemma2-2b")


def test_paired_local_global_matches_unpaired_and_reference(mesh):
    """Forward, prefill and one decode step: ``paired_lg`` changes nothing
    in the port (its loop already runs each layer on its own static flag),
    and the port under it matches the reference's paired stack within
    2e-4."""
    jcfg, cfg = _gemma()
    assert cfg.local_global_period == 2 and cfg.num_layers % 2 == 0
    jparams = JM.init_params(jax.random.key(0), jcfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    jmesh = _jax_mesh()
    jctx = JaxShardCtx(mesh=jmesh, batch_axes=("data",), paired_lg=True, seq_parallel=False)

    def ref(p, t):
        with jax_shard_ctx(jctx):
            logits, _ = JM.forward_train(p, jcfg, t)
            _, cache, _ = JM.prefill(p, jcfg, t, JM.init_cache(jcfg, B, 24))
            step, _, _ = JM.decode_step(p, jcfg, t[:, :1], cache, jnp.full((B,), 16, jnp.int32))
        return logits, step

    with jmesh:
        jlogits, jstep = jax.jit(ref)(jparams, jnp.asarray(toks))

    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    t = torch.from_numpy(toks)
    outs = {}
    for paired in (True, False):
        ctx = TS.make_ctx(mesh, paired_lg=paired, seq_parallel=False)
        with torch.no_grad(), shard_ctx(ctx):
            logits, _ = TM.forward_train(params, cfg, t)
            cache = TM.init_cache(cfg, B, 24, device="cpu")
            TM.prefill(params, cfg, t, cache)
            step, _, _ = TM.decode_step(params, cfg, t[:, :1], cache,
                                        torch.full((B,), 16, dtype=torch.int32))
        outs[paired] = (logits, step)
    assert torch.equal(outs[True][0], outs[False][0])
    assert torch.equal(outs[True][1], outs[False][1])
    np.testing.assert_allclose(outs[True][0].numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(outs[True][1].numpy(), np.asarray(jstep), **TOL)


# ----------------------------------------------------------------------------- remat policies

@pytest.mark.parametrize("arch", ["qwen3-30b-a3b", "mamba2-370m", "whisper-medium"])
@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_policies_give_the_gradients_of_none(arch, policy):
    """forward_train's gradients under remat_policy "dots" (keep matrix
    products) and "full" (keep everything) equal those under "none"
    (recompute everything) and those without remat."""
    cfg = get_smoke_config(arch)
    params = TM.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, SEQ)).astype(np.int32))
    extra = {k: torch.from_numpy(v) for k, v in _extras(cfg, SEQ).items()}

    def loss(p, c):
        logits, aux = TM.forward_train(p, c, toks, **extra)
        return TS.cross_entropy(logits, toks) + sum(aux.get(k, 0.0) for k in
                                                    ("load_balance_loss", "router_z_loss"))

    grads = {}
    for name, c in (("plain", cfg), ("none", cfg.replace(remat=True, remat_policy="none")),
                    (policy, cfg.replace(remat=True, remat_policy=policy))):
        grads[name] = TS.value_and_grad(lambda p: loss(p, c), params)
    for name in ("none", policy):
        assert float(grads[name][0]) == float(grads["plain"][0])
        for (path, a), (_, b) in zip(flatten_with_paths(grads[name][1]),
                                     flatten_with_paths(grads["plain"][1])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} {path}")


def test_remat_dots_keeps_matmul_outputs_and_recomputes_the_rest():
    """The policies' decisions: "dots" saves the outputs of matrix products
    only, "full" saves everything."""
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.models import model as M
    aten = torch.ops.aten
    assert M._save_dots(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert M._save_dots(None, aten.bmm.default) == CheckpointPolicy.MUST_SAVE
    assert M._save_dots(None, aten.exp.default) == CheckpointPolicy.PREFER_RECOMPUTE
    assert M._save_all(None, aten.exp.default) == CheckpointPolicy.MUST_SAVE
    assert M._remat_policy(get_smoke_config("qwen3-30b-a3b")) is None


# ----------------------------------------------------------------------------- MLA absorb

def test_mla_absorb_reached_through_the_ctx(mesh, monkeypatch):
    """make_decode_step passes ctx.mla_absorb to the (sequence-sharded) MLA
    decode; absorbed and naive give the same tokens and close logits, as the
    reference's own test holds them."""
    cfg = get_smoke_config("deepseek-v2-236b")
    params = TM.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, SEQ)).astype(np.int32))
    seen = []
    real = TA._mla_decode_seqsharded

    def spy(*a, **kw):
        seen.append(a[-1])
        return real(*a, **kw)

    monkeypatch.setattr(TA, "_mla_decode_seqsharded", spy)
    got = {}
    for absorb in (True, False):
        cache = TM.init_cache(cfg, B, SEQ + 1, device="cpu")
        ctx = TS.make_ctx(mesh, mla_absorb=absorb)
        with torch.no_grad(), shard_ctx(ctx):
            TM.prefill(params, cfg, toks, cache, placements=TS.placements_input(cfg, "cpu"))
        dec, _, _ = TS.make_decode_step(cfg, ctx, ShapeCell("d", SEQ + 1, B, "decode"))
        seen.clear()
        nxt, _ = dec(params, cache, {"tokens": toks[:, :1],
                                     "cache_pos": torch.full((B,), SEQ, dtype=torch.int32),
                                     "placements": TS.placements_input(cfg, "cpu")})
        assert seen and set(seen) == {absorb}
        got[absorb] = nxt
    assert torch.equal(got[True], got[False])


def test_remat_recompute_keeps_the_context_on_another_thread(mesh):
    """The backward of a card's tensors runs on autograd's own thread,
    where the (thread-local) shard context is unset; the recomputation of
    a remat unit must still take the forward's sharded path.  Here the
    backward runs on a second thread: the gradients equal those without
    remat."""
    import threading
    cfg = get_smoke_config("qwen3-30b-a3b")
    params = TM.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, SEQ)).astype(np.int32))
    ctx = TS.make_ctx(mesh)
    grads = {}
    for name, c in (("off", cfg), ("none", cfg.replace(remat=True, remat_policy="none"))):
        flat = [t.detach().requires_grad_(t.is_floating_point())
                for _, t in flatten_with_paths(params)]
        tree = unflatten(params, flat)
        with torch.enable_grad(), shard_ctx(ctx):
            logits, aux = TM.forward_train(tree, c, toks)
            loss = TS.cross_entropy(logits, toks) + aux["load_balance_loss"]
        out = {}
        wrt = [p for p in flat if p.requires_grad]
        worker = threading.Thread(
            target=lambda: out.update(g=torch.autograd.grad(loss, wrt)))
        worker.start()
        worker.join()
        grads[name] = out["g"]
    for a, b in zip(grads["none"], grads["off"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
