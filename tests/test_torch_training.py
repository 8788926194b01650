"""The port's training (token stream, AdamW, gradient compression,
checkpoints, the train step and ``launch.train``) against the JAX
reference on the CPU, at the smoke configs in f32 with the reference's own
weights bridged through ``repro_torch.models.convert``.

The reference's ``train()`` builds its mesh with ``jax.make_mesh``, whose
axes are Explicit on this jax, and its first ``with_sharding_constraint``
then raises; a ``Mesh`` built directly has Auto axes and works.  So the
reference side runs its own ``make_train_step`` (jitted, no shardings)
under ``jax.sharding.Mesh`` of one device, and its loop is recomposed from
``make_train_step``, ``TokenStream`` and identity placements.

Tolerances: the optimizer's f32 leaves within 1e-6 relative (both sides
run the same f32 operations in the same order), its bf16 leaves exact;
one train step's loss and grad norm within 2e-4 relative, every gradient
and updated leaf within 2e-4 (tests/test_kernels.py's f32 tolerance); the
token stream, top-k compression, int8 dequantisation and checkpoints
bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import list_archs
from repro.distributed.context import shard_ctx
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.config import ShapeCell as JaxShapeCell
from repro.training import checkpoint as JC
from repro.training import compression as JCOMP
from repro.training import data as JD
from repro.training import optimizer as JO
from repro_torch.configs import at_depth, depth_pair, get_config, get_smoke_config
from repro_torch.launch import steps as TS
from repro_torch.launch.train import train
from repro_torch.models import model as TM
from repro_torch.models.config import SHAPE_CELLS, ShapeCell
from repro_torch.models.convert import adamw_state_from_numpy, params_from_numpy
from repro_torch.training import checkpoint as TC
from repro_torch.training import compression as TCOMP
from repro_torch.training import data as TD
from repro_torch.training import optimizer as TO
from repro_torch.tree import flatten_with_paths, leaves, map_tree, unflatten

TOL = dict(rtol=2e-4, atol=2e-4)
BATCH, SEQ = 2, 16
ARCHS = tuple(list_archs())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind in "fV" else a


def _np_tree(tree):
    """A jax tree as the same tree of numpy arrays (bf16 stays bf16)."""
    return jax.tree.map(np.asarray, tree)


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _torch_leaves(tree) -> dict:
    return dict(flatten_with_paths(tree))


# ----------------------------------------------------------------------------- tree

def test_tree_paths_and_order_match_jax():
    """Leaf order and keystr paths of nested dicts (keys out of order),
    lists, tuples, None and a NamedTuple equal jax.tree_util's, and
    unflatten rebuilds the structure."""
    def tree(mk):
        return ({"b": [mk(1), (mk(2),)], "a": {"z": mk(3), "c": None}},
                JO.AdamWState(step=mk(4), m={"w": mk(5)}, v={"w": mk(6)}))

    jt = tree(lambda i: jnp.full((1,), i))
    tt = (tree(lambda i: torch.full((1,), i))[0],
          TO.AdamWState(*tree(lambda i: torch.full((1,), i))[1]))
    want = [(jax.tree_util.keystr(p), int(a[0]))
            for p, a in jax.tree_util.tree_flatten_with_path(jt)[0]]
    got = [(p, int(t[0])) for p, t in flatten_with_paths(tt)]
    assert got == want
    back = unflatten(tt, [t * 10 for t in leaves(tt)])
    assert [int(t[0]) for t in leaves(back)] == [v * 10 for _, v in want]
    assert type(back[1]) is TO.AdamWState and back[0]["a"]["c"] is None
    assert list(back[0]) == ["b", "a"]
    with pytest.raises(ValueError):
        unflatten({"w": torch.zeros(1)}, [torch.zeros(1), torch.zeros(1)])


# ----------------------------------------------------------------------------- configs

def test_shape_cells_and_depth_helpers_match_reference():
    from repro.configs import at_depth as jat_depth
    from repro.configs import depth_pair as jdepth_pair
    from repro.models.config import SHAPE_CELLS as JCELLS
    assert [tuple(vars(c).values()) for c in SHAPE_CELLS] == \
        [tuple(vars(c).values()) for c in JCELLS]
    for arch in ARCHS:
        cfg = get_config(arch)
        assert depth_pair(cfg) == jdepth_pair(cfg)
        for depth in depth_pair(cfg):
            mine, ref = at_depth(cfg, depth), jat_depth(cfg, depth)
            assert (mine.num_layers, mine.num_encoder_layers) == \
                (ref.num_layers, ref.num_encoder_layers)
            assert mine.total_params() == ref.total_params()


# ----------------------------------------------------------------------------- data

@pytest.mark.parametrize("step,host,hosts", [(0, 0, 1), (7, 0, 1), (3, 1, 2), (11, 3, 4)])
def test_token_stream_matches_reference(step, host, hosts):
    kw = dict(vocab_size=997, global_batch=8, seq_len=33, seed=5, num_hosts=hosts,
              host_id=host)
    mine = TD.TokenStream(TD.DataConfig(**kw)).batch_at(step)
    ref = JD.TokenStream(JD.DataConfig(**kw)).batch_at(step)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype == np.int32
        np.testing.assert_array_equal(mine[k], ref[k])


def test_pack_documents_matches_reference():
    lens = np.random.default_rng(0).integers(1, 700, size=40)
    mine, ref = TD.pack_documents(lens, 512), JD.pack_documents(lens, 512)
    np.testing.assert_array_equal(mine[0], ref[0])
    assert mine[1] == ref[1]


# ----------------------------------------------------------------------------- optimizer

def test_lr_schedule_matches_reference():
    for cfg in (dict(lr=1.0, warmup_steps=10, decay_steps=110, min_lr_frac=0.1),
                dict(warmup_steps=10, decay_steps=12), dict(warmup_steps=0)):
        mine = TO.AdamWConfig(**cfg)
        ref = JO.AdamWConfig(**cfg)
        got = np.array([float(TO.lr_schedule(mine, torch.tensor(s, dtype=torch.int32)))
                        for s in range(121)], np.float32)
        want = np.array([float(JO.lr_schedule(ref, jnp.asarray(s, jnp.int32)))
                         for s in range(121)], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _opt_tree(rng, scale: float):
    """f32 and bf16 params, matrices next to vectors and a scalar."""
    return {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "blocks": {"wq": (rng.normal(size=(2, 4, 3)) * scale).astype(jnp.bfloat16),
                       "norm": (rng.normal(size=(7,)) * scale).astype(jnp.bfloat16)},
            "s": np.asarray(rng.normal() * scale, np.float32)}


def _assert_opt_equal(got, want):
    """f32 leaves within 1e-6 relative, bf16 leaves exact."""
    g, w = _torch_leaves(got), _jax_leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), k
        if w[k].dtype == jnp.bfloat16:
            np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)
        else:
            np.testing.assert_allclose(_np(g[k]), _np(w[k]), rtol=1e-6, atol=0, err_msg=k)


def test_global_norm_matches_reference():
    tree = _opt_tree(np.random.default_rng(1), 3.0)
    got = TO.global_norm(params_from_numpy(tree, "cpu"))
    want = JO.global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_update_matches_reference(moment_dtype, clip):
    """Three successive updates of one tree (grads drawn anew each step);
    with the clip active the grad norm is ~40x the clip, inactive ~1/8."""
    rng = np.random.default_rng(2)
    params = _opt_tree(rng, 1.0)
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=5, weight_decay=0.1,
               grad_clip=1.0, moment_dtype=moment_dtype)
    mine_cfg, ref_cfg = TO.AdamWConfig(**cfg), JO.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JO.init_adamw(jp, ref_cfg)
    tp = params_from_numpy(params, "cpu")
    tstate = TO.init_adamw(tp, mine_cfg)
    _assert_opt_equal(tstate, jstate)
    for _ in range(3):
        grads = _opt_tree(rng, 10.0 if clip == "active" else 0.03)
        jp, jstate, jm = JO.adamw_update(jp, jax.tree.map(jnp.asarray, grads), jstate,
                                         ref_cfg)
        tp, tstate, tm = TO.adamw_update(tp, params_from_numpy(grads, "cpu"), tstate,
                                         mine_cfg)
        assert (float(jm["grad_norm"]) > 1.0) == (clip == "active")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        _assert_opt_equal(tp, jp)
        _assert_opt_equal(tstate, jstate)
        assert int(tstate.step) == int(jstate.step)


def test_adamw_update_chunks_large_leaves_exactly(monkeypatch):
    """A leaf above UPDATE_CHUNK is updated a slice at a time into new
    tensors with the same numbers as in one pass."""
    rng = np.random.default_rng(3)
    params = params_from_numpy({"w": rng.normal(size=(5, 7)).astype(np.float32),
                                "b": rng.normal(size=(9,)).astype(np.float32)}, "cpu")
    grads = map_tree(lambda p: torch.randn(p.shape, generator=torch.Generator().manual_seed(
        p.numel()), dtype=p.dtype) * 5, params)
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=0, moment_dtype="bfloat16")
    whole = TO.adamw_update(params, grads, TO.init_adamw(params, cfg), cfg)
    monkeypatch.setattr(TO, "UPDATE_CHUNK", 4)
    sliced = TO.adamw_update(params, grads, TO.init_adamw(params, cfg), cfg)
    for a, b in zip(leaves(whole[:2]), leaves(sliced[:2])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# ----------------------------------------------------------------------------- compression

def test_topk_compress_matches_reference_over_two_rounds():
    rng = np.random.default_rng(4)
    g1 = {"w": rng.normal(size=(16, 16)).astype(np.float32),
          "b": np.round(rng.normal(size=40), 1).astype(np.float32)}   # ties at the threshold
    g2 = {"w": rng.normal(size=(16, 16)).astype(np.float32),
          "b": rng.normal(size=40).astype(np.float32)}
    jst = JCOMP.topk_init(jax.tree.map(jnp.asarray, g1))
    tst = TCOMP.topk_init(params_from_numpy(g1, "cpu"))
    for g in (g1, g2):
        jsent, jst = JCOMP.topk_compress(jax.tree.map(jnp.asarray, g), jst, frac=0.1)
        tsent, tst = TCOMP.topk_compress(params_from_numpy(g, "cpu"), tst, frac=0.1)
        for got, want in ((tsent, jsent), (tst.residual, jst.residual)):
            g_, w_ = _torch_leaves(got), _jax_leaves(want)
            assert g_.keys() == w_.keys()
            for k in w_:
                np.testing.assert_array_equal(_np(g_[k]), _np(w_[k]), err_msg=k)


def test_int8_round_and_dequantize_match_reference():
    g = np.random.default_rng(5).normal(size=(64, 3)).astype(np.float32)
    q, s = TCOMP.quantize_int8(torch.from_numpy(g))
    jq, js = JCOMP.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(_np(TCOMP.dequantize_int8(q, s, dt)),
                                      _np(JCOMP.dequantize_int8(jq, js, jdt)))


def test_int8_stochastic_rounding_unbiased_and_clipped():
    """Over 2000 draws the dequantised mean is within 3 sigma of g, where
    sigma is the rounding's standard error; every value stays in +-127 and
    the largest |g| maps to 127 exactly."""
    g = torch.from_numpy(np.random.default_rng(6).normal(size=256).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    draws = []
    for _ in range(2000):
        q, s = TCOMP.quantize_int8(g, generator=gen)
        assert int(q.abs().max()) <= 127
        assert int(q[g.abs().argmax()].abs()) == 127
        draws.append(TCOMP.dequantize_int8(q, s))
    mean = torch.stack(draws).mean(0)
    frac = g / s - torch.floor(g / s)
    sigma = float(s) * torch.sqrt(frac * (1 - frac) / 2000)
    err = float((mean - g).sum())
    assert abs(err) <= 3 * float(torch.sqrt((sigma ** 2).sum()))
    # without the generator the rounding is deterministic (round half to even)
    assert torch.equal(TCOMP.quantize_int8(g)[0], TCOMP.quantize_int8(g)[0])


# ----------------------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": [torch.ones(4, dtype=torch.bfloat16), torch.zeros((), dtype=torch.int32)]}
    TC.save_checkpoint(tmp_path, 7, state)
    assert TC.latest_step(tmp_path) == 7
    step, restored = TC.restore_checkpoint(tmp_path, state)
    assert step == 7
    for x, y in zip(leaves(state), leaves(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_gc_keeps_newest(tmp_path):
    state = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        TC.save_checkpoint(tmp_path, s, state, keep=2)
    assert TC.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000003",
                                                               "step_00000004"]


def test_checkpoint_ignores_incomplete(tmp_path):
    TC.save_checkpoint(tmp_path, 1, {"w": torch.zeros(2)})
    broken = tmp_path / "step_00000009"
    broken.mkdir()
    (broken / "leaf_00000.npy").write_bytes(b"junk")
    assert TC.latest_step(tmp_path) == 1
    assert TC.latest_step(tmp_path / "absent") is None


def test_checkpoint_shape_or_count_mismatch_rejected(tmp_path):
    TC.save_checkpoint(tmp_path, 1, {"w": torch.zeros(2)})
    with pytest.raises(ValueError):
        TC.restore_checkpoint(tmp_path, {"w": torch.zeros(3)})
    with pytest.raises(ValueError):
        TC.restore_checkpoint(tmp_path, {"w": torch.zeros(2), "v": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        TC.restore_checkpoint(tmp_path / "absent", {"w": torch.zeros(2)})


def _bf16_train_state():
    """The smoke qwen3's (params, AdamW state) in bf16 (its router stays
    f32), moments in bf16 with a non-zero step, from the reference."""
    cfg = jax_smoke_config("qwen3-30b-a3b").replace(dtype="bfloat16")
    params = JM.init_params(jax.random.key(0), cfg)
    ocfg = JO.AdamWConfig(moment_dtype="bfloat16")
    st = JO.init_adamw(params, ocfg)
    st = JO.AdamWState(step=jnp.asarray(3, jnp.int32),
                       m=jax.tree.map(lambda p: (p * 0.5).astype(jnp.bfloat16), params),
                       v=jax.tree.map(lambda p: (p * p).astype(jnp.bfloat16), params))
    return params, st


def test_checkpoint_cross_package(tmp_path):
    """A reference save restores in the port and a port save restores in
    the reference, bit for bit, bf16 leaves included; the manifests' paths
    are the reference's ``_tree_paths``."""
    jparams, jst = _bf16_train_state()
    jstate = (jparams, jst)
    np_params, np_st = _np_tree(jparams), _np_tree(jst)
    tstate = (params_from_numpy(np_params, "cpu"),
              adamw_state_from_numpy(np_st.step, np_st.m, np_st.v, "cpu"))
    assert any(t.dtype == torch.bfloat16 for t in leaves(tstate))
    zeros_like = map_tree(torch.zeros_like, tstate)

    JC.save_checkpoint(tmp_path / "ref", 5, jstate)
    step, got = TC.restore_checkpoint(tmp_path / "ref", zeros_like)
    assert step == 5
    g, w = _torch_leaves(got), _jax_leaves(jstate)
    assert list(g) == list(w)
    for k in w:
        assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), k
        np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)

    TC.save_checkpoint(tmp_path / "port", 6, tstate)
    manifest = json.loads((tmp_path / "port" / "step_00000006" / "manifest.json").read_text())
    assert [r["path"] for r in manifest["leaves"]] == JC._tree_paths(jstate)
    ref_manifest = json.loads((tmp_path / "ref" / "step_00000005" / "manifest.json")
                              .read_text())
    strip = lambda recs: [{k: r[k] for k in ("index", "path", "file", "shape", "dtype")}
                          for r in recs]
    assert strip(manifest["leaves"]) == strip(ref_manifest["leaves"])
    step, back = JC.restore_checkpoint(tmp_path / "port",
                                       jax.tree.map(jnp.zeros_like, jstate))
    assert step == 6
    for (path, a), b in zip(flatten_with_paths(tstate), jax.tree.leaves(back)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)


# ----------------------------------------------------------------------------- train step

def _batch(cfg, seed: int = 0) -> dict:
    """A TokenStream batch plus what the model takes: identity placements
    for MoE, seeded vision embeddings (VLM) and frames (whisper)."""
    b = TD.TokenStream(TD.DataConfig(vocab_size=cfg.vocab_size, global_batch=BATCH,
                                     seq_len=SEQ, seed=seed)).batch_at(0)
    rng = np.random.default_rng(seed + 1)
    if cfg.is_moe:
        b["placements"] = np.broadcast_to(np.arange(cfg.num_experts, dtype=np.int32),
                                          (cfg.num_moe_layers(), cfg.num_experts)).copy()
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.normal(size=(BATCH, cfg.vision_prefix_len, cfg.d_model)
                                        ).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["frames"] = rng.normal(size=(BATCH, min(cfg.encoder_len, SEQ), cfg.d_model)
                                 ).astype(np.float32)
    return b


def _ref_loss(cfg):
    """The reference train step's loss (src/repro/launch/steps.py:80-96)."""
    def loss_fn(p, batch):
        kw = {k: batch[k] for k in ("vision_embeds", "frames") if k in batch}
        logits, aux = JM.forward_train(p, cfg, batch["tokens"],
                                       placements=batch.get("placements"), **kw)
        if cfg.family == "vlm" and "vision_embeds" in batch:
            logits = logits[:, batch["vision_embeds"].shape[1]:, :]
        loss = JS.cross_entropy(logits, batch["labels"])
        if cfg.is_moe:
            loss = loss + cfg.router_aux_coef * aux.get("load_balance_loss", 0.0) \
                + cfg.router_z_coef * aux.get("router_z_loss", 0.0)
        return loss
    return loss_fn


OPT = dict(lr=1e-3, warmup_steps=0, decay_steps=100, moment_dtype="float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step of the port's make_train_step against the reference's from
    the same weights and batch: loss and grad norm, every gradient (the
    reference's value_and_grad of its step's loss) and every updated param
    and moment; the port's remat on and off give the same numbers."""
    cfg = jax_smoke_config(arch)
    cell = JaxShapeCell("t", SEQ, BATCH, "train")
    mesh = _mesh()
    ctx = JS.make_ctx(mesh)
    batch = _batch(cfg)
    jparams = JM.init_params(jax.random.key(0), cfg)
    with mesh:
        fn, _, _ = JS.make_train_step(cfg, ctx, cell, JO.AdamWConfig(**OPT), remat=False)

        def both(p, s, b):
            with shard_ctx(ctx):
                vg = jax.value_and_grad(_ref_loss(cfg))(p, b)
            return vg, fn(p, s, b)

        (jloss, jgrads), (jp, jst, jm) = jax.jit(both)(
            jparams, JO.init_adamw(jparams, JO.AdamWConfig(**OPT)),
            jax.tree.map(jnp.asarray, batch))

    tcfg = get_smoke_config(arch)
    tparams = params_from_numpy(_np_tree(jparams), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ocfg = TO.AdamWConfig(**OPT)
    fn_t, specs, out_specs = TS.make_train_step(tcfg, None, ShapeCell("t", SEQ, BATCH, "train"),
                                                ocfg, remat=False)
    assert specs == (None, None) and out_specs == (None, None, None)
    loss, grads = TS.value_and_grad(
        lambda p, b: _port_loss(tcfg, p, b), tparams, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-4)
    g, w = _torch_leaves(grads), _jax_leaves(jgrads)
    assert list(g) == list(w)
    for k in w:
        np.testing.assert_allclose(_np(g[k]), _np(w[k]), **TOL, err_msg=f"grad {k}")

    tp, tst, tm = fn_t(tparams, TO.init_adamw(tparams, ocfg), tbatch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-4)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        g, w = _torch_leaves(got), _jax_leaves(want)
        for k in w:
            np.testing.assert_allclose(_np(g[k]), _np(w[k]), **TOL, err_msg=k)

    fn_r, _, _ = TS.make_train_step(tcfg, None, None, ocfg)          # remat=True
    rp, _, rm = fn_r(tparams, TO.init_adamw(tparams, ocfg), tbatch)
    assert float(rm["loss"]) == float(tm["loss"])
    assert float(rm["grad_norm"]) == float(tm["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(rp), leaves(tp)))


def _port_loss(cfg, p, batch):
    """The port train step's loss, composed as ``_ref_loss`` is."""
    kw = {k: batch[k] for k in ("vision_embeds", "frames") if k in batch}
    logits, aux = TM.forward_train(p, cfg, batch["tokens"],
                                   placements=batch.get("placements"), **kw)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        logits = logits[:, batch["vision_embeds"].shape[1]:, :]
    loss = TS.cross_entropy(logits, batch["labels"])
    if cfg.is_moe:
        loss = loss + cfg.router_aux_coef * aux["load_balance_loss"] \
            + cfg.router_z_coef * aux["router_z_loss"]
    return loss


def test_cross_entropy_matches_reference_one_hot():
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(3, 5, 301)) * 4).astype(np.float32)
    labels = rng.integers(0, 301, size=(3, 5)).astype(np.int32)
    got = TS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_placements_and_unported_options_raise():
    """The identity placements; a mesh of more ranks than the process group
    holds is refused (the remat policies and the shard context that this
    test once saw refused are ported, tests/test_torch_ctx.py)."""
    cfg = get_smoke_config("qwen3-30b-a3b")
    pl = TS.placements_input(cfg, "cpu")
    assert pl.shape == (cfg.num_moe_layers(), cfg.num_experts) and pl.dtype == torch.int32
    assert torch.equal(pl, torch.arange(cfg.num_experts, dtype=torch.int32).expand_as(pl))
    assert TS.placements_input(get_smoke_config("gemma2-2b")) is None
    with pytest.raises(ValueError, match="holds 2 ranks"):
        train("qwen3-30b-a3b", steps=1, mesh_shape=(1, 2), device="cpu")


def test_prefill_and_decode_steps_match_forward():
    """The plain serving steps give the argmax of the model's own prefill
    and decode logits."""
    cfg = get_smoke_config("qwen3-30b-a3b")
    params = TM.init_params(cfg, device="cpu")
    cell = ShapeCell("p", 8, 2, "prefill")
    toks = torch.from_numpy(_batch(cfg)["tokens"][:, :8])
    first, cache = TS.make_prefill_step(cfg, None, cell)[0](params, {"tokens": toks})
    with torch.no_grad():
        logits, _, _ = TM.prefill(params, cfg, toks, TM.init_cache(cfg, 2, 8, device="cpu"))
    assert first.dtype == torch.int32
    assert torch.equal(first, logits[:, -1].argmax(-1).int())
    dec_cell = ShapeCell("d", 12, 2, "decode")
    full = TM.init_cache(cfg, 2, 12, device="cpu")
    with torch.no_grad():
        TM.prefill(params, cfg, toks, full)
    want_cache = map_tree(torch.clone, full)
    pos = torch.full((2,), 8, dtype=torch.int32)
    nxt, _ = TS.make_decode_step(cfg, None, dec_cell)[0](
        params, full, {"tokens": first[:, None], "cache_pos": pos})
    with torch.no_grad():
        want, _, _ = TM.decode_step(params, cfg, first[:, None], want_cache, pos)
    assert torch.equal(nxt, want.argmax(-1).int())


# ----------------------------------------------------------------------------- train loop

LOOP_ARCH, LOOP_STEPS = "qwen3-30b-a3b", 12


def _ref_loop(params_np, steps: int) -> list:
    """The reference's train() loop, recomposed under a directly built mesh
    (its own train() is red on this jax): same data, optimizer settings and
    identity placements, from the given weights."""
    cfg = jax_smoke_config(LOOP_ARCH)
    opt_cfg = JO.AdamWConfig(moment_dtype="float32", warmup_steps=10,
                             decay_steps=max(steps, 2))
    data = JD.TokenStream(JD.DataConfig(vocab_size=cfg.vocab_size, global_batch=BATCH,
                                        seq_len=SEQ, seed=0))
    mesh = _mesh()
    losses = []
    with mesh:
        fn, _, _ = JS.make_train_step(cfg, JS.make_ctx(mesh),
                                      JaxShapeCell("train_custom", SEQ, BATCH, "train"),
                                      opt_cfg, remat=False)
        jfn = jax.jit(fn)
        params = jax.tree.map(jnp.asarray, params_np)
        state = JO.init_adamw(params, opt_cfg)
        placements = jnp.broadcast_to(jnp.arange(cfg.num_experts, dtype=jnp.int32),
                                      (cfg.num_moe_layers(), cfg.num_experts))
        for step in range(steps):
            b = {k: jnp.asarray(v) for k, v in data.batch_at(step).items()}
            b["placements"] = placements
            params, state, m = jfn(params, state, b)
            losses.append(float(m["loss"]))
    return losses


def test_train_loop_matches_reference_and_resumes_exactly(tmp_path):
    """The port's train() against the reference's loop from the port's own
    initial weights, every step within 2e-4; a run cut at step 6 and
    resumed from its checkpoint gives the uninterrupted run's losses for
    steps 6-11 exactly."""
    kw = dict(steps=LOOP_STEPS, batch=BATCH, seq=SEQ, log_every=1000, device="cpu")
    full = train(LOOP_ARCH, ckpt_dir=str(tmp_path / "a"), ckpt_every=100, **kw)
    init = TM.init_params(get_smoke_config(LOOP_ARCH), seed=0, device="cpu")
    want = _ref_loop(map_tree(lambda t: t.numpy(), init), LOOP_STEPS)
    np.testing.assert_allclose(full, want, rtol=2e-4, atol=0)
    assert full[-1] < full[0]
    assert TC.latest_step(tmp_path / "a") == LOOP_STEPS

    half = train(LOOP_ARCH, ckpt_dir=str(tmp_path / "b"), ckpt_every=6,
                 **dict(kw, steps=6))
    assert half == full[:6]
    resumed = train(LOOP_ARCH, ckpt_dir=str(tmp_path / "b"), ckpt_every=100, **kw)
    assert resumed == full[6:]
