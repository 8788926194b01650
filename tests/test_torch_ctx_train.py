"""The port's ``make_train_step`` under a shard context at world size 1
against the reference's under a directly built (1, 1) ``Mesh``, for all
eleven smoke configs in f32 (split from tests/test_torch_ctx.py, whose
helpers it uses, to keep each file's run short): loss, grad norm, every
updated param and first moment within 2e-4, and the param and optimizer
spec trees the makers return.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.config import ShapeCell as JaxShapeCell
from repro.training import optimizer as JO
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps as TS
from repro_torch.models.config import ShapeCell
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import optimizer as TO
from test_torch_ctx import (ARCHS, B, OPT, SEQ, _assert_trees, _extras, _jax_mesh,  # noqa: F401
                            _port_spec_tuples, _spec_tuples, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_under_ctx_matches_reference(mesh, arch):
    """make_train_step with a context: loss, grad norm, every updated param
    and moment, and the param spec tree it returns."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    from repro.training.data import DataConfig, TokenStream
    batch = TokenStream(DataConfig(vocab_size=cfg.vocab_size, global_batch=B,
                                   seq_len=SEQ, seed=0)).batch_at(0)
    batch.update(_extras(cfg, SEQ))
    jmesh = _jax_mesh()
    jparams = JM.init_params(jax.random.key(0), jcfg)
    with jmesh:
        jfn, (jpspecs, _), _ = JS.make_train_step(jcfg, JS.make_ctx(jmesh),
                                                  JaxShapeCell("t", SEQ, B, "train"),
                                                  JO.AdamWConfig(**OPT), remat=False)
        jp, jst, jm = jax.jit(jfn)(jparams, JO.init_adamw(jparams, JO.AdamWConfig(**OPT)),
                                   jax.tree.map(jnp.asarray, batch))
    ocfg = TO.AdamWConfig(**OPT)
    fn, (pspecs, ospecs), _ = TS.make_train_step(cfg, TS.make_ctx(mesh),
                                                 ShapeCell("t", SEQ, B, "train"), ocfg,
                                                 remat=False)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tp, tst, tm = fn(tparams, TO.init_adamw(tparams, ocfg),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-4)
    _assert_trees(tp, jp)
    _assert_trees(tst.m, jst.m)
    assert _port_spec_tuples(pspecs) == _spec_tuples(jpspecs)
    assert _port_spec_tuples(ospecs.m) == _spec_tuples(jpspecs)


@pytest.mark.parametrize("arch", ["qwen3-30b-a3b", "mamba2-370m"])
def test_remat_policies_under_the_model_axis(mesh, arch):
    """On the stored params and a stored batch (the residual stream the
    rank's sequence block, every layer on its "model" blocks, so each
    checkpointed unit issues collectives into buffers it allocates), the
    gradients under remat_policy "none", "dots" and "full" equal those
    without remat: the recomputation runs the collectives again and keeps
    no buffer one of them wrote."""
    from repro_torch.distributed.context import gather, shard_ctx
    from repro_torch.distributed.sharding import input_shardings, param_specs, place
    from repro_torch.models import model as TM
    from repro_torch.tree import leaves
    cfg = get_smoke_config(arch)
    ctx = TS.make_ctx(mesh)
    params = place(TM.init_params(cfg, seed=0, device="cpu"), param_specs(cfg, ctx), mesh)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, SEQ)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    bctx, lb = TS.batch_view(ctx, place(batch, input_shardings(
        cfg, ctx, ShapeCell("t", SEQ, B, "train"), batch), mesh))

    def grads(policy):
        c = cfg if policy is None else cfg.replace(remat=True, remat_policy=policy)

        def loss(p, b):
            logits, _ = TM.forward_train(p, c, b["tokens"], vocab_blocks=True)
            return TS.cross_entropy(logits, b["labels"])
        with shard_ctx(bctx):
            return [gather(g) for g in leaves(TS.value_and_grad(loss, params, lb, ctx=bctx)[1])]

    want = grads(None)
    for policy in ("none", "dots", "full"):
        for got, w in zip(grads(policy), want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)
