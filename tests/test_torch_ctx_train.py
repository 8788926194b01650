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
