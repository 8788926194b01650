"""The port's spec trees (``repro_torch.distributed.sharding``) against the
reference's ``PartitionSpec``s, for all eleven full configs on the
production meshes (16, 16) ("data", "model") and (2, 16, 16) ("pod",
"data", "model").  Shapes only: the reference works on an ``AbstractMesh``
and ``jax.eval_shape``, the port on a shape-only ``Mesh`` and the meta
device, so nothing is allocated.  Every leaf's spec must be equal, entry
for entry (None, an axis name, or a tuple of axis names); ``named`` gives
each leaf the DTensor placements its spec describes.
"""
import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import cell_applicable, input_specs
from repro.configs import get_config as jax_config
from repro.distributed import sharding as JS
from repro.distributed.context import ShardCtx as JaxShardCtx
from repro.models import model as JM
from repro.models.config import SHAPE_CELLS
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as TS
from repro_torch.distributed.context import Mesh, P
from repro_torch.launch.steps import make_ctx
from repro_torch.models import model as TM

ARCHS = tuple(list_archs())
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_ctx(mesh_name):
    sizes, names = MESHES[mesh_name]
    try:
        mesh = AbstractMesh(sizes, names)
    except TypeError:          # older jax takes (name, size) pairs
        mesh = AbstractMesh(tuple(zip(names, sizes)))
    return JaxShardCtx(mesh=mesh, batch_axes=tuple(a for a in names if a != "model"))


def _port_ctx(mesh_name):
    return make_ctx(Mesh(*MESHES[mesh_name]))


def _jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _port_specs(tree, prefix: str = "") -> dict:
    """Path -> spec, walked as jax.tree_util walks (dict keys sorted)."""
    if isinstance(tree, P):
        return {prefix: tuple(tree)}
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_port_specs(tree[k], f"{prefix}[{k!r}]"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_port_specs(v, f"{prefix}[{i}]"))
    return out


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_name):
    want = _jax_specs(JS.param_specs(jax_config(arch), _jax_ctx(mesh_name)))
    got = _port_specs(TS.param_specs(get_config(arch), _port_ctx(mesh_name)))
    _assert_same(got, want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh_name):
    """Every decode cell the reference applies to the arch, and a short
    cache whose length the model axis does not divide."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    jctx, ctx = _jax_ctx(mesh_name), _port_ctx(mesh_name)
    shapes = [(c.global_batch, c.seq_len + (cfg.vision_prefix_len if cfg.family == "vlm" else 0))
              for c in SHAPE_CELLS if c.kind == "decode" and cell_applicable(jcfg, c)[0]]
    for batch, total in shapes + [(3, 24)]:
        want = _jax_specs(JS.cache_specs(jcfg, jctx, batch, total))
        got = _port_specs(TS.cache_specs(cfg, ctx, batch, total))
        _assert_same(got, want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_shardings_match_reference(arch, mesh_name):
    jcfg, cfg = jax_config(arch), get_config(arch)
    for cell in SHAPE_CELLS:
        if not cell_applicable(jcfg, cell)[0]:
            continue
        specs = input_specs(jcfg, cell)
        want = JS.input_shardings(jcfg, _jax_ctx(mesh_name), cell, specs)
        got = TS.input_shardings(cfg, _port_ctx(mesh_name), cell,
                                 {k: tuple(v.shape) for k, v in specs.items()})
        assert list(got) == list(want)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_named_gives_the_placements_of_each_spec(mesh_name):
    """For every leaf of qwen3's and deepseek's trees: ``Shard(d)`` on each
    mesh axis the spec splits dim d over, ``Replicate()`` on the others,
    and the split dims divide."""
    from torch.distributed.tensor import Replicate, Shard
    ctx = _port_ctx(mesh_name)
    mesh = ctx.mesh
    for arch in ("qwen3-30b-a3b", "deepseek-v2-236b"):
        cfg = get_config(arch)
        specs = TS.param_specs(cfg, ctx)
        placements = TS.named(mesh, specs)
        shapes = {p: tuple(t.shape) for p, t in
                  _leaves_with_paths(TM.abstract_params(cfg))}
        flat_s, flat_p = _port_specs(specs), _flat_placements(placements)
        assert list(flat_s) == list(flat_p) == list(shapes)
        for path, spec in flat_s.items():
            for a, pl in zip(mesh.axis_names, flat_p[path]):
                dims = [d for d, e in enumerate(spec)
                        if e == a or (isinstance(e, tuple) and a in e)]
                assert pl == (Shard(dims[0]) if dims else Replicate()), (path, spec, pl)
            for d, e in enumerate(spec):
                assert e is None or shapes[path][d] % mesh.axis_size(e) == 0, (path, spec)
    # an explicit case: batch over ("pod", "data") or ("data",), vocab over model
    want = {"16x16": (Shard(1), Shard(0)),
            "2x16x16": (Replicate(), Shard(1), Shard(0))}[mesh_name]
    assert TS.named(mesh, P("model", "data")) == want


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _flat_placements(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_placements(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_placements(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def test_abstract_params_allocate_nothing_and_match_init_shapes():
    """``abstract_params`` is the meta tree of ``init_params``'s shapes and
    dtypes (the reference's ``abstract_params``), for a full config."""
    cfg = get_config("llama4-maverick-400b-a17b")
    jax_tree = JM.abstract_params(jax_config("llama4-maverick-400b-a17b"))
    jshapes = {jax.tree_util.keystr(p): tuple(a.shape)
               for p, a in jax.tree_util.tree_leaves_with_path(jax_tree)}
    tree = TM.abstract_params(cfg)
    got = dict(_leaves_with_paths(tree))
    assert all(t.device.type == "meta" for t in got.values())
    assert {p: tuple(t.shape) for p, t in got.items()} == jshapes


# ----------------------------------------------------------------------------- constraints

def _recorded_spec(monkeypatch, module, fn, *args):
    """Call the reference's constraint ``fn`` on shapes with
    ``with_sharding_constraint`` recording the spec it is given (None when
    it pins nothing)."""
    seen = []
    monkeypatch.setattr(module, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    fn(*args)
    return seen[0] if seen else None


CONSTRAINT_SHAPES = [(32, 64, 16, 128), (32, 64, 8, 256), (32, 1, 8, 256), (3, 48, 40, 128),
                     (32, 48, 40, 128), (1, 4096, 32, 64)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", CONSTRAINT_SHAPES)
def test_constraint_decisions_match_reference(monkeypatch, mesh_name, shape):
    """``head_spec`` (attention, both ``allow_seq`` values), ``ssm_head_spec``
    (mamba2 on the head axis) and ``seq_spec`` name the layout the reference
    pins each activation to, or None where it pins nothing."""
    import torch
    from repro.distributed.context import shard_ctx as jax_shard_ctx
    from repro.models import attention as JA
    from repro.models import mamba2 as JM2
    from repro.models import model as JMM
    x_j = jax.ShapeDtypeStruct(shape, jax.numpy.float32)
    x_t = torch.empty(shape, device="meta")
    r_j = jax.ShapeDtypeStruct(shape[:3], jax.numpy.float32)
    r_t = torch.empty(shape[:3], device="meta")
    ctx = _port_ctx(mesh_name)
    with jax_shard_ctx(_jax_ctx(mesh_name)):
        for allow in (False, True):
            want = _recorded_spec(monkeypatch, JA, JA._head_constraint, x_j, allow)
            got = TS.head_spec(ctx, x_t, allow)
            assert (tuple(got) if got is not None else None) == want, (allow, got, want)
        want = _recorded_spec(monkeypatch, JM2, JM2._head_constraint, x_j, 2)
        got = TS.ssm_head_spec(ctx, x_t, 2)
        assert (tuple(got) if got is not None else None) == want
        want = _recorded_spec(monkeypatch, JMM, JMM._seq_constraint, r_j)
        got = TS.seq_spec(ctx, r_t)
        assert (tuple(got) if got is not None else None) == want


def test_ctx_helpers_match_reference():
    from repro.launch.mesh import batch_axes_of as jax_batch_axes_of
    from repro_torch.launch.mesh import batch_axes_of
    for name in MESHES:
        jctx, ctx = _jax_ctx(name), _port_ctx(name)
        assert batch_axes_of(ctx.mesh) == jax_batch_axes_of(jctx.mesh) == jctx.batch_axes
        assert (ctx.dp, ctx.tp) == (jctx.dp, jctx.tp)
        assert tuple(ctx.batch_spec(None, "model")) == tuple(jctx.batch_spec(None, "model"))
