"""The port's dry run (``repro_torch.launch.dryrun``) and its stand-ins
against the reference's, on the CPU, with shapes only.

* ``cell_applicable``, ``dryrun_cells``, ``get_cell``, ``input_specs`` and
  ``model_flops`` for all eleven archs and the four cells;
* ``abstract_cache``, ``abstract_train_state`` and ``abstract_adamw``, leaf
  for leaf, against the reference's ``jax.eval_shape`` trees;
* the store's per-rank bytes for every full config, applicable cell and
  production mesh, against the sum of the reference's per-leaf shard
  shapes under its own specs (an ``AbstractMesh``; exact integers);
* the compiled oracle: five cells through the reference's ``run_cell`` in a
  subprocess (its 512 forced host devices; ``make_production_mesh``
  patched to a directly built ``Mesh``, whose Auto axes the reference's
  MoE runs under on this jax), against the port's dry-run records:
  XLA's argument and output bytes, exactly;
* batch blocks: a smoke qwen3 cell's FLOPs a rank on both production
  meshes, at most 2 / dp of the whole batch's (``--batch-whole``);
* the model axis: the port's FLOPs a rank over XLA's in each compiled
  cell, within that cell's bounds (``FLOP_BOUNDS``), and over the FLOPs of
  the compiled program's ``dot`` instructions (``hlo_dot_flops``), at
  least ``DOT_FLOORS``;
* the collective bytes of the expert gather over "data" on a (2, 2) fake
  group, against what ``moe_sharded._use_token_gather`` states;
* the fake group: ``make_mesh``, ``train()`` and ``serve()`` refuse it, and
  the dry run refuses a real group.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` when it is imported, so this
file imports it only inside a test, with the variable restored after.
"""
import functools
import importlib
import inspect
import json
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import cell_applicable as j_cell_applicable
from repro.configs import dryrun_cells as j_dryrun_cells
from repro.configs import get_cell as j_get_cell
from repro.configs import get_config as jax_config
from repro.configs import input_specs as j_input_specs
from repro.distributed import sharding as JSh
from repro.distributed.context import ShardCtx as JaxShardCtx
from repro.launch import steps as JS
from repro.models.config import SHAPE_CELLS as J_CELLS
from repro.training import optimizer as JO
from repro_torch.configs import dryrun_cells, get_cell, get_config, input_specs, list_archs
from repro_torch.distributed.context import Mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as TS
from repro_torch.models.config import SHAPE_CELLS, cell_applicable
from repro_torch.training import optimizer as TO
from repro_torch.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tuple(list_archs())
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# (arch, cell, multi-pod, depth) -> XLA's (argument, output) bytes per device
ORACLE = {("qwen3-30b-a3b", "decode_32k", False, 4): (159828032, 134217784),
          ("qwen3-30b-a3b", "decode_32k", True, 4): (92719136, 67108904),
          ("qwen3-30b-a3b", "train_4k", False, 4): (77088772, 76562792),
          ("qwen2-72b", "decode_32k", False, 4): (323358784, 268435512),
          ("mamba2-370m", "long_500k", False, 0): (37613700, 2236444)}


def _reference_dryrun():
    """``repro.launch.dryrun`` with ``XLA_FLAGS`` left as it was."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _jax_ctx(mesh_name):
    sizes, names = MESHES[mesh_name]
    try:
        mesh = AbstractMesh(sizes, names)
    except TypeError:          # older jax takes (name, size) pairs
        mesh = AbstractMesh(tuple(zip(names, sizes)))
    return JaxShardCtx(mesh=mesh, batch_axes=tuple(a for a in names if a != "model"))


def _shape_dtype(t) -> tuple:
    return tuple(int(x) for x in t.shape), str(t.dtype).replace("torch.", "")


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): _shape_dtype(x) for p, x in flat}


def _port_leaves(tree) -> dict:
    return {p: _shape_dtype(x) for p, x in flatten_with_paths(tree)}


@functools.lru_cache(maxsize=None)
def _jax_train_state(arch: str):
    return JS.abstract_train_state(jax_config(arch))


@functools.lru_cache(maxsize=None)
def _jax_cache(arch: str, cell_name: str):
    return JS.abstract_cache(jax_config(arch), j_get_cell(cell_name))


# ----------------------------------------------------------------------------- stand-ins

@pytest.mark.parametrize("arch", ARCHS)
def test_cells_match_reference(arch):
    assert [c.name for c in dryrun_cells(arch)] == [c.name for c in j_dryrun_cells(arch)]
    for cell, jcell in zip(SHAPE_CELLS, J_CELLS):
        assert cell_applicable(get_config(arch), cell) == j_cell_applicable(jax_config(arch),
                                                                            jcell)
        got, want = get_cell(cell.name), j_get_cell(cell.name)
        assert (got.name, got.seq_len, got.global_batch, got.kind) == \
            (want.name, want.seq_len, want.global_batch, want.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    for cell, jcell in zip(SHAPE_CELLS, J_CELLS):
        got = input_specs(get_config(arch), cell)
        want = j_input_specs(jax_config(arch), jcell)
        assert list(got) == list(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert _shape_dtype(got[k]) == _shape_dtype(want[k]), (cell.name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    JD = _reference_dryrun()
    for cell, jcell in zip(SHAPE_CELLS, J_CELLS):
        assert D.model_flops(get_config(arch), cell) == JD.model_flops(jax_config(arch), jcell)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_reference(arch):
    """abstract_cache (every decode cell), abstract_train_state and
    abstract_adamw (bf16 and f32 moments): paths, shapes and dtypes."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for cell, jcell in zip(SHAPE_CELLS, J_CELLS):
        if cell.kind == "decode" and cell_applicable(cfg, cell)[0]:
            got = TS.abstract_cache(cfg, cell)
            assert all(x.device.type == "meta" for _, x in flatten_with_paths(got))
            assert _port_leaves(got) == _jax_leaves(_jax_cache(arch, cell.name)), cell.name
    params, state = TS.abstract_train_state(cfg)
    jparams, jstate = _jax_train_state(arch)
    assert _port_leaves(params) == _jax_leaves(jparams)
    assert _port_leaves(state) == _jax_leaves(jstate)
    for mdt in ("float32", "bfloat16"):
        got = TO.abstract_adamw(params, TO.AdamWConfig(moment_dtype=mdt))
        want = JO.abstract_adamw(jparams, JO.AdamWConfig(moment_dtype=mdt))
        assert _port_leaves(got) == _jax_leaves(want)


# ----------------------------------------------------------------------------- per-rank bytes

def _reference_bytes(arch: str, jcell, mesh_name: str) -> int:
    """The sum over the reference's step arguments of each leaf's shard
    bytes under its own specs."""
    cfg, ctx = jax_config(arch), _jax_ctx(mesh_name)
    sizes = dict(zip(MESHES[mesh_name][1], MESHES[mesh_name][0]))
    batch, bshard = JS.train_inputs(cfg, ctx, jcell, j_input_specs(cfg, jcell))
    params, opt = _jax_train_state(arch)
    pspec = JSh.param_specs(cfg, ctx)
    trees = [(params, pspec)]
    if jcell.kind == "train":
        trees.append((opt, JO.AdamWState(step=JSh.P(), m=pspec, v=pspec)))
    elif jcell.kind == "decode":
        total = jcell.seq_len + (cfg.vision_prefix_len if cfg.family == "vlm" else 0)
        trees.append((_jax_cache(arch, jcell.name),
                      JSh.cache_specs(cfg, ctx, jcell.global_batch, total)))
    trees.append((batch, bshard))
    total = 0
    for tree, specs in trees:
        leaves = jax.tree_util.tree_leaves(tree)
        spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JSh.P))
        assert len(leaves) == len(spec_leaves)
        for x, spec in zip(leaves, spec_leaves):
            n = np.dtype(x.dtype).itemsize
            entries = tuple(spec) + (None,) * (len(x.shape) - len(spec))
            for dim, entry in zip(x.shape, entries):
                axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
                split = int(np.prod([sizes[a] for a in axes]))
                assert dim % split == 0
                n *= dim // split
            total += n
    return total


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_store_bytes_match_reference_shard_shapes(arch, mesh_name):
    """Per-rank bytes of the store (params, cache or AdamW state, batch) of
    every applicable cell equal the reference's, as integers."""
    ctx = TS.make_ctx(Mesh(*MESHES[mesh_name], rank=0))
    cfg = get_config(arch)
    for cell, jcell in zip(SHAPE_CELLS, J_CELLS):
        if not cell_applicable(cfg, cell)[0]:
            continue
        _, args = D.build_cell(cfg, cell, ctx)
        got, _ = D.argument_bytes(args)
        assert got == _reference_bytes(arch, jcell, mesh_name), cell.name


# ----------------------------------------------------------------------------- compiled oracle

def hlo_dot_flops(hlo: str) -> int:
    """The FLOPs of every ``dot`` in an HLO module's text: 2 * the output's
    elements * the contracted size, from the operands' shapes."""
    shapes = {m.group(1): [int(x) for x in m.group(2).split(",") if x]
              for m in re.finditer(r"%([\w.\-]+) = \w+\[([\d,]*)\]", hlo)}
    total = 0
    for m in re.finditer(r"%[\w.\-]+ = \w+\[([\d,]*)\]\S* dot\(%([\w.\-]+), %[\w.\-]+\),"
                         r"(?: lhs_batch_dims=\{[\d,]*\},)? lhs_contracting_dims=\{([\d,]*)\}",
                         hlo):
        out = [int(x) for x in m.group(1).split(",") if x]
        lhs = shapes[m.group(2)]
        total += 2 * math.prod(out) * math.prod(lhs[int(d)] for d in m.group(3).split(","))
    return total


_REFERENCE = """
    import json, math, re, sys
    import repro.launch.dryrun as D          # sets XLA_FLAGS before jax starts
    import jax, numpy as np
    from pathlib import Path
    from jax.sharding import Mesh
    import repro.launch.mesh as RM

{dots}

    def production_mesh(*, multi_pod=False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)

    RM.make_production_mesh = production_mesh
    kept, parse = {{}}, D.parse_collective_bytes

    def keep(hlo):                           # run_cell parses the compiled HLO once
        kept["dot_flops"] = hlo_dot_flops(hlo)
        return parse(hlo)

    D.parse_collective_bytes = keep
    out = {{}}
    for arch, cell, mp, depth in {cells}:
        rec = D.run_cell(arch, cell, mp, Path(sys.argv[2]), depth=depth)
        out[f"{{arch}}|{{cell}}|{{mp}}|{{depth}}"] = dict(rec["memory_analysis"],
                                                         flops=rec["hlo_flops_per_dev"],
                                                         dot_flops=kept.pop("dot_flops"))
    Path(sys.argv[1]).write_text(json.dumps(out))
    print("REFERENCE_OK")
"""

_PORT = """
    import json, sys
    from pathlib import Path
    from repro_torch.launch.dryrun import run_cell
    out = {{}}
    for arch, cell, mp, depth in {cells}:
        rec = run_cell(arch, cell, mp, Path(sys.argv[2]), depth=depth)
        out[f"{{arch}}|{{cell}}|{{mp}}|{{depth}}"] = rec
    for cell, mp, whole in {smoke}:
        rec = run_cell("qwen3-30b-a3b", cell, mp, Path(sys.argv[2]) / "smoke", smoke=True,
                       batch_whole=whole)
        out[f"smoke|{{cell}}|{{mp}}|{{whole}}"] = {{k: rec[k] for k in ("flops_per_dev",
                                                                   "batch_whole")}}
    Path(sys.argv[1]).write_text(json.dumps(out))
    print("PORT_OK")
"""

# the smoke qwen3 cells on both production meshes, with batch blocks and
# with the whole batch on every rank
SMOKE_CELLS = [(c.name, mp, whole) for c in dryrun_cells("qwen3-30b-a3b")
               for mp in (False, True) for whole in (False, True)]


def _run(script: str, *args) -> subprocess.Popen:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(ROOT)), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "2"}
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    return subprocess.Popen([sys.executable, "-c", script, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))


@pytest.fixture(scope="module", autouse=True)
def _oracle_runs(tmp_path_factory):
    """The two oracle subprocesses, started with this file's first test so
    that they run beside the others."""
    d = tmp_path_factory.mktemp("dryrun")
    cells = repr(list(ORACLE))
    dots = textwrap.indent(inspect.getsource(hlo_dot_flops), "    ")
    procs = {tag: _run(textwrap.dedent(body.format(cells=cells, smoke=repr(SMOKE_CELLS),
                                                   dots=dots)),
                       str(d / f"{tag}.json"),
                       str(d / tag))
             for tag, body in (("REFERENCE", _REFERENCE), ("PORT", _PORT))}
    yield d, procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def oracle(_oracle_runs):
    d, procs = _oracle_runs
    for tag, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0 and f"{tag}_OK" in stdout, \
            f"{tag}: rc {proc.returncode}\n{stdout[-2000:]}\n{stderr[-4000:]}"
    return {tag: json.loads((d / f"{tag}.json").read_text()) for tag in procs}


def test_wire_bytes_follow_the_reference_ring_formulas():
    """The port's ring formulas against the reference's HLO parser on one
    synthetic instruction of each collective."""
    JD = _reference_dryrun()
    for hlo_op, op in (("all-gather", "all-gather"), ("all-reduce", "all-reduce"),
                       ("reduce-scatter", "reduce-scatter"), ("all-to-all", "all-to-all"),
                       ("collective-permute", "collective-permute")):
        for g in (2, 16, 256):
            line = (f"  %x = bf16[64,128]{{1,0}} {hlo_op}(bf16[64,128]{{1,0}} %y), "
                    f"replica_groups=[{512 // g},{g}]<=[512]")
            want = JD.parse_collective_bytes(line)[op]
            assert D.wire_bytes(op, 64 * 128 * 2, g) == pytest.approx(want, rel=1e-12)


# ----------------------------------------------------------------------------- the fake group

@pytest.fixture
def fake_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_expert_gather_bytes_match_moe_sharded(fake_group):
    """On a (2, 2) fake group, the gathers of the stored experts over
    "data" in one sharded MoE layer output 3 * E_loc * d * f bf16 bytes,
    the amount ``_use_token_gather`` weighs; their wire bytes are half of
    it (a ring of 2)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import param_specs, place
    from repro_torch.models.moe import init_moe
    from repro_torch.models.moe_sharded import moe_apply_sharded
    from repro_torch.models.model import _NoDraw
    cfg = get_smoke_config("qwen3-30b-a3b").replace(dtype="bfloat16")
    mesh = Mesh.over_process_group((2, 2), ("data", "model"))
    ctx = TS.make_ctx(mesh)
    specs = param_specs(cfg, ctx)["blocks"]["moe"]
    p = place(init_moe(_NoDraw(torch.device("meta")), cfg),
              {k: type(v)(*v[1:]) for k, v in specs.items()}, mesh)
    x = torch.empty((4, 8, cfg.d_model), dtype=cfg.adtype, device="meta")
    from repro_torch.distributed.context import gather_tree
    p = gather_tree(p, keep=("w_gate", "w_up", "w_down"))    # the router whole, as _moe has it
    coll = D.CollectiveBytes()
    data = mesh.group("data")
    with coll, torch.no_grad():
        moe_apply_sharded(p, cfg, x, None, ctx)
    e_loc = cfg.num_experts // ctx.tp
    gathers = [(n, w) for op, n, w, g in coll.log
               if op == "all-gather" and g is data and n != x.numel() * x.element_size()]
    assert len(gathers) == 3
    want = 3 * e_loc * cfg.d_model * cfg.moe_d_ff * 2
    assert sum(n for n, _ in gathers) == want
    assert sum(w for _, w in gathers) == want / 2


def test_fake_group_is_refused(fake_group):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    with pytest.raises(RuntimeError, match="fake"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="fake"):
        train("qwen3-30b-a3b", steps=1, batch=2, seq=8, device="cpu")
    with pytest.raises(RuntimeError, match="fake"):
        serve(n=2, device="cpu")


def test_dry_run_refuses_a_real_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="real process group"):
            D.run_cell("mamba2-370m", "decode_32k", False, tmp_path, smoke=True)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("key", list(ORACLE), ids=lambda k: f"{k[0]}-{k[1]}-{'2x16x16' if k[2] else '16x16'}")
def test_dry_run_bytes_equal_compiled_reference(oracle, key):
    """XLA's per-device argument and output bytes (``ORACLE``) equal
    the port's records; mamba2's decode reads no cache_pos, which jit
    prunes and the port's record names."""
    name = "|".join(map(str, key))
    ref, port = oracle["REFERENCE"][name], oracle["PORT"][name]
    want = ORACLE[key]
    assert (ref["argument_size_in_bytes"], ref["output_size_in_bytes"]) == want
    mem = port["memory_analysis"]
    assert (mem["argument_size_in_bytes"], mem["output_size_in_bytes"]) == want
    assert port["unread_arguments"] == ({"[2]['cache_pos']": 4} if key[0] == "mamba2-370m"
                                        else {})
    assert port["n_devices"] == (512 if key[2] else 256)
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"]
    assert port["flops_per_dev"] > 0 and port["collective_bytes_per_dev"] > 0


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("cell", sorted({c for c, _, _ in SMOKE_CELLS}))
def test_batch_blocks_cut_flops_by_the_batch_split(oracle, cell, multi_pod):
    """With the batch stored in blocks over the batch axes, a rank's FLOPs
    for a smoke qwen3 cell are at most 2 / dp of those with the whole batch
    on every rank (``--batch-whole``)."""
    port = oracle["PORT"]
    blocks, whole = (port[f"smoke|{cell}|{multi_pod}|{w}"] for w in (False, True))
    assert (blocks["batch_whole"], whole["batch_whole"]) == (False, True)
    dp = 32 if multi_pod else 16
    assert 0 < blocks["flops_per_dev"] <= 2 / dp * whole["flops_per_dev"]


# (arch, cell, multi-pod, depth) -> the bounds of the port's FLOPs a rank over
# XLA's: the ceiling is the model axis's target (2.0) or the ratio before the
# port computed on its "model" blocks (it must fall below it); the floor is
# 1.0, or 0.5 in the decode cells, where XLA's count holds its other ops:
# ``FlopCounterMode`` counts matrix products only, XLA's cost analysis every
# op (``DOT_FLOORS`` holds the port to XLA's matrix products alone)
FLOP_BOUNDS = {("qwen3-30b-a3b", "decode_32k", False, 4): (0.5, 1.769),
               ("qwen3-30b-a3b", "decode_32k", True, 4): (0.5, 1.454),
               ("qwen3-30b-a3b", "train_4k", False, 4): (1.0, 2.0),
               ("qwen2-72b", "decode_32k", False, 4): (0.5, 2.0),
               ("mamba2-370m", "long_500k", False, 0): (1.0, 22.84)}
# the least ratio of the port's FLOPs a rank to the FLOPs of the ``dot``
# instructions of XLA's compiled program: 1.0, but 0.7 in qwen2-72b's decode,
# whose dots apply ``wo`` to every head of the whole batch (column-parallel
# over d after the sequence-sharded region: 2 * 128 * 512 * 8192 = 1.0737e9
# a layer), 16x the port's row-parallel ``wo`` on its rows; without that
# excess the ratio is 1.15 (PERF.md §6)
DOT_FLOORS = {("qwen3-30b-a3b", "decode_32k", False, 4): 1.0,
              ("qwen3-30b-a3b", "decode_32k", True, 4): 1.0,
              ("qwen3-30b-a3b", "train_4k", False, 4): 1.0,
              ("qwen2-72b", "decode_32k", False, 4): 0.7,
              ("mamba2-370m", "long_500k", False, 0): 1.0}


@pytest.mark.parametrize("key", list(ORACLE), ids=lambda k: f"{k[0]}-{k[1]}-{'2x16x16' if k[2] else '16x16'}")
def test_dry_run_flops_against_compiled_reference(oracle, key, capsys):
    """Per rank, the port's FLOPs against XLA's compiled program for the
    same cell (printed), with the batch in blocks over the batch axes and
    every dense layer on its "model" blocks, within the cell's bounds
    (``FLOP_BOUNDS``)."""
    name = "|".join(map(str, key))
    ref, port = oracle["REFERENCE"][name], oracle["PORT"][name]
    ratio = port["flops_per_dev"] / ref["flops"]
    with capsys.disabled():
        print(f"\n[dryrun flops] {name}: port {port['flops_per_dev']:.4e} XLA {ref['flops']:.4e} "
              f"ratio {ratio:.3f}")
    floor, ceiling = FLOP_BOUNDS[key]
    assert floor <= ratio < ceiling


@pytest.mark.parametrize("key", list(ORACLE), ids=lambda k: f"{k[0]}-{k[1]}-{'2x16x16' if k[2] else '16x16'}")
def test_dry_run_flops_against_compiled_dots(oracle, key, capsys):
    """Per rank, the port's FLOPs (matrix products) against those of the
    ``dot`` instructions of XLA's compiled program for the same cell
    (printed, with the rest of XLA's count), at least ``DOT_FLOORS``."""
    name = "|".join(map(str, key))
    ref, port = oracle["REFERENCE"][name], oracle["PORT"][name]
    ratio = port["flops_per_dev"] / ref["dot_flops"]
    with capsys.disabled():
        print(f"\n[dryrun dots] {name}: port {port['flops_per_dev']:.4e} XLA dots "
              f"{ref['dot_flops']:.4e}, other ops {ref['flops'] - ref['dot_flops']:.4e}, "
              f"ratio {ratio:.3f}")
    assert 0 < ref["dot_flops"] <= ref["flops"]
    assert ratio >= DOT_FLOORS[key]


def test_hlo_dot_flops_counts_compiled_products():
    """``hlo_dot_flops`` on XLA's compiled text of a matrix product and a
    batched one (whose batch dim is not contracted), against 2 * m * n * k."""
    import jax.numpy as jnp

    def f(a, b, x, w):
        return a @ b, jnp.einsum("ecd,edf->ecf", x, w)

    args = (jnp.ones((4, 8)), jnp.ones((8, 16)), jnp.ones((3, 5, 8)), jnp.ones((3, 8, 6)))
    hlo = jax.jit(f).lower(*args).compile().as_text()
    assert hlo_dot_flops(hlo) == 2 * 4 * 16 * 8 + 2 * 3 * 5 * 6 * 8
