"""The port's model layers against the JAX reference on the CPU, on the
qwen3-30b-a3b smoke config in f32 with the reference's own weights bridged
through ``repro_torch.models.convert``.

Tolerance: f32 rtol=atol=2e-4 (tests/test_kernels.py).  Integer stats
(expert ids, counts) and the dropped fraction must be exactly equal.  The
JAX side runs as its own tests run it: Pallas kernels in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serving import kvcache as JKV
from repro.serving.kvcache import PagedKVCache as JaxPagedKVCache
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import kvcache as TKV
from repro_torch.serving.kvcache import PagedKVCache

ARCH = "qwen3-30b-a3b"
TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def cfgs():
    return jax_smoke_config(ARCH), get_smoke_config(ARCH)


@pytest.fixture(scope="module")
def weights(cfgs):
    """The reference's seeded weights, as numpy and as the port's tensors."""
    tree = _np_tree(JM.init_params(jax.random.key(0), cfgs[0]))
    return tree, params_from_numpy(tree, device="cpu")


def test_configs_agree(cfgs):
    import dataclasses
    jc, tc = cfgs
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.adtype == torch.float32 and tc.kv_bytes_per_token() == jc.kv_bytes_per_token()


# --- primitive layers ------------------------------------------------------------

def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(scale), 1e-6), JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    pos = np.stack([np.arange(5), np.arange(7, 12)]).astype(np.int32)
    np.testing.assert_array_equal(TL.rope_freqs(16, 1e6), np.asarray(JL.rope_freqs(16, 1e6)))
    _close(TL.apply_rope(_t(x), _t(pos), 1e6), JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_ffn_and_unembed(softcap):
    rng = np.random.default_rng(1)
    p = {n: (rng.normal(size=s) * 0.3).astype(np.float32)
         for n, s in (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    _close(TL.ffn_apply({k: _t(v) for k, v in p.items()}, _t(x)),
           JL.ffn_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    un = (rng.normal(size=(40, 16)) * 3).astype(np.float32)
    got = TL.unembed_apply({"unembedding": _t(un)}, _t(x), softcap)
    assert got.dtype == torch.float32
    _close(got, JL.unembed_apply({"unembedding": jnp.asarray(un)}, jnp.asarray(x), softcap))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip(cfgs, dtype):
    jc = cfgs[0].replace(dtype=dtype)
    tree = _np_tree(JM.init_params(jax.random.key(3), jc))
    got = params_from_numpy(tree, device="cpu")
    flat_t = jax.tree_util.tree_leaves_with_path(got)
    flat_n = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_t) == len(flat_n)
    for path, t in flat_t:
        a = flat_n[path]
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).endswith(a.dtype.name), (path, t.dtype, a.dtype)
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    cast = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert {t.dtype for t in jax.tree.leaves(cast)} == {torch.bfloat16}


def test_init_params_matches_reference_layout(cfgs, weights):
    """The port's own seeded init has the reference's tree, shapes and dtypes."""
    mine = TM.init_params(cfgs[1], seed=0, device="cpu")
    ref = dict(jax.tree_util.tree_leaves_with_path(weights[0]))
    flat = jax.tree_util.tree_leaves_with_path(mine)
    assert sorted(str(p) for p, _ in flat) == sorted(str(p) for p in ref)
    for path, t in flat:
        assert tuple(t.shape) == ref[path].shape
        assert str(t.dtype).endswith(ref[path].dtype.name)


# --- attention ------------------------------------------------------------------

def _layer0(tree, key):
    return jax.tree.map(lambda a: a[0], tree["blocks"][key])


def test_gqa_full_with_cache(cfgs, weights):
    jc, tc = cfgs
    pj = _layer0(weights[0], "attn")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    cj = {n: jnp.zeros((2, 32, jc.num_kv_heads, jc.head_dim)) for n in ("k", "v")}
    ct = {n: torch.zeros((2, 32, tc.num_kv_heads, tc.head_dim)) for n in ("k", "v")}
    oj, ncj = JA.gqa_full(pj, jc, jnp.asarray(x), jnp.asarray(pos), False, cj)
    ot, nct = TA.gqa_full({k: _t(v) for k, v in pj.items()}, tc, _t(x), _t(pos), False, ct)
    _close(ot, oj)
    for n in ("k", "v"):
        _close(nct[n], ncj[n])


def test_sdpa_chunked_matches_materialized(cfgs):
    """The chunked prefill path (taken above CHUNK_THRESHOLD) is the same
    attention, in both packages."""
    jc, tc = cfgs
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 64, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 64, 2, 16)).astype(np.float32)
    got = TA._sdpa_chunked(tc, _t(q), _t(k), _t(v), 0, q_chunk=16)
    _close(got, JA._sdpa_chunked(jc, *map(jnp.asarray, (q, k, v)), 0, q_chunk=16))
    _close(got, TA._sdpa_auto(tc, _t(q), _t(k), _t(v), 0))


def _quant_pages(pages: np.ndarray):
    from repro.training.compression import quantize_int8
    P = pages.shape[0]
    q, s = jax.vmap(quantize_int8)(jnp.asarray(pages).reshape(P, -1))
    return np.array(q).reshape(pages.shape), np.array(s).reshape(P)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_gqa_decode_paged(cfgs, weights, quant, use_kernel):
    jc, tc = cfgs
    pj = _layer0(weights[0], "attn")
    rng = np.random.default_rng(5)
    b, bs, nb = 3, 16, 3
    pool = b * nb + 1
    shape = (pool, bs, jc.num_kv_heads, jc.head_dim)
    pages = {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    if quant:
        for n in ("k", "v"):
            pages[n], pages[n + "_scale"] = _quant_pages(pages[n])
    tables = (rng.permutation(pool - 1)[:b * nb] + 1).reshape(b, nb).astype(np.int32)
    tables[1] = 0                                   # an inactive row: garbage page
    lengths = np.array([17, 0, 40], np.int32)
    x = rng.normal(size=(b, 1, jc.d_model)).astype(np.float32)
    oj, cj = JA.gqa_decode_paged(pj, jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pages.items()},
                                 jnp.asarray(tables), jnp.asarray(lengths), False, use_kernel)
    ct = {k: _t(v) for k, v in pages.items()}
    ot, ct = TA.gqa_decode_paged({k: _t(v) for k, v in pj.items()}, tc, _t(x), ct,
                                 _t(tables), _t(lengths), False, use_kernel)
    live = [0, 2]
    _close(ot[live], np.asarray(oj)[live])
    written = tables[live, lengths[live] // bs]
    for n in ("k", "v"):
        got, want = _np(ct[n])[written], np.asarray(cj[n])[written]
        if quant:   # a rounding step apart at most, where the new token's f32 value differs
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
            _close(ct[n + "_scale"][written], np.asarray(cj[n + "_scale"])[written], rtol=1e-5, atol=0)
        else:
            _close(got, want)


@pytest.mark.parametrize("pos", [[5, 0, 63], [17, 40, 1]])
def test_gqa_decode_slot(cfgs, weights, pos):
    """One-token decode against a contiguous slot cache: the output, and the
    new K/V written at each row's position (the last position included)."""
    jc, tc = cfgs
    pj = _layer0(weights[0], "attn")
    rng = np.random.default_rng(9)
    shape = (3, 64, jc.num_kv_heads, jc.head_dim)
    cache = {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    x = rng.normal(size=(3, 1, jc.d_model)).astype(np.float32)
    cache_pos = np.array(pos, np.int32)
    oj, cj = JA.gqa_decode(pj, jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
                           jnp.asarray(cache_pos), False)
    ct = {k: _t(v) for k, v in cache.items()}
    ot, ct2 = TA.gqa_decode({k: _t(v) for k, v in pj.items()}, tc, _t(x), ct,
                            _t(cache_pos), False)
    assert ct2 is ct                                  # written in place
    _close(ot, oj)
    for n in ("k", "v"):
        _close(ct[n], cj[n])


# --- MoE ------------------------------------------------------------------------------

def _moe_case(cfgs, weights, inv):
    jc, tc = cfgs
    pj = _layer0(weights[0], "moe")
    if inv is not None:                       # weights in slot order, as apply_placement lays them
        pj = dict(pj, **{n: pj[n][inv] for n in ("w_gate", "w_up", "w_down")})
    return pj, {k: _t(v) for k, v in pj.items()}


@pytest.mark.parametrize("mode", ["dense", "gather", "fused"])
@pytest.mark.parametrize("replicated", [False, True])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.1])
def test_moe_apply(cfgs, weights, mode, replicated, capacity_factor):
    jc, tc = (c.replace(capacity_factor=capacity_factor) for c in cfgs)
    e = jc.num_experts
    inv = np.array([0, 1, 2, 3, 4, 5, 6, 7, 1, 5], np.int32) if replicated else None
    pj, pt = _moe_case(cfgs, weights, inv)
    plc_j = JMoE.ExpertPlacement.from_slot_map(inv, e) if replicated else None
    plc_t = TMoE.ExpertPlacement.from_slot_map(inv, e) if replicated else None
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 32, jc.d_model)).astype(np.float32)
    yj, aj = JMoE.moe_apply(pj, jc, jnp.asarray(x), plc_j, mode, return_stats=True)
    yt, at = TMoE.moe_apply(pt, tc, _t(x), plc_t, mode, return_stats=True)
    _close(yt, yj)
    for k in ("load_balance_loss", "router_z_loss"):
        _close(at[k], aj[k])
    for k in ("expert_ids", "expert_counts"):
        np.testing.assert_array_equal(_np(at[k]), np.asarray(aj[k]))
    assert float(at["dropped_frac"]) == float(aj["dropped_frac"])
    if capacity_factor < 1:
        assert float(at["dropped_frac"]) > 0          # the drop path was exercised


def test_dispatch_slots_and_permute(cfgs, weights):
    e = cfgs[0].num_experts
    inv = np.array([3, 0, 1, 2, 7, 4, 5, 6, 3, 3], np.int32)
    pj, pt = JMoE.ExpertPlacement.from_slot_map(inv, e), TMoE.ExpertPlacement.from_slot_map(inv, e)
    ids = np.random.default_rng(7).integers(0, e, (20, 2)).astype(np.int32)
    np.testing.assert_array_equal(pt.dispatch_slots(_t(ids)).numpy(),
                                  np.asarray(pj.dispatch_slots(jnp.asarray(ids))))
    moe_j = _layer0(weights[0], "moe")
    old_j, old_t = JMoE.ExpertPlacement.identity(e), TMoE.ExpertPlacement.identity(e)
    got = TMoE.permute_expert_weights({k: _t(v) for k, v in moe_j.items()}, old_t, pt)
    want = JMoE.permute_expert_weights(moe_j, old_j, pj)
    for n in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    perm = np.array([2, 0, 1, 3, 5, 4, 7, 6])
    for a, b_ in zip(TMoE.ExpertPlacement.from_perm(perm), JMoE.ExpertPlacement.from_perm(perm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


# --- whole model: prefill, then paged decode ---------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_prefill_and_two_paged_decode_steps(cfgs, weights, quant):
    """Prefill two prompts (logits and caches), write them into both
    packages' paged caches, then two fused-MoE, kernel-path decode steps:
    logits and the new pages agree."""
    jc, tc = cfgs
    tree, pt = weights
    rng = np.random.default_rng(8)
    kvj = JaxPagedKVCache(jc, 2, 64, block_size=16, quantize=quant)
    kvt = PagedKVCache(tc, 2, 64, block_size=16, quantize=quant, device="cpu")
    last = []
    for plen in (21, 32):
        toks = rng.integers(0, jc.vocab_size, (1, 32)).astype(np.int32)
        lj, cj, _ = JM.prefill(tree, jc, jnp.asarray(toks), JM.init_cache(jc, 1, 64),
                               dispatch_mode="fused")
        lt, ct, _ = TM.prefill(pt, tc, _t(toks).long(), TM.init_cache(tc, 1, 64, device="cpu"),
                               dispatch_mode="fused")
        _close(lt, lj)
        for n in ("k", "v"):
            _close(ct["layers"][n], cj["layers"][n])
        sj, st = kvj.alloc(plen), kvt.alloc(plen)
        assert sj == st
        kvj.write_prefill(sj, cj)
        kvt.write_prefill(st, ct)
        kvj.slot_len[sj] = kvt.slot_len[st] = plen
        last.append(int(np.argmax(np.asarray(lj)[0, plen - 1])))
    tokens = np.array(last, np.int32)[:, None]
    for _ in range(2):
        for s in (0, 1):
            kvj.prepare_append(s)
            kvt.prepare_append(s)
        np.testing.assert_array_equal(kvt.block_tables, kvj.block_tables)
        lj, kvj.pages, aj = JM.decode_step_paged(
            tree, jc, jnp.asarray(tokens), kvj.pages, kvj.device_tables(), kvj.positions(),
            dispatch_mode="fused", stats=True, use_kernel=True)
        lt, _, at = TM.decode_step_paged(
            pt, tc, _t(tokens).long(), kvt.pages, kvt.device_tables(), kvt.positions(),
            dispatch_mode="fused", stats=True, use_kernel=True)
        _close(lt, lj)
        np.testing.assert_array_equal(_np(at["expert_ids"]), np.asarray(aj["expert_ids"]))
        for n, page in kvt.pages.items():
            want = np.asarray(kvj.pages[n])
            if page.dtype == torch.int8:
                assert np.abs(page.numpy().astype(np.int32) - want.astype(np.int32)).max() <= 1
            else:
                _close(page, want, rtol=1e-5 if n.endswith("scale") else 2e-4,
                       atol=0 if n.endswith("scale") else 2e-4)
        kvj.slot_len += 1
        kvt.slot_len += 1
        tokens = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]


@pytest.mark.parametrize("quant", [False, True])
def test_paged_cache_usage_matches_reference(cfgs, quant):
    """``num_free``, ``usage()`` and ``kv_bytes_used()`` of the paged cache
    equal the reference's through an alloc, a shared-prefix alloc, appends
    across a page boundary and frees."""
    jc, tc = cfgs
    kvj = JaxPagedKVCache(jc, 3, 64, block_size=16, quantize=quant)
    kvt = PagedKVCache(tc, 3, 64, block_size=16, quantize=quant, device="cpu")
    prompt = list(range(1, 41))

    def same():
        assert kvt.num_free == kvj.num_free
        assert kvt.usage() == kvj.usage()
        assert kvt.kv_bytes_used() == kvj.kv_bytes_used()

    same()
    slots = []
    for plen, toks in ((40, prompt), (36, prompt[:32] + [99, 98, 97, 96]), (17, None)):
        sj, st = kvj.alloc(plen, toks), kvt.alloc(plen, toks)
        assert sj == st
        kvj.slot_len[sj] = kvt.slot_len[st] = plen
        slots.append(st)
        same()
    assert kvt.shared_hits == kvj.shared_hits > 0
    for _ in range(16):                                 # slot 2 crosses into a new page
        for s in slots:
            kvj.prepare_append(s)
            kvt.prepare_append(s)
        kvj.slot_len[slots] += 1
        kvt.slot_len[slots] += 1
        same()
    for s in slots:
        kvj.free(s)
        kvt.free(s)
        same()
    assert kvt.kv_bytes_used() == 0 and kvt.num_free == 3


# --- whole model: slot cache and slot decode ----------------------------------------------

def test_batch_axes_and_write_slot_match_reference(cfgs):
    jc, tc = cfgs
    assert TKV.batch_axes(tc, 4, 64) == JKV.batch_axes(jc, 4, 64)
    with pytest.raises(ValueError, match="max_slots"):
        TKV.batch_axes(tc, 1, 64)
    rng = np.random.default_rng(10)
    big = {"layers": {n: rng.normal(size=(jc.num_layers, 4, 64, jc.num_kv_heads,
                                          jc.head_dim)).astype(np.float32) for n in ("k", "v")}}
    one = {"layers": {n: rng.normal(size=(jc.num_layers, 1, 32, jc.num_kv_heads,
                                          jc.head_dim)).astype(np.float32) for n in ("k", "v")}}
    for axes in (TKV.batch_axes(tc, 4, 64), 1):
        bt = jax.tree.map(_t, big)
        got = TKV.write_slot(bt, jax.tree.map(_t, one), 2, axes)
        want = JKV.write_slot(jax.tree.map(jnp.asarray, big), jax.tree.map(jnp.asarray, one), 2,
                              JKV.batch_axes(jc, 4, 64) if axes != 1 else 1)
        assert got["layers"]["k"] is bt["layers"]["k"]         # written in place
        for n in ("k", "v"):
            np.testing.assert_array_equal(got["layers"][n].numpy(), np.asarray(want["layers"][n]))


def test_slot_kv_cache_and_block_ledger_match_reference(cfgs):
    jc, tc = cfgs
    kj, kt = JKV.SlotKVCache(jc, 4, 32), TKV.SlotKVCache(tc, 4, 32, device="cpu")
    assert kt.cache["layers"]["k"].shape == kj.cache["layers"]["k"].shape
    ops = [("alloc",), ("alloc",), ("alloc",), ("len", 1, 20), ("free", 0), ("alloc",),
           ("len", 0, 31), ("free", 2), ("free", 2), ("alloc",), ("alloc",), ("alloc",)]
    for op in ops:
        if op[0] == "alloc":
            assert kt.alloc() == kj.alloc()          # lowest free slot first, None when full
        elif op[0] == "free":
            kt.free(op[1])
            kj.free(op[1])
        else:
            kt.slot_len[op[1]] = kj.slot_len[op[1]] = op[2]
        assert kt.num_free == kj.num_free
        assert kt.usage() == kj.usage() and kt.kv_bytes_used() == kj.kv_bytes_used()
        np.testing.assert_array_equal(kt.positions().numpy(), np.asarray(kj.positions()))
    lj, lt = JKV.BlockLedger(10, 4), TKV.BlockLedger(10, 4)
    for op, *a in [("alloc", 1, 9), ("extend", 1, 12), ("can", 20), ("alloc", 2, 30),
                   ("alloc", 2, 20), ("extend", 2, 29), ("release", 1), ("extend", 2, 29),
                   ("can", 1), ("release", 7)]:
        if op == "can":
            assert lt.can_alloc(*a) == lj.can_alloc(*a)
        elif op == "release":
            lt.release(*a)
            lj.release(*a)
        else:
            assert getattr(lt, op)(*a) == getattr(lj, op)(*a)
        assert (lt.used_blocks, lt.usage, lt.seq_blocks) == (lj.used_blocks, lj.usage, lj.seq_blocks)


@pytest.mark.parametrize("mode,replicated", [("dense", False), ("gather", True), ("fused", True)])
def test_prefill_and_two_slot_decode_steps(cfgs, weights, mode, replicated):
    """Prefill two prompts into both packages' slot caches, then two decode
    steps of ``decode_step`` over all four rows (two free), under an
    identity or a replicated placement with the weights laid out for it:
    logits, stats and the caches agree."""
    jc, tc = cfgs
    tree, pt = weights
    inv = np.array([0, 1, 2, 3, 4, 5, 6, 7, 1, 5], np.int32)
    placements = np.broadcast_to(inv, (jc.num_layers, len(inv))).copy() if replicated else None
    if replicated:
        moe = dict(tree["blocks"]["moe"], **{n: tree["blocks"]["moe"][n][:, inv]
                                            for n in ("w_gate", "w_up", "w_down")})
        tree = dict(tree, blocks=dict(tree["blocks"], moe=moe))
        pt = dict(pt, blocks=dict(pt["blocks"], moe={k: _t(v) for k, v in moe.items()}))
    rng = np.random.default_rng(11)
    kvj, kvt = JKV.SlotKVCache(jc, 4, 64), TKV.SlotKVCache(tc, 4, 64, device="cpu")
    tokens = np.zeros((4, 1), np.int32)
    for plen in (21, 32):
        toks = rng.integers(0, jc.vocab_size, (1, 32)).astype(np.int32)
        lj, cj, _ = JM.prefill(tree, jc, jnp.asarray(toks), JM.init_cache(jc, 1, 64),
                               placements=placements, dispatch_mode=mode)
        lt, ct, _ = TM.prefill(pt, tc, _t(toks).long(), TM.init_cache(tc, 1, 32, device="cpu"),
                               placements=placements, dispatch_mode=mode)
        _close(lt, lj)
        sj, st = kvj.alloc(), kvt.alloc()
        assert sj == st
        kvj.cache = JKV.write_slot(kvj.cache, cj, sj, kvj.write_axes)
        TKV.write_slot(kvt.cache, ct, st, kvt.write_axes)
        kvj.slot_len[sj] = kvt.slot_len[st] = plen
        tokens[st, 0] = int(np.argmax(np.asarray(lj)[0, plen - 1]))
    for _ in range(2):
        lj, kvj.cache, aj = JM.decode_step(tree, jc, jnp.asarray(tokens), kvj.cache,
                                           kvj.positions(), placements=placements,
                                           dispatch_mode=mode, stats=True)
        lt, _, at = TM.decode_step(pt, tc, _t(tokens).long(), kvt.cache, kvt.positions(),
                                   placements=placements, dispatch_mode=mode, stats=True)
        _close(lt, lj)
        np.testing.assert_array_equal(_np(at["expert_ids"]), np.asarray(aj["expert_ids"]))
        np.testing.assert_array_equal(_np(at["expert_counts"]), np.asarray(aj["expert_counts"]))
        for n in ("k", "v"):      # resident positions; the rest is never read before written
            for row in (0, 1):
                live = int(kvt.slot_len[row]) + 1
                _close(kvt.cache["layers"][n][:, row, :live],
                       np.asarray(kvj.cache["layers"][n])[:, row, :live])
        kvj.slot_len[:2] += 1
        kvt.slot_len[:2] += 1
        tokens = np.asarray(jnp.argmax(lj, -1), np.int32)[:, None]
