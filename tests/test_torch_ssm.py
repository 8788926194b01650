"""The port's SSM and hybrid families against the JAX reference on the CPU,
at their smoke configs in f32 with the reference's own weights bridged
through ``repro_torch.models.convert``:

* mamba2: a pure stack of Mamba2 (SSD) blocks, no attention;
* zamba2: super-blocks of one shared attention block (one set of weights,
  a KV cache per call) and ``shared_attn_every`` Mamba2 blocks, then the
  leftover Mamba2 blocks (the smoke config: 2 super-blocks of 2, and 1).

The SSD scan (ragged lengths, a carried-in state), the Mamba2 mixer's
prefill and its recurrent decode over several steps, both blocks, the
parameter and cache trees with their batch axes, prefill + greedy decode,
``Engine`` runs on the slot layout (``usage()`` is state-slot occupancy for
mamba2, resident tokens for zamba2), the paged layout's rejection, the
prompt bucket's pad tokens reaching the SSM state (the reference's
behaviour, kept) and a two-engine ``Cluster`` must match the reference.
Tolerance: f32 rtol=atol=2e-4 (tests/test_kernels.py); a bf16 state, which
both sides round once a step, within one bf16 rounding step (1e-2);
greedy tokens, event logs, lifecycles and assignment logs identical.
Prefills are at least 3 tokens long: below K-1 = 3 the reference's conv
tail is shorter than the cache's window.  Kernel 4 at zamba2's
shared-attention shape (head dim 64, group 1) and chip_smoke.py's SSM
gates, with the faults they must reject, are checked here on their plain
versions.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.types import GimbalConfig as JaxGimbalConfig
from repro.core.types import Request as JaxRequest
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.models import blocks as JB
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro.serving import kvcache as JKV
from repro.serving.cluster import Cluster as JaxCluster
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.types import GimbalConfig, Request
from repro_torch.kernels import ref
from repro_torch.kernels.flash_decode import CHUNK, split_plan
from repro_torch.models import blocks as TB
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import kvcache as TKV
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.engine import Engine

MAMBA2, ZAMBA2 = "mamba2-370m", "zamba2-1.2b"
ARCHS = (MAMBA2, ZAMBA2)
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
MAX_SEQ = 64
PROMPTS = (12, 19)
STEPS = 6

_J_PREFILL = jax.jit(JM.prefill, static_argnums=(1,))
_J_DECODE = jax.jit(JM.decode_step, static_argnums=(1,))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype.kind == "f" else np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(tree)}


_MODELS = {}


def _model(arch):
    """(reference config, port config, numpy weights, port weights)."""
    if arch not in _MODELS:
        jc, tc = jax_smoke_config(arch), get_smoke_config(arch)
        tree = jax.tree.map(np.array, JM.init_params(jax.random.key(0), jc))
        _MODELS[arch] = (jc, tc, tree, params_from_numpy(tree, device="cpu"))
    return _MODELS[arch]


def _mixer():
    """mamba2's layer-0 Mamba2 weights: (reference config, port config,
    numpy, port)."""
    jc, tc, tree, pt = _model(MAMBA2)
    return (jc, tc, jax.tree.map(lambda a: a[0], tree["blocks"]["mamba"]),
            TM._layer(pt["blocks"]["mamba"], 0))


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# --- module 1: the SSD scan and the mixer --------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("length", [3, 8, 13, 40])
def test_ssd_chunked_matches_reference(length, with_state):
    """Chunk 8: one partial chunk (3), one whole (8), a ragged tail (13) and
    five chunks (40), with and without a carried-in state."""
    rng = np.random.default_rng(length)
    b, h, p, n = 2, 3, 4, 5
    x, B_, C = _rand(rng, b, length, h, p), _rand(rng, b, length, n), _rand(rng, b, length, n)
    dt = np.log1p(np.exp(_rand(rng, b, length, h))).astype(np.float32)
    A = -np.exp(_rand(rng, h, scale=0.5))
    s0 = _rand(rng, b, h, p, n) if with_state else None
    yj, fj = JM2.ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C)), 8,
                             None if s0 is None else jnp.asarray(s0))
    yt, ft = TM2.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B_, C)), 8,
                             None if s0 is None else torch.from_numpy(s0))
    assert tuple(yt.shape) == (b, length, h, p) and tuple(ft.shape) == (b, h, p, n)
    _close(yt, yj)
    _close(ft, fj)


def _prefill_mixer(jc, tc, pj, pt, u, dtype):
    cj = JM2.init_mamba2_cache(jc, u.shape[0], dtype)
    ct = TM2.init_mamba2_cache(tc, u.shape[0], getattr(torch, dtype.__name__), "cpu")
    oj, cj = JM2.mamba2_full(pj, jc, jnp.asarray(u), cj)
    ot, ct = TM2.mamba2_full(pt, tc, torch.from_numpy(u), ct)
    return (oj, cj), (ot, ct)


@pytest.mark.parametrize("length", [3, 13, 40])
def test_mamba2_full_matches_reference(length):
    """The mixer's prefill: output, final state and the conv tail (the last
    K-1 pre-conv xBC inputs) written into the given cache."""
    jc, tc, pj, pt = _mixer()
    u = _rand(np.random.default_rng(length), 2, length, jc.d_model)
    (oj, cj), (ot, ct) = _prefill_mixer(jc, tc, pj, pt, u, jnp.float32)
    _close(ot, oj)
    _close(ct["ssm"], cj["ssm"])
    _close(ct["conv"], cj["conv"])
    assert tuple(ct["conv"].shape) == (2, jc.ssm_conv - 1, jc.ssm_d_inner + 2 * jc.ssm_state)
    out_only, none = TM2.mamba2_full(pt, tc, torch.from_numpy(u))
    assert none is None and torch.equal(out_only, ot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_reference(dtype):
    """STEPS recurrent steps from a prefilled state, the cache advanced in
    place: each step's output and both cache leaves match, so a step that
    did not write its state back would fail from the second step.  A bf16
    cache rounds the state once a step on both sides."""
    jc, tc, pj, pt = _mixer()
    rng = np.random.default_rng(4)
    tol = TOL if dtype == "float32" else BF16_TOL
    (_, cj), (_, ct) = _prefill_mixer(jc, tc, pj, pt, _rand(rng, 2, 11, jc.d_model),
                                      getattr(jnp, dtype))
    ssm_view = ct["ssm"]
    for _ in range(STEPS):
        u = _rand(rng, 2, 1, jc.d_model)
        oj, cj = JM2.mamba2_decode(pj, jc, jnp.asarray(u), cj)
        ot, same = TM2.mamba2_decode(pt, tc, torch.from_numpy(u), ct)
        assert same is ct and ct["ssm"] is ssm_view
        assert ct["ssm"].dtype == getattr(torch, dtype)
        _close(ot, oj, tol)
        _close(ct["ssm"], cj["ssm"], tol)
        _close(ct["conv"], cj["conv"], tol)


def test_mamba_blocks_match_reference():
    """Both mamba blocks (pre-norm, mixer, residual): prefill, then STEPS
    decode steps."""
    jc, tc, tree, pt = _model(MAMBA2)
    bj, bt = jax.tree.map(lambda a: a[1], tree["blocks"]), TM._layer(pt["blocks"], 1)
    rng = np.random.default_rng(9)
    x = _rand(rng, 2, 17, jc.d_model)
    cj = JM2.init_mamba2_cache(jc, 2)
    ct = TM2.init_mamba2_cache(tc, 2, device="cpu")
    yj, cj = JB.mamba_block_full(bj, jc, jnp.asarray(x), cj)
    yt, _ = TB.mamba_block_full(bt, tc, torch.from_numpy(x), ct)
    _close(yt, yj)
    for _ in range(STEPS):
        x = _rand(rng, 2, 1, jc.d_model)
        yj, cj = JB.mamba_block_decode(bj, jc, jnp.asarray(x), cj)
        yt, _ = TB.mamba_block_decode(bt, tc, torch.from_numpy(x), ct)
        _close(yt, yj)
    _close(ct["ssm"], cj["ssm"])


# --- trees -----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_configs_match_reference(arch):
    jc, tc = jax_smoke_config(arch), get_smoke_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.num_attention_layers() == jc.num_attention_layers() == \
        (0 if arch == MAMBA2 else 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_layout(arch):
    """The port's seeded init has the reference's tree (one shared
    attention tree, (n_super, k) mamba stacks and the epilogue for zamba2),
    shapes and dtypes; the deterministic leaves equal the reference's
    (A_log = log(linspace(1, 16, H)) to within a few f32 ulps: the two
    packages' logarithms round differently)."""
    jc, tc, tree, _ = _model(arch)
    mine = TM.init_params(tc, seed=0, device="cpu")
    ref, got = _leaves(tree), _leaves(mine)
    assert sorted(got) == sorted(ref)
    for path, t in got.items():
        assert tuple(t.shape) == ref[path].shape and t.dtype == torch.float32, path
        if path.endswith(("['D']", "['dt_bias']", "['norm']", "['conv_b']", "['scale']")):
            np.testing.assert_array_equal(t.numpy(), ref[path], err_msg=path)
        if path.endswith("['A_log']"):
            np.testing.assert_allclose(t.numpy(), ref[path], rtol=1e-6, atol=0, err_msg=path)
    if arch == ZAMBA2:
        assert sorted(mine) == ["blocks", "embed", "epi_blocks", "final_norm", "shared_attn"]
        assert mine["blocks"]["mamba"]["w_in"].shape[:2] == (2, 2)
        assert mine["epi_blocks"]["mamba"]["w_in"].shape[0] == 1
        assert "ffn" in mine["shared_attn"] and "ffn" not in mine["blocks"]


def _cache_cfgs():
    return [(MAMBA2, {}), (ZAMBA2, {}), (ZAMBA2, {"num_layers": 4})]


@pytest.mark.parametrize("arch,change", _cache_cfgs())
def test_cache_trees_and_batch_axes_match_reference(arch, change):
    """``init_cache`` / ``cache_shapes`` give the reference's tree in the
    config's dtype, and ``batch_axes`` finds the reference's axes: 2 for
    ``super_mamba``, 1 for ``super_attn``, ``epi`` and the pure SSM's
    layers.  zamba2 at 4 layers has no epilogue, so no ``epi`` leaf."""
    jc, tc = jax_smoke_config(arch).replace(**change), get_smoke_config(arch).replace(**change)
    ref = {p: a.shape for p, a in _leaves(JM.init_cache(jc, 3, MAX_SEQ)).items()}
    cache = TM.init_cache(tc, 3, MAX_SEQ, device="cpu")
    got = {p: tuple(t.shape) for p, t in _leaves(cache).items()}
    assert got == ref
    assert all(t.dtype == torch.float32 for t in _leaves(cache).values())
    axes = _leaves(TKV.batch_axes(tc, 4, MAX_SEQ))
    assert axes == {p: int(v) for p, v in _leaves(JKV.batch_axes(jc, 4, MAX_SEQ)).items()}
    assert ("epi" in cache) == (change == {} and arch == ZAMBA2)
    for path, ax in axes.items():
        assert ax == (2 if "super_mamba" in path else 1), path
    assert TM.init_cache(tc.replace(dtype="bfloat16"), 2, 8,
                         device="cpu")[("layers" if arch == MAMBA2 else "super_mamba")][
        "ssm"].dtype == torch.bfloat16


# --- prefill and slot decode -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    """Two rows prefilled into slot caches (two free), then STEPS greedy
    decode steps of all rows: logits within 2e-4, identical tokens, equal
    caches at the end (every SSM state, conv window and shared-attention
    KV cache)."""
    jc, tc, tree, pt = _model(arch)
    kvj, kvt = JKV.SlotKVCache(jc, 4, MAX_SEQ), TKV.SlotKVCache(tc, 4, MAX_SEQ, device="cpu")
    rng = np.random.default_rng(7)
    tokens = np.zeros((4, 1), np.int32)
    for row, plen in enumerate(PROMPTS):
        toks = rng.integers(0, jc.vocab_size, (1, plen)).astype(np.int32)
        lj, cj, _ = _J_PREFILL(tree, jc, jnp.asarray(toks), JM.init_cache(jc, 1, MAX_SEQ))
        lt, ct, _ = TM.prefill(pt, tc, torch.from_numpy(toks).long(),
                               TM.init_cache(tc, 1, MAX_SEQ, device="cpu"))
        assert tuple(lt.shape) == (1, plen, jc.vocab_size)
        _close(lt, lj)
        assert kvj.alloc() == kvt.alloc() == row
        kvj.cache = JKV.write_slot(kvj.cache, cj, row, kvj.write_axes)
        TKV.write_slot(kvt.cache, ct, row, kvt.write_axes)
        kvj.slot_len[row] = kvt.slot_len[row] = plen
        tokens[row, 0] = int(np.argmax(np.asarray(lj)[0, plen - 1]))
    for _ in range(STEPS):
        lj, kvj.cache, _ = _J_DECODE(tree, jc, jnp.asarray(tokens), kvj.cache, kvj.positions())
        lt, _, _ = TM.decode_step(pt, tc, torch.tensor(tokens).long(), kvt.cache,
                                  kvt.positions())
        _close(lt, lj)
        nj = np.asarray(jnp.argmax(lj, -1), np.int32)
        np.testing.assert_array_equal(torch.argmax(lt, -1).numpy(), nj)
        kvj.slot_len[:2] += 1
        kvt.slot_len[:2] += 1
        tokens = nj[:, None]
    ref = _leaves(kvj.cache)
    for path, t in _leaves(kvt.cache).items():
        _close(t, ref[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_bucket_padding_reaches_the_state_in_both_packages(arch):
    """The engines pad a prompt with token 0 up to its power-of-two bucket
    and prefill the padded row (``serving/backend.py``, both packages).
    Attention masks the pad positions at decode; an SSM carries its state
    and conv tail through them.  A 5-token prompt padded to 16: the prefill
    logits at position 4 equal the unpadded prefill's, the first decode
    step's do not, and the two packages agree on both decodes."""
    jc, tc, tree, pt = _model(arch)
    toks = np.random.default_rng(11).integers(1, jc.vocab_size, 5).astype(np.int32)
    padded = np.zeros(16, np.int32)
    padded[:5] = toks
    out = {}
    for name, row in (("padded", padded), ("unpadded", toks)):
        lj, cj, _ = _J_PREFILL(tree, jc, jnp.asarray(row)[None], JM.init_cache(jc, 1, MAX_SEQ))
        ct = TM.init_cache(tc, 1, MAX_SEQ, device="cpu")
        lt, ct, _ = TM.prefill(pt, tc, torch.from_numpy(row).long()[None], ct)
        _close(lt[0, 4], np.asarray(lj)[0, 4])
        nxt = np.asarray([[int(np.argmax(np.asarray(lj)[0, 4]))]], np.int32)
        pos = np.asarray([5], np.int32)
        dj, _, _ = _J_DECODE(tree, jc, jnp.asarray(nxt), cj, jnp.asarray(pos))
        dt_, _, _ = TM.decode_step(pt, tc, torch.from_numpy(nxt).long(), ct,
                                   torch.from_numpy(pos))
        _close(dt_, dj)
        out[name] = (_np(lt[0, 4]), _np(dt_), np.asarray(dj))
    (p4, dp, djp), (u4, du, dju) = out["padded"], out["unpadded"]
    _close(p4, u4)
    assert np.abs(dp - du).max() > 0.1 and np.abs(djp - dju).max() > 0.1


# --- the paged layout ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_paged_layout_rejects_ssm_and_hybrid_like_reference(arch):
    jc, tc, _, pt = _model(arch)
    with pytest.raises(ValueError) as ej:
        JKV.PagedKVCache(jc, 4, MAX_SEQ, block_size=16)
    with pytest.raises(ValueError) as et:
        TKV.PagedKVCache(tc, 4, MAX_SEQ, block_size=16, device="cpu")
    assert str(et.value) == str(ej.value) == "PagedKVCache supports homogeneous GQA stacks only"
    with pytest.raises(ValueError, match="PagedKVCache"):
        TM.decode_step_paged(pt, tc, torch.zeros((2, 1), dtype=torch.long), {},
                             torch.zeros((2, 1), dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="PagedKVCache"):
        Engine(0, tc, pt, kv_layout="paged", max_slots=2, max_seq=MAX_SEQ, device="cpu")


# --- engines and a cluster ------------------------------------------------------------------

def _trace(n=10, seed=41, n_users=2):
    """Per-user shared 16-token prefixes plus private suffixes, 4-9 new
    tokens each, arriving ~25 a second."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 128, 16) for _ in range(n_users)]
    out, t = [], 0.0
    for i in range(n):
        toks = np.concatenate([prefixes[i % n_users],
                               rng.integers(0, 128, int(rng.integers(0, 16)))])
        out.append((i, toks, int(rng.integers(4, 10)), t))
        t += float(rng.exponential(0.04))
    return out


def _requests(trace, request_cls):
    return [request_cls(i, len(toks), m, a, prompt_tokens=toks, user_id=f"u{i % 2}")
            for i, toks, m, a in trace]


def _record_tokens(engine, tokens):
    orig = engine.backend.decode

    def record(active, now):
        out = orig(active, now)
        for slot, r in active:
            tokens.setdefault(r.req_id, []).append(int(engine.backend.slot_last_token[slot]))
        return out

    engine.backend.decode = record
    return engine


def _drive(engine, trace, request_cls, n_steps=300, dt=0.05):
    """Run the engine on the logical clock; returns (finished, tokens,
    usage after each step, occupied-slot fraction after each step)."""
    reqs = _requests(trace, request_cls)
    tokens, usage, occupied = {}, [], []
    _record_tokens(engine, tokens)
    kv = engine.backend.kv
    i, t, done = 0, 0.0, []
    for _ in range(n_steps):
        while i < len(reqs) and reqs[i].arrival_time <= t:
            engine.submit(reqs[i], t)
            i += 1
        done += engine.step(t)
        usage.append(kv.usage())
        occupied.append(1.0 - kv.num_free / kv.max_slots)
        t += dt
        if i == len(reqs) and len(done) == len(reqs):
            break
    return done, tokens, usage, occupied


_JAX_JITS = {}


def _share_jits(engine):
    """Give a reference engine the compiled functions of the first engine of
    its config, so the file compiles each model once."""
    b = engine.backend
    first = _JAX_JITS.setdefault(b.cfg.name, b)
    b._jit_decode = first._jit_decode
    b._prefill_for_bucket = first._prefill_for_bucket
    return engine


ENGINE_KW = dict(variant="gimbal", max_slots=4, max_seq=MAX_SEQ, prefill_budget=48,
                 kv_layout="slot")


def _lifecycles(done):
    return [(r.req_id, r.generated, r.first_token_time, r.finish_time) for r in done]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    """Port and reference ``Engine``s on the slot layout: byte-identical
    event logs, identical lifecycles and greedy tokens, and equal
    ``usage()`` after every step, which is state-slot occupancy for mamba2
    (no attention layer) and resident tokens over capacity for zamba2."""
    jc, tc, tree, pt = _model(arch)
    je = _share_jits(JaxEngine(0, jc, tree, **ENGINE_KW))
    te = Engine(0, tc, pt, device="cpu", **ENGINE_KW)
    assert je.rebalancer is None and te.rebalancer is None
    trace = _trace()
    done_j, tok_j, use_j, occ_j = _drive(je, copy.deepcopy(trace), JaxRequest)
    done_t, tok_t, use_t, occ_t = _drive(te, copy.deepcopy(trace), Request)
    assert len(done_j) == len(done_t) == len(trace)
    assert te.core.event_log() == je.core.event_log()
    assert tok_t == tok_j
    assert _lifecycles(done_t) == _lifecycles(done_j)
    assert use_t == use_j and max(use_t) > 0
    assert (use_t == occ_t) == (arch == MAMBA2)
    assert te.backend.kv.cache[("layers" if arch == MAMBA2 else "super_mamba")][
        "ssm"].dtype == torch.float32


@pytest.mark.parametrize("variant", ["gimbal", "kv"])
def test_mamba2_cluster_matches_reference(variant):
    """Two mamba2 engines behind the reference's Alg. 1 dispatch ("gimbal")
    and its KV-headroom score ("kv"), both reading state-slot occupancy:
    byte-identical assignment logs, per-engine event logs and greedy
    tokens, identical lifecycles; both engines serve."""
    jc, tc, tree, pt = _model(MAMBA2)
    trace = _trace(n=14, seed=5)
    runs = {}
    for name, make, cl_cls, gcfg, req_cls in (
            ("port", lambda i: Engine(i, tc, pt, device="cpu", **ENGINE_KW), Cluster,
             GimbalConfig(), Request),
            ("jax", lambda i: _share_jits(JaxEngine(i, jc, tree, **ENGINE_KW)), JaxCluster,
             JaxGimbalConfig(), JaxRequest)):
        tokens = {}
        cl = cl_cls([_record_tokens(make(i), tokens) for i in range(2)], variant=variant,
                    gimbal_cfg=gcfg)
        pending = _requests(copy.deepcopy(trace), req_cls)
        i, t = 0, 0.0
        for _ in range(400):
            while i < len(pending) and pending[i].arrival_time <= t:
                cl.submit(pending[i], t)
                i += 1
            cl.step(t)
            t += 0.05
            if i == len(pending) and len(cl.finished) == len(pending):
                break
        assert len(cl.finished) == len(trace)
        runs[name] = (cl, tokens)
    (ct, tt), (cj, tj) = runs["port"], runs["jax"]
    assert ct.dispatch.assignment_log() == cj.dispatch.assignment_log()
    assert len({e for _, e in ct.dispatch.assignment_log()}) == 2
    for eid in cj.engines:
        assert ct.engines[eid].core.event_log() == cj.engines[eid].core.event_log()
    assert tt == tj
    assert sorted((r.req_id, r.engine_id) + tuple(_lifecycles([r])[0]) for r in ct.finished) \
        == sorted((r.req_id, r.engine_id) + tuple(_lifecycles([r])[0]) for r in cj.finished)


# --- the card's checks, on their plain versions ---------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plan_and_mirror_at_zamba2_shape(dtype):
    """Kernel 4 at zamba2's shared attention: head dim 64 (eight 16-byte
    vectors of bf16 a row) and one query head per KV head.  ``split_plan``
    cuts the engine's B = 8 x 32 KV heads x 1024 positions into 5 spans of
    7 chunks.  The plain mirror of that split and merge (span 224 over 512
    positions: a partial last span) equals the one-pass plain version and
    the Pallas kernel (interpret mode) within chip_smoke.py's kernel-4 gate,
    and the gate's faults (no in-chunk length mask, the last partial
    dropped, a merge without rescale) fall outside it."""
    import chip_smoke
    plan = split_plan(8, 1024, 32, 32, 64, 2)
    assert (plan.n_split, plan.chunks_per_split, plan.span) == (5, 7, 7 * CHUNK)
    rng = np.random.default_rng(64)
    b, s, h, d = 3, 512, 8, 64
    q, k, v = (np.array(jnp.asarray(rng.normal(size=shape), dtype).astype(jnp.float32))
               for shape in ((b, h, d), (b, s, h, d), (b, s, h, d)))
    lens = np.array([0, 233, 500], np.int32)
    qt, kt, vt = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    lt = torch.from_numpy(lens)
    want = ref.ref_flash_decode(qt, kt, vt, lt)
    pallas = jax_flash_decode(*(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.asarray(lens),
                              interpret=True)
    rtol, atol = chip_smoke.FD_TOL[dtype]
    split = ref.ref_flash_decode_split(qt, kt, vt, lt, 0.0, plan.span)
    for got in (split, pallas):
        _close(got, want, dict(rtol=rtol, atol=atol))
    assert (split[0] == 0).all()
    tile_end = torch.from_numpy(-(-lens // CHUNK) * CHUNK).int()
    wrong = {"no in-chunk length mask": ref.ref_flash_decode(qt, kt, vt, tile_end)}
    wrong.update(chip_smoke._merge_faults(
        torch, ref, ref.ref_flash_decode_partials(qt, kt, vt, lt, 0.0, plan.span), qt.dtype))
    for fault, bad in wrong.items():
        assert chip_smoke.max_excess(bad, want, rtol, atol)[1] > 0, fault


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_ssm_gates_reject_faulty_decodes(monkeypatch, arch):
    """chip_smoke.py's f32 gates at the smoke widths and its gate depths
    (mamba2 2 layers; zamba2 one super-block and one epilogue layer): the
    recurrent decode of a 300-token prefill (38 chunks of 8, the last
    ragged) matches the chunked prefill of all 304 tokens within 2e-4, and
    both faulty decodes (the state not written back, the conv tail read as
    zeros) fall outside it; the port's decode step is restored after."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    cfg = get_smoke_config(arch).replace(**dict(chip_smoke.SSM_GATE_CUTS)[arch])
    params = TM.init_params(cfg, seed=1, device="cpu")
    step = TM2.mamba2_decode
    errs = chip_smoke._ssm_gates(torch, cfg, params, f"[{arch}]")
    assert TM2.mamba2_decode is step
    assert errs["card vs cpu"] == 0.0 and 0.0 < errs["recurrent vs chunked"] < 2e-4
