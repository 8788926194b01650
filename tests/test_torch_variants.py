"""The port's MoE variants and encoder-decoder against the JAX reference on
the CPU, at their smoke configs in f32 with the reference's own weights
bridged through ``repro_torch.models.convert``:

* deepseek-v2: a dense prologue layer, two shared experts, top-2 of 8
  routed experts, MLA with its compressed cache, decoded both naively
  (decompress every cached step) and weight-absorbed (latent scores);
* llama4: interleaved MoE (one MoE and one dense layer a super-block),
  top-1 routing, one shared expert;
* whisper: the encoder over stub frame embeddings, the decoder with
  cross-attention over its memory.

Parameter and cache trees, prefill, slot decode under dense, gather and
fused dispatch (with per-MoE-layer replicated placements), ``Engine`` runs
and the paged layout's rejection must match the reference.  Tolerance: f32
rtol=atol=2e-4 (tests/test_kernels.py); integers, greedy tokens, event logs
and lifecycles must be identical.  The JAX side runs as its own tests run
it: Pallas kernels in interpret mode, ``jax.jit`` with the config static.
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
from repro.models import model as JM
from repro.serving import kvcache as JKV
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.types import GimbalConfig, Request
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import kvcache as TKV
from repro_torch.serving.engine import Engine

DEEPSEEK, LLAMA4, WHISPER = ("deepseek-v2-236b", "llama4-maverick-400b-a17b",
                             "whisper-medium")
MOE_ARCHS = (DEEPSEEK, LLAMA4)
ARCHS = MOE_ARCHS + (WHISPER,)
MODES = ("dense", "gather", "fused")
TOL = dict(rtol=2e-4, atol=2e-4)
MAX_SEQ = 64
PROMPTS = (12, 19)
STEPS = 6

_J_PREFILL = jax.jit(JM.prefill, static_argnums=(1,),
                     static_argnames=("dispatch_mode", "stats"))
_J_DECODE = jax.jit(JM.decode_step, static_argnums=(1,),
                    static_argnames=("dispatch_mode", "stats", "mla_absorb"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **TOL)


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


def _frames(cfg, seed):
    """Seeded stand-ins for the stub audio frontend's frame embeddings."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, cfg.encoder_len, cfg.d_model)).astype(np.float32)


# --- module 1: weight draws that fit the card -------------------------------------

def test_weight_draw_below_threshold_is_unchanged():
    """Below the threshold ``normal`` draws exactly what it drew before the
    threshold existed, so the homogeneous families' seeded weights stay
    bit-identical; every tensor of those families lies below it."""
    for shape, dtype in (((7, 5, 3), torch.float32), ((64, 33), torch.bfloat16)):
        got = TL.normal(torch.Generator().manual_seed(5), shape, 0.3, dtype)
        want = (torch.randn(shape, generator=torch.Generator().manual_seed(5)) * 0.3).to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)
    from repro_torch.configs import get_config
    qwen2 = get_config("qwen2-72b")
    assert qwen2.vocab_size * qwen2.d_model <= TL.CHUNKED_DRAW_ELEMENTS
    llama4 = get_config(LLAMA4)
    assert llama4.num_experts * llama4.d_model * llama4.moe_d_ff > TL.CHUNKED_DRAW_ELEMENTS


def test_weight_draw_above_threshold_fills_slices(monkeypatch):
    """Above the threshold the tensor is filled one leading-axis slice at a
    time, each slice the generator's next draw, cast to the dtype."""
    monkeypatch.setattr(TL, "CHUNKED_DRAW_ELEMENTS", 100)
    got = TL.normal(torch.Generator().manual_seed(9), (4, 8, 5), 0.5, torch.bfloat16)
    gen = torch.Generator().manual_seed(9)
    want = torch.stack([(torch.randn((8, 5), generator=gen) * 0.5).to(torch.bfloat16)
                        for _ in range(4)])
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    small = TL.normal(torch.Generator().manual_seed(9), (10, 10), 0.5, torch.float32)
    assert torch.equal(small, torch.randn((10, 10), generator=torch.Generator()
                                          .manual_seed(9)) * 0.5)


@pytest.mark.parametrize("e,k", [(160, 6), (128, 1), (128, 8)])
def test_chip_smoke_router_faults_show_at_variant_shapes(monkeypatch, e, k):
    """chip_smoke.py's replica tables at deepseek's (E 160, k 6), llama4's
    (128, 1) and qwen3's (128, 8) routers: at decode (T = 8) on skewed
    logits the "replica index from j" count falls outside the gate (its hot
    expert's copies never divide k, or t * k + j and j would pick the same
    copy), and selection-major order does wherever k > 1."""
    import chip_smoke
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_router import route_plan, topk_router_replicated
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    gen = torch.Generator().manual_seed(0)
    plc = chip_smoke._router_placement(torch, e, gen, k)
    assert plc.num_slots == e + 8 and k % int(plc.replica_count.max()) != 0
    logits = chip_smoke._router_logits(torch, gen, 8, e, "skewed")
    _, ids, slots, pos = topk_router_replicated(logits, k, plc.replica_slots,
                                                plc.replica_count, plc.num_slots)
    plan = route_plan(8, e, k, plc.num_slots)
    wrong = chip_smoke._router_faults(torch, ref, (ids, slots, pos), plc, plan,
                                      plc.num_slots, k)
    for fault, want in (("replica index from j", True), ("selection-major order", k > 1)):
        fs, fp = wrong[fault]
        assert (not (torch.equal(fs, slots) and torch.equal(fp, pos))) == want, fault


# --- trees ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_variant_configs_match_reference(arch):
    jc, tc = jax_smoke_config(arch), get_smoke_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.num_moe_layers() == jc.num_moe_layers()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_layout(arch):
    """The port's seeded init has the reference's tree (the prologue a list,
    the interleaved stack grouped, whisper's encoder), shapes and dtypes."""
    jc, tc, tree, _ = _model(arch)
    mine = TM.init_params(tc, seed=0, device="cpu")
    ref, got = _leaves(tree), _leaves(mine)
    assert sorted(got) == sorted(ref)
    for path, t in got.items():
        assert tuple(t.shape) == ref[path].shape and t.dtype == torch.float32, path
    if arch == DEEPSEEK:
        assert isinstance(mine["prologue"], list) and len(mine["prologue"]) == 1
        assert "kv_norm" in mine["blocks"]["attn"] and "shared" in mine["blocks"]["moe"]
    if arch == LLAMA4:
        assert sorted(mine["blocks"]) == ["dense", "moe"]
        assert mine["blocks"]["dense"]["ffn"]["w_up"].shape[:2] == (2, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_trees_and_batch_axes_match_reference(arch):
    """``init_cache`` and ``cache_shapes`` give the reference's cache tree,
    and ``batch_axes`` walks the prologue's list to the reference's axes."""
    jc, tc, _, _ = _model(arch)
    ref = {p: a.shape for p, a in _leaves(JM.init_cache(jc, 3, MAX_SEQ)).items()}
    got = {p: tuple(t.shape) for p, t in _leaves(TM.init_cache(tc, 3, MAX_SEQ,
                                                                device="cpu")).items()}
    assert got == ref
    walked = TKV._tree_map(lambda s: np.empty(s, np.int8), TM.cache_shapes(tc, 3, MAX_SEQ))
    assert {p: a.shape for p, a in _leaves(walked).items()} == ref
    assert _leaves(TKV.batch_axes(tc, 4, MAX_SEQ)) == \
        {p: int(v) for p, v in _leaves(JKV.batch_axes(jc, 4, MAX_SEQ)).items()}


# --- prefill and slot decode -------------------------------------------------------------

def _prefill_both(arch, toks, mode="dense", stats=False, frames=None):
    jc, tc, tree, pt = _model(arch)
    jkw, tkw = {}, {}
    if frames is not None:
        jkw, tkw = {"frames": jnp.asarray(frames)}, {"frames": torch.from_numpy(frames)}
    else:
        jkw = tkw = {"dispatch_mode": mode, "stats": stats}
    lj, cj, aj = _J_PREFILL(tree, jc, jnp.asarray(toks), JM.init_cache(jc, 1, MAX_SEQ),
                            **jkw)
    lt, ct, at = TM.prefill(pt, tc, torch.from_numpy(toks).long(),
                            TM.init_cache(tc, 1, MAX_SEQ, device="cpu"), **tkw)
    return (lj, cj, aj), (lt, ct, at)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_matches_reference(arch, mode):
    """Prefill logits, every cache leaf (prologue and MLA latents included)
    and the router's stats: expert ids (n_moe, B, S, k) exactly equal."""
    jc = _model(arch)[0]
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (1, 20)).astype(np.int32)
    (lj, cj, aj), (lt, ct, at) = _prefill_both(arch, toks, mode, stats=True)
    assert tuple(lt.shape) == (1, 20, jc.vocab_size)
    _close(lt, lj)
    ref = _leaves(cj)
    for path, t in _leaves(ct).items():
        _close(t, ref[path])
    assert tuple(at["expert_ids"].shape) == (jc.num_moe_layers(), 1, 20, jc.moe_top_k)
    np.testing.assert_array_equal(at["expert_ids"].numpy(), np.asarray(aj["expert_ids"]))
    for name in ("load_balance_loss", "router_z_loss"):
        _close(at[name], aj[name])


def _slot_maps(cfg, seed):
    """One replicated slot map per MoE layer (E + 2 slots, shuffled, each
    layer its own), as an (n_moe, E + 2) array."""
    rng = np.random.default_rng(seed)
    e = cfg.num_experts
    return np.stack([rng.permutation(np.concatenate([np.arange(e), rng.choice(e, 2)]))
                     for _ in range(cfg.num_moe_layers())]).astype(np.int32)


def _moe_params(tree):
    blocks = tree["blocks"]
    return blocks["moe"]["moe"] if "dense" in blocks else blocks["moe"]


def _placed(arch, slot_maps):
    """The reference's weights with each MoE layer's experts gathered into
    its slot map, for both packages."""
    jc, tc, tree, _ = _model(arch)
    tree = copy.deepcopy(tree)
    moe = _moe_params(tree)
    for name in ("w_gate", "w_up", "w_down"):
        moe[name] = np.stack([w[m] for w, m in zip(moe[name], slot_maps)])
    return tree, params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch,absorb", [(DEEPSEEK, False), (DEEPSEEK, True), (LLAMA4, False)])
def test_slot_decode_matches_reference(arch, absorb, mode):
    """Two prefilled rows (two free) through STEPS slot decode steps under a
    replicated placement that differs per MoE layer (indexed by MoE layer,
    not by layer): logits within 2e-4, identical greedy tokens and expert
    ids every step, equal caches at the end."""
    jc, tc, _, _ = _model(arch)
    maps = _slot_maps(jc, seed=11)
    tree, pt = _placed(arch, maps)
    kvj, kvt = JKV.SlotKVCache(jc, 4, MAX_SEQ), TKV.SlotKVCache(tc, 4, MAX_SEQ, device="cpu")
    rng = np.random.default_rng(7)
    tokens = np.zeros((4, 1), np.int32)
    for row, plen in enumerate(PROMPTS):
        toks = rng.integers(0, jc.vocab_size, (1, plen)).astype(np.int32)
        (lj, cj, _), (lt, ct, _) = _prefill_both(arch, toks)
        assert kvj.alloc() == kvt.alloc() == row
        kvj.cache = JKV.write_slot(kvj.cache, cj, row, kvj.write_axes)
        TKV.write_slot(kvt.cache, ct, row, kvt.write_axes)
        kvj.slot_len[row] = kvt.slot_len[row] = plen
        tokens[row, 0] = int(np.argmax(np.asarray(lj)[0, plen - 1]))
    kw = dict(dispatch_mode=mode, stats=True, mla_absorb=absorb)
    for _ in range(STEPS):
        lj, kvj.cache, aj = _J_DECODE(tree, jc, jnp.asarray(tokens), kvj.cache,
                                      kvj.positions(), placements=jnp.asarray(maps), **kw)
        lt, _, at = TM.decode_step(pt, tc, torch.tensor(tokens).long(), kvt.cache,
                                   kvt.positions(), placements=maps, **kw)
        _close(lt[:2], np.asarray(lj)[:2])
        nj = np.asarray(jnp.argmax(lj, -1), np.int32)
        np.testing.assert_array_equal(torch.argmax(lt, -1).numpy()[:2], nj[:2])
        np.testing.assert_array_equal(at["expert_ids"].numpy(), np.asarray(aj["expert_ids"]))
        kvj.slot_len[:2] += 1
        kvt.slot_len[:2] += 1
        tokens = nj[:, None]
    ref = _leaves(kvj.cache)
    for path, t in _leaves(kvt.cache).items():
        _close(t, ref[path])


def test_mla_absorbed_decode_equals_naive_in_port():
    """In the port alone: latent-space scores give the naive decode's
    logits and caches over STEPS steps from the same prefilled rows."""
    jc, tc, _, pt = _model(DEEPSEEK)
    runs = []
    for absorb in (False, True):
        kv = TKV.SlotKVCache(tc, 3, MAX_SEQ, device="cpu")
        rng = np.random.default_rng(5)
        tokens = torch.zeros((3, 1), dtype=torch.long)
        for row, plen in enumerate((9, 23, 16)):
            toks = torch.as_tensor(rng.integers(0, tc.vocab_size, (1, plen)))
            logits, cache, _ = TM.prefill(pt, tc, toks, TM.init_cache(tc, 1, MAX_SEQ,
                                                                         device="cpu"))
            TKV.write_slot(kv.cache, cache, kv.alloc(), kv.write_axes)
            kv.slot_len[row] = plen
            tokens[row, 0] = int(torch.argmax(logits[0, -1]))
        out = []
        for _ in range(STEPS):
            logits, _, _ = TM.decode_step(pt, tc, tokens, kv.cache, kv.positions(),
                                          mla_absorb=absorb)
            out.append(logits)
            tokens = torch.argmax(logits, -1)[:, None]
            kv.slot_len += 1
        runs.append((torch.stack(out), kv.cache))
    (naive, cn), (absorbed, ca) = runs
    _close(absorbed, naive.numpy())
    for path, t in _leaves(ca).items():
        _close(t, _leaves(cn)[path].numpy())


def test_whisper_prefill_and_decode_match_reference():
    """Two rows prefilled from their own seeded frames (encoder, then the
    decoder over prompts of 12 and 19 tokens), written into slot caches
    with their memory, then STEPS decode steps: logits within 2e-4,
    identical greedy tokens, equal caches and memory."""
    jc, tc, tree, pt = _model(WHISPER)
    kvj, kvt = JKV.SlotKVCache(jc, 4, MAX_SEQ), TKV.SlotKVCache(tc, 4, MAX_SEQ, device="cpu")
    rng = np.random.default_rng(13)
    tokens = np.zeros((4, 1), np.int32)
    for row, plen in enumerate(PROMPTS):
        toks = rng.integers(0, jc.vocab_size, (1, plen)).astype(np.int32)
        (lj, cj, _), (lt, ct, _) = _prefill_both(WHISPER, toks, frames=_frames(jc, 20 + row))
        assert tuple(lt.shape) == (1, plen, jc.vocab_size)
        _close(lt, lj)
        _close(ct["memory"], cj["memory"])
        assert kvj.alloc() == kvt.alloc() == row
        kvj.cache = JKV.write_slot(kvj.cache, cj, row, kvj.write_axes)
        TKV.write_slot(kvt.cache, ct, row, kvt.write_axes)
        kvj.slot_len[row] = kvt.slot_len[row] = plen
        tokens[row, 0] = int(np.argmax(np.asarray(lj)[0, plen - 1]))
    # other frames give other logits: the memory is real input
    toks = rng.integers(0, jc.vocab_size, (1, 12)).astype(np.int32)
    a = _prefill_both(WHISPER, toks, frames=_frames(jc, 1))[1][0]
    b = _prefill_both(WHISPER, toks, frames=_frames(jc, 2))[1][0]
    assert not np.allclose(_np(a), _np(b), **TOL)
    for _ in range(STEPS):
        lj, kvj.cache, _ = _J_DECODE(tree, jc, jnp.asarray(tokens), kvj.cache,
                                     kvj.positions())
        lt, _, _ = TM.decode_step(pt, tc, torch.tensor(tokens).long(), kvt.cache,
                                  kvt.positions())
        _close(lt[:2], np.asarray(lj)[:2])
        nj = np.asarray(jnp.argmax(lj, -1), np.int32)
        np.testing.assert_array_equal(torch.argmax(lt, -1).numpy()[:2], nj[:2])
        kvj.slot_len[:2] += 1
        kvt.slot_len[:2] += 1
        tokens = nj[:, None]
    ref = _leaves(kvj.cache)
    for path, t in _leaves(kvt.cache).items():
        _close(t, ref[path])


# --- the paged layout ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_paged_layout_rejects_variants_like_reference(arch):
    """Both packages' paged caches reject prologue, interleaved, MLA and
    encoder-decoder stacks with the same error; the port's paged decode
    step does too."""
    jc, tc, _, pt = _model(arch)
    with pytest.raises(ValueError) as ej:
        JKV.PagedKVCache(jc, 4, MAX_SEQ, block_size=16)
    with pytest.raises(ValueError) as et:
        TKV.PagedKVCache(tc, 4, MAX_SEQ, block_size=16, device="cpu")
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="PagedKVCache"):
        TM.decode_step_paged(pt, tc, torch.zeros((2, 1), dtype=torch.long), {},
                             torch.zeros((2, 1), dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="PagedKVCache"):
        Engine(0, tc, pt, kv_layout="paged", max_slots=2, max_seq=MAX_SEQ, device="cpu")


# --- engines -------------------------------------------------------------------------------

def _trace(n=10, seed=41, n_users=2):
    """Per-user shared 16-token prefixes plus private suffixes, 4-9 new
    tokens each."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 128, 16) for _ in range(n_users)]
    out, t = [], 0.0
    for i in range(n):
        toks = np.concatenate([prefixes[i % n_users], rng.integers(0, 128, int(rng.integers(0, 16)))])
        out.append((i, toks, int(rng.integers(4, 10)), t))
        t += float(rng.exponential(0.04))
    return out


def _drive(engine, trace, request_cls, n_steps=300, dt=0.05):
    reqs = [request_cls(i, len(toks), m, a, prompt_tokens=toks, user_id=f"u{i % 2}")
            for i, toks, m, a in trace]
    tokens = {}
    orig = engine.backend.decode

    def record(active, now):
        out = orig(active, now)
        for slot, r in active:
            tokens.setdefault(r.req_id, []).append(int(engine.backend.slot_last_token[slot]))
        return out

    engine.backend.decode = record
    i, t, done = 0, 0.0, []
    for _ in range(n_steps):
        while i < len(reqs) and reqs[i].arrival_time <= t:
            engine.submit(reqs[i], t)
            i += 1
        done += engine.step(t)
        t += dt
        if i == len(reqs) and len(done) == len(reqs):
            break
    return done, tokens


def _engines(arch, variant):
    jc, tc, tree, pt = _model(arch)
    kw = dict(variant=variant, max_slots=4, max_seq=MAX_SEQ, prefill_budget=48,
              kv_layout="slot", dispatch_mode="fused", num_expert_devices=2)
    je = JaxEngine(0, jc, tree, gimbal_cfg=JaxGimbalConfig(tau=3), **kw)
    te = Engine(0, tc, pt, gimbal_cfg=GimbalConfig(tau=3), device="cpu", **kw)
    return je, te


@pytest.mark.parametrize("arch,variant", [(DEEPSEEK, "gimbal+rep"), (LLAMA4, "vllm")])
def test_engine_matches_reference(arch, variant):
    """Port and reference ``Engine``s on the slot layout with fused dispatch:
    byte-identical event logs, identical lifecycles and greedy tokens; under
    "gimbal+rep" deepseek's expert level rebalances into a replicated map
    (relocations > 0, identical ``RebalanceEvent``s and slot maps), under
    "vllm" llama4's placement never moves."""
    je, te = _engines(arch, variant)
    trace = _trace()
    done_j, tok_j = _drive(je, copy.deepcopy(trace), JaxRequest)
    done_t, tok_t = _drive(te, copy.deepcopy(trace), Request)
    assert len(done_j) == len(done_t) == len(trace)
    assert te.core.event_log() == je.core.event_log()
    assert tok_t == tok_j
    assert [(r.req_id, r.generated, r.first_token_time, r.finish_time) for r in done_t] == \
        [(r.req_id, r.generated, r.first_token_time, r.finish_time) for r in done_j]
    assert te.relocations == je.relocations
    if variant == "gimbal+rep":
        assert te.relocations > 0
        assert [vars(e) for e in te.rebalancer.events] == \
            [vars(e) for e in je.rebalancer.events]
        np.testing.assert_array_equal(te.rebalancer.slot_map, je.rebalancer.slot_map)
        n_slots = te.cfg.num_experts + 2
        assert te.params["blocks"]["moe"]["w_gate"].shape[1] == n_slots
    else:
        assert te.relocations == 0


def test_llama4_relocation_fails_in_both_packages():
    """The reference's ``apply_placement`` takes ``params["blocks"]["moe"]``
    for the expert weights; in the interleaved layout it is the MoE
    super-block's whole tree, so the first relocation raises ``KeyError``.
    The port reproduces the fault (no silent success)."""
    trace = _trace()
    for eng, req_cls in zip(_engines(LLAMA4, "gimbal"), (JaxRequest, Request)):
        with pytest.raises(KeyError, match="w_gate"):
            _drive(eng, copy.deepcopy(trace), req_cls)
        assert eng.rebalancer.migrations >= 1
