"""The port's dense GQA families against the JAX reference on the CPU, at
their smoke configs in f32 with the reference's own weights bridged through
``repro_torch.models.convert``: gemma2 (local/global alternation with a
sliding window, attention and final softcaps, tied embeddings), qwen2 (QKV
bias), granite-3-8b (GQA), granite-20b (MQA, one KV head) and internvl2's
language model (a seeded vision prefix ahead of the tokens at prefill).

The reference initialises qwen2's biases to zero, so they are perturbed
from a seed before both packages get them: a zero bias would test nothing.
Prompts and decode steps run past the smoke window of 8 positions, so the
local layers' window masks real positions.

Tolerance: f32 rtol=atol=2e-4 (tests/test_kernels.py); greedy tokens,
scheduling event logs and request lifecycles must be identical.  The JAX
side runs as its own tests run it: Pallas kernels in interpret mode.
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
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import kvcache as TKV
from repro_torch.serving.engine import Engine

ARCHS = ("gemma2-2b", "qwen2-72b", "granite-3-8b", "granite-20b", "internvl2-26b")
TOL = dict(rtol=2e-4, atol=2e-4)
MAX_SEQ = 64
PROMPTS = (12, 19)          # both past the smoke window of 8
STEPS = 6


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **(tol or TOL))


def _perturb_biases(tree, rng):
    """Seeded non-zero QKV biases wherever the tree holds them."""
    if isinstance(tree, dict):
        return {k: (rng.normal(size=v.shape).astype(v.dtype) * 0.5
                    if k in ("bq", "bk", "bv") else _perturb_biases(v, rng))
                for k, v in tree.items()}
    return tree


_MODELS = {}
# the reference's entry points, compiled once per config and shape (the
# config is a frozen dataclass, so it can be a static argument)
_J_PREFILL = jax.jit(JM.prefill, static_argnums=(1,))
_J_DECODE = jax.jit(JM.decode_step, static_argnums=(1,))
_J_DECODE_PAGED = jax.jit(JM.decode_step_paged, static_argnums=(1,),
                          static_argnames=("use_kernel",))


def _model(arch):
    """(reference config, port config, numpy weights, port weights)."""
    if arch not in _MODELS:
        jc, tc = jax_smoke_config(arch), get_smoke_config(arch)
        tree = jax.tree.map(np.array, JM.init_params(jax.random.key(0), jc))
        tree = _perturb_biases(tree, np.random.default_rng(1))
        _MODELS[arch] = (jc, tc, tree, params_from_numpy(tree, device="cpu"))
    return _MODELS[arch]


def _vision(cfg, seed):
    """Seeded stand-ins for the stub frontend's patch embeddings (VLM only)."""
    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32)


def _prefill_both(arch, toks, seed):
    """Prefill one prompt through both packages: (reference logits and cache,
    port logits and cache)."""
    jc, tc, tree, pt = _model(arch)
    ve = _vision(jc, seed)
    jkw = {} if ve is None else {"vision_embeds": jnp.asarray(ve)}
    tkw = {} if ve is None else {"vision_embeds": torch.from_numpy(ve)}
    lj, cj, _ = _J_PREFILL(tree, jc, jnp.asarray(toks), JM.init_cache(jc, 1, MAX_SEQ), **jkw)
    lt, ct, _ = TM.prefill(pt, tc, torch.from_numpy(toks).long(),
                           TM.init_cache(tc, 1, MAX_SEQ, device="cpu"), **tkw)
    return (lj, cj), (lt, ct)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_configs_match_reference(arch):
    jc, tc = jax_smoke_config(arch), get_smoke_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert [tc.layer_is_local(i) for i in range(tc.num_layers)] == \
        [jc.layer_is_local(i) for i in range(jc.num_layers)]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_layout(arch):
    """The port's seeded init has the reference's tree, shapes and dtypes
    (qwen2's biases included)."""
    jc, tc, tree, _ = _model(arch)
    mine = TM.init_params(tc, seed=0, device="cpu")
    ref = {str(p): a for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    got = {str(p): t for p, t in jax.tree_util.tree_leaves_with_path(mine)}
    assert sorted(got) == sorted(ref)
    for path, t in got.items():
        assert tuple(t.shape) == ref[path].shape and t.dtype == torch.float32, path
    assert ("bq" in str(sorted(got))) == tc.qkv_bias


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """Prefill logits and the written caches; for internvl2 the vision prefix
    precedes the tokens, so logits and cache cover prefix + prompt."""
    jc = _model(arch)[0]
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (1, 20)).astype(np.int32)
    (lj, cj), (lt, ct) = _prefill_both(arch, toks, seed=4)
    n = 20 + (jc.vision_prefix_len if jc.family == "vlm" else 0)
    assert tuple(lt.shape) == (1, n, jc.vocab_size) and lt.dtype == torch.float32
    _close(lt, lj)
    for name in ("k", "v"):
        _close(ct["layers"][name][:, :, :n], np.asarray(cj["layers"][name])[:, :, :n])
    if jc.family == "vlm":
        # the prefix is real input: other embeddings give other logits
        (lj2, _), (lt2, _) = _prefill_both(arch, toks, seed=5)
        _close(lt2, lj2)
        assert not np.allclose(_np(lt2), _np(lt), **TOL)


def _start_rows(arch, write):
    """Prefill PROMPTS into rows 0 and 1 of both packages' caches through
    ``write(row, resident, ref_cache, port_cache)``; returns the next tokens
    (B=4, 1)."""
    jc = _model(arch)[0]
    rng = np.random.default_rng(7)
    tokens = np.zeros((4, 1), np.int32)
    for row, plen in enumerate(PROMPTS):
        toks = rng.integers(0, jc.vocab_size, (1, plen)).astype(np.int32)
        (lj, cj), (lt, ct) = _prefill_both(arch, toks, seed=10 + row)
        _close(lt, lj)
        n = plen + (jc.vision_prefix_len if jc.family == "vlm" else 0)
        write(row, n, cj, ct)
        tokens[row, 0] = int(np.argmax(np.asarray(lj)[0, n - 1]))
        assert tokens[row, 0] == int(torch.argmax(lt[0, n - 1]))
    return tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_decode_matches_reference(arch):
    """Two prefilled rows (two free) through STEPS slot decode steps past the
    window: logits within 2e-4 and identical greedy tokens every step."""
    jc, tc, tree, pt = _model(arch)
    kvj, kvt = JKV.SlotKVCache(jc, 4, MAX_SEQ), TKV.SlotKVCache(tc, 4, MAX_SEQ, device="cpu")

    def write(row, n, cj, ct):
        assert kvj.alloc() == kvt.alloc() == row
        kvj.cache = JKV.write_slot(kvj.cache, cj, row, kvj.write_axes)
        TKV.write_slot(kvt.cache, ct, row, kvt.write_axes)
        kvj.slot_len[row] = kvt.slot_len[row] = n

    tokens = _start_rows(arch, write)
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
    assert int(kvt.slot_len[1]) > 8 + STEPS


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_reference(arch, use_kernel):
    """The same rows through STEPS paged decode steps (16-position pages),
    with the kernel path off and on in both packages (the port's wrapper
    takes its plain version on CPU tensors, the reference runs Pallas in
    interpret mode): logits within 2e-4, identical greedy tokens, equal
    block tables."""
    jc, tc, tree, pt = _model(arch)
    kvj = JKV.PagedKVCache(jc, 4, MAX_SEQ, block_size=16)
    kvt = TKV.PagedKVCache(tc, 4, MAX_SEQ, block_size=16, device="cpu")

    def write(row, n, cj, ct):
        assert kvj.alloc(n) == kvt.alloc(n) == row
        kvj.write_prefill(row, cj)
        kvt.write_prefill(row, ct)
        kvj.slot_len[row] = kvt.slot_len[row] = n

    tokens = _start_rows(arch, write)
    for _ in range(STEPS):
        for s in (0, 1):
            kvj.prepare_append(s)
            kvt.prepare_append(s)
        np.testing.assert_array_equal(kvt.block_tables, kvj.block_tables)
        lj, kvj.pages, _ = _J_DECODE_PAGED(
            tree, jc, jnp.asarray(tokens), kvj.pages, kvj.device_tables(), kvj.positions(),
            use_kernel=use_kernel)
        lt, _, _ = TM.decode_step_paged(
            pt, tc, torch.tensor(tokens).long(), kvt.pages, kvt.device_tables(),
            kvt.positions(), use_kernel=use_kernel)
        _close(lt[:2], np.asarray(lj)[:2])
        nj = np.asarray(jnp.argmax(lj, -1), np.int32)
        np.testing.assert_array_equal(torch.argmax(lt, -1).numpy()[:2], nj[:2])
        kvj.slot_len[:2] += 1
        kvt.slot_len[:2] += 1
        tokens = nj[:, None]
    for name in ("k", "v"):
        _close(kvt.pages[name], np.asarray(kvj.pages[name]))


def test_local_layers_never_launch_the_paged_kernel(monkeypatch):
    """gemma2's windowed local layers take the plain windowed path; only the
    global layers reach kernel 1 (half of gemma2's layers: 13 of 26 at full
    depth, 2 of 4 at the smoke depth)."""
    from repro_torch.models import attention as TA
    jc, tc, tree, pt = _model("gemma2-2b")
    calls = []
    orig = TA.paged_decode_attention
    monkeypatch.setattr(TA, "paged_decode_attention",
                        lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    kvt = TKV.PagedKVCache(tc, 2, MAX_SEQ, block_size=16, device="cpu")
    TM.decode_step_paged(pt, tc, torch.zeros((2, 1), dtype=torch.long), kvt.pages,
                         kvt.device_tables(), kvt.positions(), use_kernel=True)
    n_global = sum(not tc.layer_is_local(i) for i in range(tc.num_layers))
    assert len(calls) == n_global == tc.num_layers // 2
    full = tc.replace(num_layers=26)
    assert sum(not full.layer_is_local(i) for i in range(26)) == 13


# --- gemma2 through both packages' engines ----------------------------------------

def _trace(n=8, seed=41, n_users=2):
    """Per-user shared 16-token prefixes plus private suffixes, 4-9 new
    tokens each: prompts of 16-31 tokens, past the window of 8."""
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


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_gemma2_engine_matches_reference(layout):
    """Port and reference ``Engine``s serving gemma2 (no expert level: a
    dense model) on one layout: byte-identical scheduling event logs,
    identical request lifecycles and greedy token streams; on the paged
    layout prefix pages are shared and the pool drained."""
    jc, tc, tree, pt = _model("gemma2-2b")
    kw = dict(variant="gimbal", max_slots=4, max_seq=MAX_SEQ, prefill_budget=48,
              kv_layout=layout, kv_block_size=16, use_kernels=layout == "paged")
    gkw = dict(tau=10_000, theta_age=1.0)
    je = JaxEngine(0, jc, tree, gimbal_cfg=JaxGimbalConfig(**gkw), **kw)
    te = Engine(0, tc, pt, gimbal_cfg=GimbalConfig(**gkw), device="cpu", **kw)
    assert je.rebalancer is None and te.rebalancer is None
    trace = _trace()
    done_j, tok_j = _drive(je, copy.deepcopy(trace), JaxRequest)
    done_t, tok_t = _drive(te, copy.deepcopy(trace), Request)
    assert len(done_j) == len(done_t) == len(trace)
    assert te.core.event_log() == je.core.event_log()
    assert tok_t == tok_j
    assert [(r.req_id, r.generated, r.first_token_time, r.finish_time) for r in done_t] == \
        [(r.req_id, r.generated, r.first_token_time, r.finish_time) for r in done_j]
    assert max(len(toks) for _, toks, _, _ in trace) + max(len(v) for v in tok_t.values()) > 8
    if layout == "paged":
        assert te.kv.shared_hits == je.kv.shared_hits > 0
        assert te.kv.blocks_used == je.kv.blocks_used == 0
