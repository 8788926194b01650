"""The serving backend's MLA decode on the CPU, at the deepseek-v2-236b
smoke widths in f32: ``TorchBackend`` on the slot layout decodes in latent
space (``mla_decode``'s ``absorb=True``) and serves the tokens and logits
of the naive decode (every cached position decompressed) driven by hand
from the same prefilled cache.  A GQA backend never reaches ``mla_decode``.
Tolerance: f32 rtol=atol=2e-4 (tests/test_torch_variants.py); greedy tokens
identical.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.types import Request
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.serving.backend import TorchBackend
from repro_torch.tree import leaves

DEEPSEEK, QWEN3 = "deepseek-v2-236b", "qwen3-30b-a3b"
TOL = dict(rtol=2e-4, atol=2e-4)
MAX_SLOTS, MAX_SEQ = 4, 64
PROMPTS = (9, 23, 16)
STEPS = 6


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), want.detach().float().numpy(),
                               **TOL)


def _backend(arch, **kw):
    """A backend with PROMPTS prefilled into rows 0-2 (row 3 free)."""
    cfg = get_smoke_config(arch)
    be = TorchBackend(cfg, M.init_params(cfg, 0, device="cpu"), max_slots=MAX_SLOTS,
                      max_seq=MAX_SEQ, dispatch_mode="fused", device="cpu", **kw)
    rng = np.random.default_rng(3)
    active = []
    for i, n in enumerate(PROMPTS):
        r = Request(i, n, 32, 0.0, prompt_tokens=rng.integers(0, cfg.vocab_size, n))
        slot, _ = be.start(r, 0.0)
        active.append((slot, r))
    return be, active


@pytest.fixture
def absorb_seen(monkeypatch):
    """``absorb`` of every call that reaches ``attention.mla_decode``."""
    seen = []
    mla_decode = A.mla_decode

    def spy(*a, **kw):
        seen.append(kw.get("absorb", a[5] if len(a) > 5 else False))
        return mla_decode(*a, **kw)

    monkeypatch.setattr(A, "mla_decode", spy)
    return seen


def test_backend_decodes_mla_in_latent_space(monkeypatch, absorb_seen):
    """STEPS backend decode steps take ``absorb=True`` in every layer, and
    their logits and tokens are those of the naive decode over a copy of
    the prefilled cache."""
    be, active = _backend(DEEPSEEK)
    cfg = be.cfg
    naive_cache = copy.deepcopy(be.kv.cache)
    tokens = torch.as_tensor(be.slot_last_token.astype(np.int64))[:, None]
    inputs, served = [], []
    decode_step = M.decode_step

    def watch(params, cfg_, token, cache, pos, **kw):
        out = decode_step(params, cfg_, token, cache, pos, **kw)
        inputs.append((token.clone(), pos.clone(), kw))
        served.append(out[0])
        return out

    monkeypatch.setattr(M, "decode_step", watch)
    got_tokens = []
    for _ in range(STEPS):
        be.decode(active, 0.0)
        got_tokens.append(be.slot_last_token[:len(PROMPTS)].copy())
    assert absorb_seen == [True] * (STEPS * cfg.num_layers)

    absorb_seen.clear()
    for step, (token, pos, kw) in enumerate(inputs):
        assert kw["mla_absorb"] is True
        if step == 0:
            assert torch.equal(token, tokens)
        token = token.clone()
        token[:len(PROMPTS)] = tokens[:len(PROMPTS)]      # the naive run's own greedy tokens
        logits, _, _ = decode_step(be.params, cfg, token, naive_cache, pos,
                                   **{**kw, "mla_absorb": False})
        _close(served[step][:len(PROMPTS)], logits[:len(PROMPTS)])
        tokens = torch.argmax(logits, -1)[:, None]
        np.testing.assert_array_equal(tokens[:len(PROMPTS), 0].numpy(), got_tokens[step])
    assert absorb_seen == [False] * (STEPS * cfg.num_layers)
    for got, want in zip(leaves(be.kv.cache), leaves(naive_cache), strict=True):
        _close(got, want)


@pytest.mark.parametrize("kv_layout", ["slot", "paged"])
def test_gqa_backend_never_reaches_mla_decode(absorb_seen, kv_layout):
    be, active = _backend(QWEN3, kv_layout=kv_layout)
    for _ in range(2):
        be.decode(active, 0.0)
    assert absorb_seen == []
