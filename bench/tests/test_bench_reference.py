"""Each architecture's plain reference against the port's plain CPU path at
smoke widths, float32: the prefill of a prompt whose repeated tokens
overflow two experts' capacity (so the capacity rule is exercised), then
decode steps through the port's cache (paged for qwen3, slot for
deepseek-v2), teacher-forced on the port's own tokens."""
import numpy as np
import pytest
import torch

from bench import spec, weights
from bench.reference.common import Precision
from bench.tests.tiny import tiny_cell

SEED = 2**31 + 3


def _port_logits(cell, port_cfg, prompt, steps):
    """The port's logits at each position that produced a token: the
    prefill's last row, then each decode step's row of the request."""
    from repro_torch.core.types import Request
    from repro_torch.models import model as M
    from repro_torch.serving.backend import TorchBackend
    c = cell.config
    e = c["engine"]
    params = weights.program_params(c, SEED, "cpu")
    be = TorchBackend(port_cfg, params, max_slots=2, max_seq=64, dispatch_mode="fused",
                      kv_layout=e["kv_layout"], kv_block_size=e["kv_block_size"],
                      use_kernels=e["use_kernels"], device="cpu")
    rows = []
    orig = {n: getattr(M, n) for n in ("prefill", "decode_step", "decode_step_paged")}

    def keep(name, pick):
        def f(*a, **kw):
            out = orig[name](*a, **kw)
            rows.append(pick(out[0]))
            return out
        return f
    plen = len(prompt)
    M.prefill = keep("prefill", lambda lg: lg[0, plen - 1])
    M.decode_step = keep("decode_step", lambda lg: lg[0])
    M.decode_step_paged = keep("decode_step_paged", lambda lg: lg[0])
    try:
        r = Request(req_id=1, prompt_len=plen, max_new_tokens=steps + 1, arrival_time=0.0,
                    prompt_tokens=prompt)
        slot, _ = be.start(r, 0.0)
        assert slot == 0
        served = [int(be.slot_last_token[0])]
        for i in range(steps):
            r.generated = i + 1
            be.decode([(slot, r)], 0.0)
            served.append(int(be.slot_last_token[0]))
    finally:
        for n, f in orig.items():
            setattr(M, n, f)
    return torch.stack(rows), served


def _ref_logits(cell, prompt, served, capped=True):
    from bench.reference import common
    c = cell.config
    ref = spec.reference_module(c)
    toks = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
    if not capped:
        c = dict(c, moe_capacity_factor=1e6)
    h = ref.final_hidden(c, SEED, [(toks, len(prompt))], "cpu", Precision())[0]
    g = weights.globals_(c, SEED, "cpu", torch.float32)
    return common.head(h[len(prompt) - 1:], g, c, Precision())


@pytest.mark.parametrize("name", ["qwen3-burstgpt-mmpp", "dsv2-reasoning-closed"])
def test_reference_matches_the_port_plain_path(name):
    torch.manual_seed(0)
    cell, port_cfg = tiny_cell(name)
    rng = np.random.default_rng(1)
    # 20 equal tokens route alike: their two experts take 20 > 16 selections
    # (capacity int(1.25 * 2 * 32 / 8) + 1 = 11, rounded up to 16)
    prompt = np.concatenate([np.full(20, 7), rng.integers(0, 128, 9)]).astype(np.int64)
    got, served = _port_logits(cell, port_cfg, prompt, steps=6)
    want = _ref_logits(cell, prompt, served)
    assert got.shape == want.shape == (7, 128)
    err = (got - want).abs().max().item()
    assert err < 2e-4 * want.abs().max().item() + 1e-5, err
    assert [int(t) for t in want.argmax(-1)] == served
    # the capacity rule matters here: without it the reference reads otherwise
    loose = _ref_logits(cell, prompt, served, capped=False)
    assert (loose - want).abs().max().item() > 100 * err


def test_float8_control_moves_logits_more_than_rounding():
    cell, _ = tiny_cell("qwen3-burstgpt-mmpp")
    c = cell.config
    ref = spec.reference_module(c)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 128, 40))
    h32 = ref.final_hidden(c, SEED, [(toks, 40)], "cpu", Precision())[0]
    h8 = ref.final_hidden(c, SEED, [(toks, 40)], "cpu", Precision(fp8=True))[0]
    rel = ((h8 - h32).norm() / h32.norm()).item()
    assert 1e-3 < rel < 0.5


def test_reference_drops_the_experts_a_decode_step_dropped():
    from bench.reference import common
    cell, _ = tiny_cell("qwen3-burstgpt-mmpp")
    c = cell.config
    w = weights.layer(c, SEED, 0, "cpu", torch.float32)
    x = torch.randn(6, 64, generator=torch.Generator().manual_seed(0))
    full = common.moe(x, w, c, Precision(), 0, None)
    ids = torch.topk(torch.softmax(x @ w["w_router"], -1), 2, -1).indices
    e = int(ids[4, 1])
    part = common.moe(x, w, c, Precision(), 0, None, {4: {e, 999}})
    others = [0, 1, 2, 3, 5]                           # an expert's batch shrank: rounding only
    assert torch.allclose(part[others], full[others], rtol=1e-5, atol=1e-6)
    assert (part[4] - full[4]).abs().max() > 1e-3


def test_probe_reads_decode_drops_and_checks_capacity_positions():
    from types import SimpleNamespace

    from bench.serve import Probe
    probe = SimpleNamespace(decode_routes=[])
    # one decode call, 3 rows x top-2; capacity 1: the second selection of
    # expert 5 (row 1) and of expert 7 (row 2) are dropped
    ids = torch.tensor([[5, 7], [5, 1], [7, 2]], dtype=torch.int32)
    pos = torch.tensor([[0, 0], [1, 0], [1, 0]], dtype=torch.int32)
    probe.decode_routes.append(([(0, 10, 1), (1, 11, 3), (2, 12, 2)], 0, ids, ids, pos))
    got = Probe.decode_drops(probe, [11, 12], {11: 20, 12: 30}, cap=1)
    assert got == {11: {0: {22: {5}}}, 12: {0: {31: {7}}}}
    assert Probe.capacity_mismatches(probe, 0) == 0
    pos2 = pos.clone()
    pos2[2, 0] = 0                                     # a router that counted wrong
    probe.decode_routes[0] = probe.decode_routes[0][:4] + (pos2,)
    assert Probe.capacity_mismatches(probe, 0) == 1
