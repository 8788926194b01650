"""Every decision that depends on a model's layers sits in its layout
(``bench/layouts/<architecture>.py``): the weights, the port's tree, the
FLOP counts and the kernel bounds of both cells read as they did before the
layouts existed (constants taken from the harness that held them in its
shared files), a new architecture enters from files alone, and the shared
harness names none."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from bench import spec
from bench.digest import digest
from bench.roofline import model_flops
from bench.serve import Probe
from bench.tests.tiny import tiny_cell

CELLS = ("qwen3-burstgpt-mmpp", "dsv2-reasoning-closed")
SEED = 2**31 + 17

# (the port's tree, every layer as the reference draws it) at TINY widths
DIGESTS = {
    ("qwen3-burstgpt-mmpp", "float32"): (
        "c31dd08e54deead832cdbe63576264b7293e85b227dc6c5f3d22f9104ecbb227",
        "943d7a580a04766b13eb20eb1cf2093fe839eba5ec1efe3164f1042d3515799b"),
    ("qwen3-burstgpt-mmpp", "bfloat16"): (
        "fca87e63289e69e1ee18aede0ef0603cc261cadea98c833c1aff5ac66d6a9e12",
        "7e29e910fdbbd5a6d3b6c231598b23029e5b47b97d666bf3d4a2aadd4a5283a1"),
    ("dsv2-reasoning-closed", "float32"): (
        "ca8574987b4c1c8c124c4b5daaa1ea7379b0664e2740426cde8c4503efb9efde",
        "4aa25ce819a6415777f9199b16fc7c1875acd09fd93bc060f37f2fe2b0545b76"),
    ("dsv2-reasoning-closed", "bfloat16"): (
        "e588f0fe2d2246be9a6ab824a9e562c62ba1a8251cc735e014805e4db145ce5f",
        "198d0b40baf865df707b081ab811a56cc0dbf83324007d2e10439e77dbd13eb9"),
}
# sha256 of repr() of the floats over PROMPTS and DECODES at the cells' widths
PROMPTS = range(16, 8193)
DECODES = [[1], [16], [100, 2000, 8191], list(range(1, 33)), [4096] * 16,
           [7, 300, 5000, 6001, 8191, 12]]
FLOPS = {
    "qwen3-burstgpt-mmpp": (
        "65a92305f70f42a3995986d36150e158f93ca4319c375b5318664ffa626c2298",
        "6005faea7d81b5b304710d8b7d4aef0fd8045445ee0c226ccc57d08affd2221c"),
    "dsv2-reasoning-closed": (
        "a856284b652eabed34be8bd45bc44d8fb0c63e2535f057d464fbfeb95d107407",
        "11d7245f545ff7aa80d73cfb99b03b1aa2e4cdc9c1599ebf6e6b686248ebc24c"),
}
BOUNDS = {
    "qwen3-burstgpt-mmpp": {"moe_gemm": 0.05257563487522391,
                            "flash_decode_paged": 0.002962060914626866},
    "dsv2-reasoning-closed": {"moe_gemm": 0.056567598920597054, "flash_decode_paged": 0.0},
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CELLS)
def test_weights_and_tree_digest_unchanged(name, dtype):
    c = tiny_cell(name, dtype=dtype)[0].config
    d = digest(c, SEED, "cpu")
    assert (d["program"], d["layers_all"]) == DIGESTS[name, dtype]


def _sha(values):
    return hashlib.sha256(repr(values).encode()).hexdigest()


@pytest.mark.parametrize("name", CELLS)
def test_flops_unchanged_at_full_widths(name):
    c = spec.find_cell(name).config
    pre = [model_flops.prefill(c, p) for p in PROMPTS]
    dec = [model_flops.decode(c, ls) for ls in DECODES]
    assert (_sha(pre), _sha(dec)) == FLOPS[name]


def _routes(c):
    """Prefills of 16, 700 and 2047 tokens and decode steps of 1, 3 and every
    row, through every MoE layer, on expert ids drawn from a fixed seed."""
    lay = spec.layout_module(c)
    e = lay.n_experts(c)
    k = c["num_experts_per_tok"]
    n_moe = sum(lay.is_moe_layer(c, l) for l in range(c["num_hidden_layers"]))
    g = torch.Generator().manual_seed(5)
    routes = []
    for plen in (16, 700, 2047):
        bucket = 16
        while bucket < plen:
            bucket *= 2
        for m in range(n_moe):
            routes.append((("prefill", plen), m, torch.randint(0, e, (bucket, k), generator=g)))
    slots = c["engine"]["max_slots"]
    for rows in ([0], [0, 3, 5], list(range(slots))):
        for m in range(n_moe):
            routes.append((("decode", rows), m, torch.randint(0, e, (slots, k), generator=g)))
    return routes


@pytest.mark.parametrize("name", CELLS)
def test_kernel_bounds_unchanged_at_full_widths(name):
    c = spec.find_cell(name).config
    lengths = [[17], [100, 2000, 8191], list(range(1000, 1000 + 31 * 200, 200))]
    probe = types.SimpleNamespace(config=c, routes=_routes(c), decode_lengths=lengths)
    assert Probe.kernel_bounds(probe) == BOUNDS[name]


SHARED = ("weights.py", "roofline/__init__.py", "roofline/flash_decode_paged.py",
          "roofline/model_flops.py", "roofline/moe_gemm.py", "roofline/peaks.py", "serve.py",
          "check.py", "tests/tiny.py")


def test_shared_harness_names_no_architecture():
    archs = {p.stem for p in (spec.BENCH / "layouts").glob("*.py")} - {"__init__", "common"}
    archs |= {spec.find_cell(w["name"]).config["architecture"]
              for w in spec.load_benchmark()["workloads"]}
    assert {"qwen3_moe", "deepseek_v2"} <= archs
    for f in SHARED:
        text = (spec.BENCH / f).read_text()
        assert not [a for a in archs if a in text], f


# ------------------------------------------------------------ a new architecture

TOY_LAYOUT = '''"""A toy of two layer kinds: even layers attention (layer 0 over a
sliding window) and routed experts of two launches (up, down); odd layers a
mixer of leaves of their own and no FFN.  One embedding, tied."""
import torch

from bench.layouts import common
from bench.weights import NORM_STD, Leaf, dtype

WIDTHS = {"num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
          "num_experts": "num_experts", "moe_intermediate_size": "moe_d_ff",
          "num_experts_per_tok": "moe_top_k", "sliding_window": "sliding_window"}
TINY = dict(hidden_size=32, num_attention_heads=2, num_key_value_heads=1, head_dim=16,
            num_experts=4, num_experts_per_tok=2, moe_intermediate_size=8, vocab_size=64,
            num_hidden_layers=3, sliding_window=4)


def global_leaves(config):
    d, dt = config["hidden_size"], dtype(config)
    return [Leaf("embedding", (config["vocab_size"], d), d ** -0.5, dt),
            Leaf("final_norm", (d,), NORM_STD, dt)]


def layer_leaves(config, l):
    d, dt = config["hidden_size"], dtype(config)
    if l % 2:
        return [Leaf("mix_in", (d, 2 * d), d ** -0.5, dt),
                Leaf("mix_out", (2 * d, d), (2 * d) ** -0.5, dt)]
    e, f = config["num_experts"], config["moe_intermediate_size"]
    return common.norm_leaves(config) + common.gqa_leaves(config) + [
        Leaf("w_router", (d, e), d ** -0.5, torch.float32),
        Leaf("w_up", (e, d, f), d ** -0.5, dt), Leaf("w_down", (e, f, d), f ** -0.5, dt)]


def program_params(config, draw):
    g, n = draw.globals_(), config["num_hidden_layers"]
    return {"embed": {"embedding": g["embedding"]}, "final_norm": {"scale": g["final_norm"]},
            "attn_blocks": draw.stack(range(0, n, 2)),
            "mixers": [draw.layer(l) for l in range(1, n, 2)]}


def is_moe_layer(config, l):
    return l % 2 == 0


def n_experts(config):
    return config["num_experts"]


def window(config, l):
    return config["sliding_window"] if l == 0 else None


def layer_flops(config, l, span):
    d = config["hidden_size"]
    if l % 2:
        return 8 * d * d
    e, f, k = config["num_experts"], config["moe_intermediate_size"], config["num_experts_per_tok"]
    return common.gqa_flops(config, span) + 2 * d * e + 4 * d * f * k


def paged_heads(config, l):
    if l % 2:
        return None
    return config["num_attention_heads"], config["num_key_value_heads"], config["head_dim"]


def moe_launches(config, l):
    return 2, config["hidden_size"], config["moe_intermediate_size"]
'''

TOY_REFERENCE = '''"""The toy's reference: the embedding is the hidden state; the head is tied
and scaled."""
import torch

from bench import spec, weights
from bench.reference.common import rms_norm

SCALE = 3.0


def final_hidden(config, seed, seqs, device, p, drops=None):
    emb = weights.draw(spec.layout_module(config).global_leaves(config)[0], seed, None,
                       device).float()
    return [emb[t] for t, _ in seqs]


def head(h, g, config, p):
    return SCALE * rms_norm(h, g["final_norm"], config["rms_norm_eps"]) @ g["embedding"].T
'''

TOY_CHECK = '''
import json, sys, types
import numpy as np
import pytest
import torch
from bench import check, spec, weights
from bench.roofline import flash_decode_paged, model_flops, moe_gemm, peaks
from bench.serve import Probe, port_config
from bench.tests.tiny import tiny_cell

cell, port_cfg = tiny_cell("toy-cell")
c = cell.config
lay = spec.layout_module(c)
assert spec.BENCH.parent.resolve() == __import__("pathlib").Path.cwd().resolve()
assert {k: c[k] for k in lay.TINY} == lay.TINY
assert (port_cfg.sliding_window, port_cfg.num_experts, port_cfg.moe_d_ff, port_cfg.d_model,
        port_cfg.num_layers) == (4, 4, 8, 32, 3)
port_config(c, port_cfg)

# weights: the program's slice of each leaf is the reference's draw of it
seed = 2**31 + 9
params = weights.program_params(c, seed, "cpu")
assert sorted(params) == ["attn_blocks", "embed", "final_norm", "mixers"]
assert list(params["embed"]) == ["embedding"]
for i, l in enumerate((0, 2)):
    again = weights.layer(c, seed, l, "cpu")
    assert sorted(again) == sorted(params["attn_blocks"])
    for name, t in again.items():
        assert torch.equal(params["attn_blocks"][name][i], t), name
assert sorted(params["mixers"][0]) == ["mix_in", "mix_out"]
for name, t in weights.layer(c, seed, 1, "cpu").items():
    assert torch.equal(params["mixers"][0][name], t), name
assert params["attn_blocks"]["w_up"].shape == (2, 4, 32, 8)

# operations: layer 0 attends to 4 positions at most, layer 1 to none
d, V = 32, 64
def by_hand(ctx):
    gqa = lambda s: 2 * (d * (2 + 2) * 16 + 2 * 16 * d) + 4 * 2 * 16 * s
    moe = 2 * d * 4 + 4 * d * 8 * 2
    return gqa(min(ctx, 4)) + moe + 8 * d * d + gqa(ctx) + moe
for ctx in (1, 3, 4, 5, 100):
    assert model_flops.token(c, ctx, False) == by_hand(ctx)
    assert model_flops.token(c, ctx, True) == by_hand(ctx) + 2 * d * V
for n in (1, 3, 4, 5, 37):
    want = sum(by_hand(p) for p in range(1, n + 1)) + 2 * d * V
    assert model_flops.prefill(c, n) == pytest.approx(want, rel=1e-12)
assert model_flops.decode(c, [3, 9]) == model_flops.token(c, 3, True) + model_flops.token(c, 9, True)

# kernel bounds: two launches a MoE layer; the window cuts layer 0's reads
ids = torch.tensor([[0, 1], [1, 2], [3, 0]])
routes = [(("prefill", 2), 0, ids), (("decode", [0, 2]), 1, ids)]
lengths = [[3, 9]]
c["engine"].update(kv_layout="paged", use_kernels=True)
probe = types.SimpleNamespace(config=c, routes=routes, decode_lengths=lengths)
got = Probe.kernel_bounds(probe)
moe = 2 * peaks.least_seconds(*moe_gemm.launch_work(d, 8, 3, 4)) + \\
    2 * peaks.least_seconds(*moe_gemm.launch_work(d, 8, 3, 4))
flash = flash_decode_paged.layer_seconds([3, 4], 2, 1, 16) + \\
    flash_decode_paged.layer_seconds([3, 9], 2, 1, 16)
assert got["moe_gemm"] == pytest.approx(moe, rel=1e-12)
assert got["flash_decode_paged"] == pytest.approx(flash, rel=1e-12)
assert Probe.routes_unseen(types.SimpleNamespace(config=c, decode_calls=3,
                                                 decode_routes=[None] * 6)) == 0

# the check's logits are the reference's own tied, scaled head
ref = spec.reference_module(c)
g = weights.globals_(c, seed, "cpu", torch.float32)
prompt = np.array([5, 7, 11], dtype=np.int64)
toks = list(prompt)
served = []
for _ in range(4):
    h = ref.final_hidden(c, seed, [(torch.as_tensor(toks), 3)], "cpu", None)[0]
    served.append(int(ref.head(h[-1:], g, c, None).argmax(-1)))
    toks.append(served[-1])
got = check.gaps(c, seed, [(1, prompt, served)], "cpu")
assert got["max_logit_gap"] == 0.0 and got["tokens"] == 4
worse = check.gaps(c, seed, [(1, prompt, served[:-1] + [(served[-1] + 1) % V])], "cpu")
assert worse["max_logit_gap"] > 0.0
print("toy ok")
'''


def test_new_architecture_from_files_alone(tmp_path):
    """A copy of the benchmark takes a toy architecture (two layer kinds with
    different leaves, one windowed attention layer, MoE layers of two
    launches, a tied and scaled head) from a configuration, a layout and a
    reference file and entries in BENCHMARK.json alone; the copy's own
    harness, unedited, runs it."""
    root = tmp_path
    shutil.copytree(spec.BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    src = spec.find_cell("qwen3-burstgpt-mmpp")
    keep = ("name", "source", "port_arch", "rope_theta", "rms_norm_eps", "torch_dtype",
            "moe_capacity_factor", "moe_capacity_multiple", "engine", "check")
    config = {k: src.config[k] for k in keep}
    config.update(name="toy", architecture="toy_hybrid")
    (root / "bench" / "configs" / "toy.json").write_text(json.dumps(config))
    (root / "bench" / "layouts" / "toy_hybrid.py").write_text(TOY_LAYOUT)
    (root / "bench" / "reference" / "toy_hybrid.py").write_text(TOY_REFERENCE)
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "toy", "source": "https://example.org",
                             "file": "bench/configs/toy.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy",
                               "traffic": "qwen3-burstgpt-mmpp", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "toy_check.py").write_text(TOY_CHECK)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(spec.ROOT / "src")]))
    out = subprocess.run([sys.executable, "toy_check.py"], capture_output=True, text=True,
                         cwd=root, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("toy ok")
    assert not (spec.BENCH / "layouts" / "toy_hybrid.py").exists()
