"""The benchmark on the card (marker ``card``; each skips without one):
the weights drawn for the program equal those the reference draws again,
and the float8 control of each cell fails one of its ``check`` limits
while the program passes them all, at the cell's own widths and window.

    python3 -m pytest -q bench/tests/test_bench_card.py -m card
"""
import pytest
import torch

from bench import spec, weights

CELLS = ("qwen3-burstgpt-mmpp", "dsv2-reasoning-closed")


@pytest.mark.card
def test_weights_drawn_alike_on_card(card):
    from bench.tests.tiny import tiny_cell
    for name in CELLS:
        cell, _ = tiny_cell(name, dtype="bfloat16")
        c = cell.config
        params = weights.program_params(c, 2**31 + 5, card)
        lay = spec.layout_module(c)
        n_pro = next(l for l in range(c["num_hidden_layers"]) if lay.is_moe_layer(c, l))
        again = weights.layer(c, 2**31 + 5, n_pro + 1, card)
        moe = params["blocks"]["moe"]
        assert torch.equal(moe["w_gate"][1], again["w_gate"])
        assert torch.equal(params["blocks"]["attn_norm"]["scale"][1], again["attn_norm"])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_program_passes_on_card(card, name):
    from bench import run as R
    cell = spec.find_cell(name)
    from bench.check import compared
    seconds = spec.load_benchmark()["run_seconds"]    # the window that finishes requests to compare
    res = R.run_cell(cell, 2**31 + 99, seconds, False, device=card, control=True)
    limits = {k: cell.config["check"][k] for k in compared(cell.config["check"])}
    assert all(res["checks"][k]["value"] <= v for k, v in limits.items())
    assert any(res["window"]["gaps"]["control_" + k] > v for k, v in limits.items())
