"""The model's needed operations (2 a multiply-add) for one token: each
layer's count from the configuration's layout (``layer_flops`` of
``bench/layouts/<architecture>.py``: the projections, the mixer over the
positions the token attends to in that layer's ``window``, the routed
experts with the router and shared experts, or the dense FFN), and the
unembedding only where a token is sampled.  Padding, free decode rows and
experts computed for capacity slots are not counted."""
from __future__ import annotations

from bench import spec


def token(config: dict, ctx: int, sampled: bool) -> float:
    """One token that attends to ``ctx`` positions (itself included)."""
    lay = spec.layout_module(config)
    f = 0
    for l in range(config["num_hidden_layers"]):
        w = lay.window(config, l)
        f += lay.layer_flops(config, l, ctx if w is None else min(ctx, w))
    return f + (2 * config["hidden_size"] * config["vocab_size"] if sampled else 0)


def _span_sum(n: int, window):
    """The positions that tokens 1..n of a prompt attend to, summed."""
    if window is None or n <= window:
        return n * (n + 1) / 2
    return window * (window + 1) / 2 + (n - window) * window


def prefill(config: dict, prompt_len: int) -> float:
    """A prompt of ``prompt_len`` tokens, causal, sampling its last."""
    lay = spec.layout_module(config)
    per_tok, attended = 0, 0
    for l in range(config["num_hidden_layers"]):
        base = lay.layer_flops(config, l, 0)
        per_tok += base
        attended += lay.layer_flops(config, l, _span_sum(prompt_len, lay.window(config, l))) - base
    return prompt_len * per_tok + attended + 2 * config["hidden_size"] * config["vocab_size"]


def decode(config: dict, lengths) -> float:
    """One decode step of the active rows, each attending to ``length``
    positions."""
    return sum(token(config, int(c), True) for c in lengths)
