"""The comparison that decides ``correct``: the served tokens of a sample
of finished requests against the plain float32 reference.

The reference runs once over each sampled prompt followed by its served
tokens (teacher-forced) and reads, at each position that produced a served
token, by how much that token's logit lies below the reference's best
logit there.  Greedy decoding serves the program's own best token, so a
sound program lies below the reference's best only by its rounding.  The
run is correct while each number of these gaps that the configuration's
``check`` names (``summary``: their mean, a quantile) stays under its
limit there.

A decode step holds each expert to a capacity over every row of the batch,
idle rows included, so whether a request's selection is dropped there
depends on the other rows; the reference takes those decisions from the
program (``serve.Probe.decode_drops``), and the run checks them by
themselves: the router's capacity positions against the plain
token-major count (``serve.Probe.capacity_mismatches``).  The prompt's
capacity the reference computes itself.

The mean and not the widest gap: with a vocabulary of 10^5 random
logits the best few lie close together, so bfloat16 rounding already
serves another token at about a tenth of the positions, and the widest of
some hundreds of such gaps reads as high as float8's (PERF.md, section 2).
How often and how far the served tokens fall behind is what separates the
two: the mean.

The control (``control=True``) reads the same sequences again through the
reference in float8 (``common.Precision``) and takes, at each position, the
gap of the token float8 puts first: what a program computing one precision
below the configuration's bfloat16 would serve.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench import spec, weights
from bench.reference.common import Precision, head, no_tf32
from bench.traffic import subseed

# positions whose logits are made at once (a block of (rows, vocabulary) f32)
HEAD_BLOCK = 256


def sample(finished: Sequence[Tuple[int, np.ndarray, List[int]]], seed: int,
           min_tokens: int, max_requests: int) -> List[Tuple[int, np.ndarray, List[int]]]:
    """The finished request that served the most tokens, then others drawn
    from the seed, until ``min_tokens`` served tokens or ``max_requests``."""
    if not finished:
        return []
    order = sorted(finished, key=lambda f: (-len(f[2]), f[0]))
    rest = order[1:]
    rng = np.random.default_rng(subseed(seed, "sample"))
    picked = [order[0]] + [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for f in picked:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(f)
        n += len(f[2])
    return out


def _seqs(samples, device):
    return [(torch.as_tensor(np.concatenate([prompt, np.asarray(served[:-1], np.int64)]),
                             device=device), len(prompt)) for _, prompt, served in samples]


def _logit_blocks(h: torch.Tensor, plen: int, g: dict, config: dict, p: Precision, head_):
    """(first row, logits) over the positions that produced served tokens."""
    for a in range(plen - 1, h.shape[0], HEAD_BLOCK):
        b = min(a + HEAD_BLOCK, h.shape[0])
        yield a - (plen - 1), head_(h[a:b], g, config, p)


def gaps(config: dict, seed: int, samples, device, control: bool = False,
         drops=None) -> Dict[str, float]:
    """The served tokens' gaps (``summary``), and with ``control`` the same
    of float8's first tokens under ``control_`` names.  ``drops[i]``: the
    experts the program's decode steps dropped from sample i's rows
    (``serve.Probe.decode_drops``), which both references follow.  The
    logits are the reference's own ``head`` where it has one."""
    no_tf32()
    ref = spec.reference_module(config)
    head_ = getattr(ref, "head", head)
    seqs = _seqs(samples, device)
    chosen = None
    if control:
        p8 = Precision(fp8=True)
        g8 = weights.globals_(config, seed, device, torch.float32)
        chosen = []
        for (_, plen), h in zip(seqs, ref.final_hidden(config, seed, seqs, device, p8, drops)):
            rows = [lg.argmax(-1) for _, lg in _logit_blocks(h, plen, g8, config, p8, head_)]
            chosen.append(torch.cat(rows))
        del g8
        gc.collect()
    p32 = Precision()
    g = weights.globals_(config, seed, device, torch.float32)
    served_gaps, ctrl_gaps, per_request = [], [], []
    hidden = ref.final_hidden(config, seed, seqs, device, p32, drops)
    for i, ((_, plen), h) in enumerate(zip(seqs, hidden)):
        served = torch.as_tensor(samples[i][2], device=device)
        mine = []
        for a, lg in _logit_blocks(h, plen, g, config, p32, head_):
            rows = torch.arange(lg.shape[0], device=device)
            best = lg.max(-1).values
            mine.append(best - lg[rows, served[a:a + lg.shape[0]]])
            if chosen is not None:
                ctrl_gaps.append(best - lg[rows, chosen[i][a:a + lg.shape[0]]])
        mine = torch.cat(mine).double().cpu().numpy()
        served_gaps.append(mine)
        per_request.append((samples[i][0], float(mine.mean()), float(mine.max()),
                            float((mine > 0).mean()), int(mine.size)))
    out = {"requests": len(samples), "per_request": per_request}
    out.update(summary(np.concatenate(served_gaps), ""))
    if control:
        out.update(summary(torch.cat(ctrl_gaps).double().cpu().numpy(), "control_"))
    return out


def compared(check_cfg: dict) -> List[str]:
    """The numbers of ``summary`` that a configuration's ``check`` holds to a
    limit: every key of it but the sample's size."""
    return [k for k in check_cfg if k not in ("min_tokens", "max_requests")]


def summary(gaps: np.ndarray, prefix: str) -> Dict[str, float]:
    """The numbers read from one side's gaps."""
    return {prefix + "max_logit_gap": float(gaps.max()),
            prefix + "mean_logit_gap": float(gaps.mean()),
            prefix + "p99_logit_gap": float(np.quantile(gaps, 0.99)),
            prefix + "p90_logit_gap": float(np.quantile(gaps, 0.90)),
            prefix + "flip_share": float((gaps > 0).mean()),
            prefix + "tokens": int(gaps.size)}
