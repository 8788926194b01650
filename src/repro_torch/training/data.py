"""Deterministic synthetic token pipeline: seeded, shardable, restartable.
A verbatim copy of ``repro.training.data`` (numpy only): the same
(config, step) gives the same batch, bit for bit, in both packages.

Each (step, host) pair maps to a unique counter-based RNG stream, so
  * restarting from a checkpoint replays the exact same batches,
  * every host draws disjoint data without communication,
  * elastic resizes only change the host->shard mapping, not the stream.

The generator emulates language-like statistics (Zipfian unigram mix with
short-range repetition) so MoE routers see non-uniform token distributions —
important when exercising the paper's expert-hotspot machinery (Fig. 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    repeat_p: float = 0.25       # short-range token repetition probability
    num_hosts: int = 1
    host_id: int = 0


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


class TokenStream:
    """Stateless per-step batch synthesis: batch_at(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.num_hosts == 0
        self.local_batch = cfg.global_batch // cfg.num_hosts
        self._probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """{"tokens": (local_B, S) int32, "labels": (local_B, S) int32} —
        labels are next-token shifted."""
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id]))
        b, s = self.local_batch, c.seq_len
        toks = rng.choice(c.vocab_size, size=(b, s + 1), p=self._probs)
        # short-range repetition: with prob repeat_p copy a recent token
        rep = rng.random((b, s + 1)) < c.repeat_p
        back = rng.integers(1, 8, size=(b, s + 1))
        idx = np.maximum(np.arange(s + 1)[None, :] - back, 0)
        toks = np.where(rep, np.take_along_axis(toks, idx, axis=1), toks)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def pack_documents(doc_lens, seq_len: int) -> Tuple[np.ndarray, int]:
    """First-fit document packing into fixed seq_len rows (utility exercised
    by tests; production pipelines pack variable docs into train rows).
    Returns (row assignment per doc, rows used)."""
    rows: list = []
    assign = np.full(len(doc_lens), -1, np.int32)
    for i, ln in enumerate(doc_lens):
        ln = min(int(ln), seq_len)
        for r, free in enumerate(rows):
            if free >= ln:
                rows[r] -= ln
                assign[i] = r
                break
        else:
            rows.append(seq_len - ln)
            assign[i] = len(rows) - 1
    return assign, len(rows)
