"""Expert activation + inter-layer affinity statistics (paper §III-D, Figs.
3-4), ported from ``repro.core.affinity``.

Consumes the per-layer expert ids that moe_apply(return_stats=True) emits
((L, B, S, K) logical ids per layer) and accumulates:

  * A  (n_layers, E)  — activation counts per expert per layer (Eq. 1)
  * W  (E, E)         — aggregated inter-layer traffic W[j,k] = sum_i E_{i,j,k}
                        (Eq. 2): expert j selected at layer i and expert k at
                        layer i+1 by the same token.

The reference accumulates with a jitted scatter-add; here it is
``np.bincount`` on the host, where the ids already are (the backend copies
them off the device with the step's tokens), with the same integer counts.
``synthetic_stats`` takes an integer seed where the reference takes a
``jax.random`` key: the reference seeds numpy with the sum of the key's data,
which is ``[0, s]`` for ``key(s)``, so ``s % 2**31`` draws the same prior.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def accumulate_stats(expert_ids, num_experts: int) -> Tuple[np.ndarray, np.ndarray]:
    """expert_ids: (L, B, S, K) int logical expert ids.
    Returns (A (L, E) int32 counts, W (E, E) int32 inter-layer pair counts)."""
    ids = np.asarray(expert_ids).astype(np.int64)
    l, b, s, k = ids.shape
    flat = ids.reshape(l, b * s, k)
    layer = np.arange(l, dtype=np.int64)[:, None, None] * num_experts
    a = np.bincount((flat + layer).reshape(-1),
                    minlength=l * num_experts).reshape(l, num_experts)
    # inter-layer pairs: token t selects ids[i, t, :] then ids[i+1, t, :]
    up, dn = flat[:-1], flat[1:]                                          # (L-1, T, K)
    pair_idx = up[..., :, None] * num_experts + dn[..., None, :]          # (L-1,T,K,K)
    w = np.bincount(pair_idx.reshape(-1), minlength=num_experts * num_experts
                    ).reshape(num_experts, num_experts)
    return a.astype(np.int32), w.astype(np.int32)


class AffinityTracker:
    """Host-side accumulator with exponential decay (recent traffic dominates,
    matching the paper's 'recent activation statistics' in Alg. 3)."""

    def __init__(self, num_layers: int, num_experts: int, decay: float = 1.0):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.decay = decay
        self.A = np.zeros((num_layers, num_experts), np.float64)
        self.W = np.zeros((num_experts, num_experts), np.float64)
        self.tokens_seen = 0

    def update(self, expert_ids) -> None:
        ids = np.asarray(expert_ids)
        a, w = accumulate_stats(ids, self.num_experts)
        if self.decay < 1.0:
            self.A *= self.decay
            self.W *= self.decay
        self.A += np.asarray(a, np.float64)
        self.W += np.asarray(w, np.float64)
        self.tokens_seen += int(np.prod(ids.shape[1:3]))

    # --- paper Fig. 4: retain only the strongest dependencies ---------------------
    def affinity_pairs(self, top_e: int = 16, min_count: float = 0.0
                       ) -> List[Tuple[int, int, float]]:
        """Top-E strongest (j, k, weight) inter-layer expert pairs, j != k."""
        w = self.W.copy()
        np.fill_diagonal(w, 0.0)
        flat = w.reshape(-1)
        order = np.argsort(flat)[::-1]
        out = []
        for idx in order[: top_e * 4]:
            val = flat[idx]
            if val <= min_count or len(out) >= top_e:
                break
            j, k = divmod(int(idx), self.num_experts)
            out.append((j, k, float(val)))
        return out

    def hot_experts(self, quantile: float = 0.9) -> np.ndarray:
        """Experts whose total activation exceeds the given quantile (Fig. 3)."""
        tot = self.A.sum(0)
        thr = np.quantile(tot, quantile)
        return np.where(tot >= thr)[0]

    def imbalance(self) -> float:
        """Mean over layers of (max expert load / mean expert load) — the
        hotspot severity signal motivating EDR."""
        a = self.A + 1e-9
        return float(np.mean(a.max(1) / a.mean(1)))


def synthetic_stats(seed: int, num_layers: int, num_experts: int, tokens: int = 100_000,
                    hot_frac: float = 0.1, hot_boost: float = 8.0,
                    n_affine_pairs: int = 12, affine_strength: float = 6.0,
                    top_k: int = 2):
    """Generate Fig.3/Fig.4-shaped statistics without model weights: a few hot
    experts per layer and sparse strong inter-layer pairs (paper §III-D notes
    strong dependencies are 'sparse and localized').

    ``seed`` (0 <= seed < 2**32) plays the reference's ``key(seed)``.
    Returns (A (L,E) float, W (E,E) float, pairs list)."""
    seed = int(seed)
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    rng = np.random.default_rng(seed % (2**31))
    n_hot = max(1, int(num_experts * hot_frac))
    A = np.zeros((num_layers, num_experts))
    base = rng.dirichlet(np.ones(num_experts) * 4.0, size=num_layers)
    for i in range(num_layers):
        hot = rng.choice(num_experts, n_hot, replace=False)
        base[i, hot] *= hot_boost
        base[i] /= base[i].sum()
        A[i] = base[i] * tokens * top_k
    W = np.outer(A.mean(0), A.mean(0)) / (tokens * top_k)  # weak background coupling
    pairs = []
    for _ in range(n_affine_pairs):
        j, k = rng.choice(num_experts, 2, replace=False)
        W[j, k] += affine_strength * W.mean() * num_experts
        pairs.append((int(j), int(k)))
    return A, W, pairs
