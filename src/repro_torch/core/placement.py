"""Port copy of ``repro.core.placement``: pure numpy with no framework in it,
kept line for line so both packages solve to identical slot maps.

Expert-level scheduling: placement algorithms (paper §III-D).

Three placement policies:
  * static_placement       — expert j on device j // (E/g)   (vLLM default EP)
  * eplb_placement         — activation-count greedy balance (conventional EPLB,
                             DeepSeek-style; the paper's ported baseline)
  * gimbal_placement       — Algorithm 3: affinity pairs pinned to the anchor
                             device, remaining experts greedy least-loaded

plus the exact MILP objective (Eq. 3-12) evaluated by brute force at toy scale
as a test oracle (`milp_exact`), and helpers computing the two objective terms
(row-wise imbalance D, communication cut) for any assignment.

An *assignment* maps logical expert -> device p in [0, g).  A *perm* maps
logical expert -> physical slot s in [0, E) with device(s) = s // (E/g); the
model's MoE layer consumes perms (see models/moe.py).

Replication (hot-expert redundancy, DeepSeek-EPLB-style): a *slot map* ``inv``
maps physical slot s in [0, S) -> logical expert, S = E + R, every expert in
at least one slot and the R redundant slots holding replicas of the hottest
experts.  Device of slot s = s // (S/g).  ``inv`` generalizes the perm (R=0:
``inv`` is the perm's inverse); the ``*_rep`` solvers and objective helpers
below operate on slot maps, splitting each expert's load equally across its
replicas.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------------
# assignment <-> permutation plumbing
# ---------------------------------------------------------------------------------

def assignment_to_perm(assign: np.ndarray, g: int) -> np.ndarray:
    """Pack experts of device p into slot range [p*E/g, (p+1)*E/g).
    Experts keep relative id order inside a device for determinism."""
    e = len(assign)
    cap = e // g
    perm = np.empty(e, np.int32)
    fill = [0] * g
    for j in range(e):
        p = int(assign[j])
        perm[j] = p * cap + fill[p]
        fill[p] += 1
    assert all(f == cap for f in fill), f"unbalanced assignment {fill}"
    return perm


def perm_to_assignment(perm: np.ndarray, g: int) -> np.ndarray:
    e = len(perm)
    return (np.asarray(perm) // (e // g)).astype(np.int32)


def static_placement(num_experts: int, g: int) -> np.ndarray:
    """vLLM default: contiguous blocks, no load awareness."""
    return assignment_to_perm(np.arange(num_experts) // (num_experts // g), g)


# ---------------------------------------------------------------------------------
# objective terms (Eq. 5-11)
# ---------------------------------------------------------------------------------

def row_imbalance(A: np.ndarray, assign: np.ndarray, g: int) -> float:
    """D = max_{i,p} |L_{i,p} - L_i|  (Eq. 8-9 tight bound)."""
    n, m = A.shape
    onehot = np.eye(g)[assign]                   # (m, g)
    loads = A @ onehot                           # (n, g)  L_{i,p}
    ideal = A.sum(1, keepdims=True) / g          # (n, 1)  L_i
    return float(np.abs(loads - ideal).max())


def comm_cut(W: np.ndarray, assign: np.ndarray) -> float:
    """Cut = sum_{j<k} (W_jk + W_kj) * [assign_j != assign_k]  (Eq. 11).
    The paper sums j<k over the symmetrized weight."""
    sym = W + W.T
    diff = assign[:, None] != assign[None, :]
    return float((sym * diff).sum() / 2.0)


def objective(A: np.ndarray, W: np.ndarray, assign: np.ndarray, g: int,
              alpha: float = 1.0, beta: float = 1.0) -> float:
    """Eq. 12: alpha * D + beta * Cut."""
    return alpha * row_imbalance(A, assign, g) + beta * comm_cut(W, assign)


# ---------------------------------------------------------------------------------
# conventional EPLB baseline (activation counts only)
# ---------------------------------------------------------------------------------

def eplb_placement(A: np.ndarray, g: int) -> np.ndarray:
    """Greedy least-loaded by total activation, capacity m/g per device."""
    m = A.shape[1]
    cap = m // g
    tot = A.sum(0)
    order = np.argsort(tot)[::-1]
    load = np.zeros(g)
    count = np.zeros(g, int)
    assign = np.empty(m, np.int32)
    for j in order:
        open_p = [p for p in range(g) if count[p] < cap]
        p = min(open_p, key=lambda q: load[q])
        assign[j] = p
        load[p] += tot[j]
        count[p] += 1
    return assignment_to_perm(assign, g)


# ---------------------------------------------------------------------------------
# Algorithm 3: Gimbal's affinity-anchored greedy placement
# ---------------------------------------------------------------------------------

def gimbal_placement(A: np.ndarray, W: np.ndarray, g: int, anchor: int = 0,
                     top_e: int = 16, min_weight: float = 0.0,
                     pairs: Optional[Sequence[Tuple[int, int]]] = None
                     ) -> np.ndarray:
    """Algorithm 3 (EXP-RELOCATION):

    line 2 — *Affinity placement*: every expert appearing in the affinity
      matrix M (the top-E strongest W entries, or caller-provided `pairs`)
      goes to the anchor device `anchor`.  If they exceed anchor capacity,
      M is tightened (strongest pairs first) until they fit — the paper's
      "tightening the statistical threshold / reducing top-E" rule.
    line 3 — *Greedy balancing*: remaining experts assigned to devices 0..g-1
      by descending activation with a least-loaded policy, respecting the
      m/g capacity constraint (Eq. 4).
    """
    n, m = A.shape
    cap = m // g
    assert m % g == 0, "num experts must divide device count"

    # --- build M: strongest inter-layer pairs ------------------------------------
    if pairs is None:
        w = W.copy().astype(float)
        np.fill_diagonal(w, 0.0)
        order = np.argsort(w.reshape(-1))[::-1]
        pairs = []
        for idx in order[: max(top_e, 0)]:
            val = w.reshape(-1)[idx]
            if val <= min_weight:
                break
            j, k = divmod(int(idx), m)
            pairs.append((j, k))

    anchored: List[int] = []
    seen = set()
    for j, k in pairs:                 # strongest first; tighten to fit capacity
        for x in (j, k):
            if x not in seen and len(anchored) < cap:
                seen.add(x)
                anchored.append(x)
        if len(anchored) >= cap:
            break

    assign = np.full(m, -1, np.int32)
    load = np.zeros(g)
    count = np.zeros(g, int)
    for x in anchored:                                     # line 2
        assign[x] = anchor
        load[anchor] += A.sum(0)[x]
        count[anchor] += 1

    tot = A.sum(0)
    rest = [j for j in range(m) if assign[j] < 0]
    for j in sorted(rest, key=lambda x: -tot[x]):          # line 3
        open_p = [p for p in range(g) if count[p] < cap]
        p = min(open_p, key=lambda q: load[q])
        assign[j] = p
        load[p] += tot[j]
        count[p] += 1
    return assignment_to_perm(assign, g)


# ---------------------------------------------------------------------------------
# exact MILP oracle (toy scale) — Eq. 3-12 by exhaustive balanced partitioning
# ---------------------------------------------------------------------------------

def _balanced_partitions(m: int, g: int):
    """Yield every assignment of m items into g groups of exactly m/g,
    with group-symmetry broken (item 0 always in group 0)."""
    cap = m // g

    def rec(remaining: List[int], assign: np.ndarray, p: int):
        if p == g - 1:
            for j in remaining:
                assign[j] = p
            yield assign.copy()
            for j in remaining:
                assign[j] = -1
            return
        pool = remaining
        anchor_item = pool[0]  # symmetry break: lowest remaining id pins this group
        for combo in itertools.combinations(pool[1:], cap - 1):
            chosen = (anchor_item,) + combo
            for j in chosen:
                assign[j] = p
            rest = [j for j in pool if j not in chosen]
            yield from rec(rest, assign, p + 1)
            for j in chosen:
                assign[j] = -1

    yield from rec(list(range(m)), np.full(m, -1, np.int32), 0)


def milp_exact(A: np.ndarray, W: np.ndarray, g: int, alpha: float = 1.0,
               beta: float = 1.0, max_items: int = 12
               ) -> Tuple[np.ndarray, float]:
    """Exhaustive optimum of Eq. 12 under Eq. 3-4.  Only for m <= max_items."""
    n, m = A.shape
    if m > max_items:
        raise ValueError(f"milp_exact is a toy oracle; m={m} > {max_items}")
    best, best_val = None, np.inf
    for assign in _balanced_partitions(m, g):
        val = objective(A, W, assign, g, alpha, beta)
        if val < best_val:
            best, best_val = assign.copy(), val
    return best, float(best_val)


# ---------------------------------------------------------------------------------
# migration accounting (for the simulator + EXPERIMENTS)
# ---------------------------------------------------------------------------------

def migration_cost(old_perm: np.ndarray, new_perm: np.ndarray, g: int,
                   bytes_per_expert: int) -> Tuple[int, int]:
    """(num experts that changed device, bytes moved across the interconnect)."""
    old_dev = perm_to_assignment(old_perm, g)
    new_dev = perm_to_assignment(new_perm, g)
    moved = int((old_dev != new_dev).sum())
    return moved, moved * bytes_per_expert


# ---------------------------------------------------------------------------------
# replicated placements: slot maps over S = E + R physical slots
# ---------------------------------------------------------------------------------

def perm_to_slot_map(perm: np.ndarray) -> np.ndarray:
    """inv[s] = logical expert in slot s (the R=0 slot map)."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv.astype(np.int32)


def slot_devices(num_slots: int, g: int) -> np.ndarray:
    """Device owning each slot: contiguous blocks of S/g slots per device."""
    assert num_slots % g == 0, f"device count {g} must divide slot count {num_slots}"
    return (np.arange(num_slots) // (num_slots // g)).astype(np.int32)


def replica_counts(tot: np.ndarray, num_slots: int) -> np.ndarray:
    """How many slots each logical expert gets (every expert >= 1; the R
    redundant slots go greedily to whichever expert currently has the highest
    per-replica load — the water-filling rule conventional EPLB replication
    uses)."""
    e = len(tot)
    assert num_slots >= e, "need at least one slot per expert"
    counts = np.ones(e, np.int64)
    for _ in range(num_slots - e):
        counts[int(np.argmax(tot / counts))] += 1
    return counts


def _pack_copies(copy_expert: Sequence[int], copy_dev: Sequence[int], g: int,
                 cap: int) -> np.ndarray:
    """Canonical slot map from per-copy device assignments: each device's
    copies sorted by logical expert id into its contiguous slot block."""
    s = len(copy_expert)
    inv = np.empty(s, np.int32)
    fill = 0
    for p in range(g):
        mine = sorted(ce for ce, cd in zip(copy_expert, copy_dev) if cd == p)
        assert len(mine) == cap, f"device {p} holds {len(mine)} != cap {cap}"
        inv[fill:fill + cap] = mine
        fill += cap
    return inv


def _greedy_place_copies(tot: np.ndarray, counts: np.ndarray, g: int,
                         cap: int, load: np.ndarray, count: np.ndarray,
                         placed: List[Tuple[int, int]]) -> None:
    """Assign every not-yet-placed expert copy to a device: heaviest
    per-replica load first, least-loaded open device, avoiding devices that
    already host a copy of the same expert when possible (a same-device
    replica splits nothing)."""
    have = {}
    for ce, cd in placed:
        have.setdefault(ce, set()).add(cd)
    todo: List[Tuple[float, int]] = []
    for j in range(len(tot)):
        n_left = counts[j] - len([1 for ce, _ in placed if ce == j])
        todo += [(tot[j] / counts[j], j)] * int(n_left)
    for share, j in sorted(todo, key=lambda x: -x[0]):
        open_p = [p for p in range(g) if count[p] < cap]
        fresh = [p for p in open_p if p not in have.get(j, ())]
        p = min(fresh or open_p, key=lambda q: load[q])
        placed.append((j, p))
        have.setdefault(j, set()).add(p)
        load[p] += share
        count[p] += 1


def eplb_placement_rep(A: np.ndarray, g: int, redundancy: int) -> np.ndarray:
    """Replicated EPLB: hottest experts get the R redundant slots, copies
    packed greedy least-loaded with each copy carrying tot/n_copies load.
    Returns a slot map inv (E+R,)."""
    m = A.shape[1]
    s = m + redundancy
    assert s % g == 0, f"device count {g} must divide E+R={s}"
    cap = s // g
    tot = A.sum(0)
    counts = replica_counts(tot, s)
    load = np.zeros(g)
    count = np.zeros(g, int)
    placed: List[Tuple[int, int]] = []
    _greedy_place_copies(tot, counts, g, cap, load, count, placed)
    return _pack_copies([ce for ce, _ in placed], [cd for _, cd in placed],
                        g, cap)


def gimbal_placement_rep(A: np.ndarray, W: np.ndarray, g: int,
                         redundancy: int, anchor: int = 0, top_e: int = 16,
                         min_weight: float = 0.0) -> np.ndarray:
    """Algorithm 3 with hot-expert replication: the affinity-anchored experts
    keep ONE copy pinned to the anchor device (line 2 — replicas of an
    anchored expert may still land elsewhere to shed load), then every
    remaining copy is placed greedy least-loaded (line 3).  Returns a slot
    map inv (E+R,)."""
    n, m = A.shape
    s = m + redundancy
    assert s % g == 0, f"device count {g} must divide E+R={s}"
    cap = s // g
    tot = A.sum(0)
    counts = replica_counts(tot, s)

    w = W.copy().astype(float)
    np.fill_diagonal(w, 0.0)
    order = np.argsort(w.reshape(-1))[::-1]
    anchored: List[int] = []
    seen = set()
    for idx in order[: max(top_e, 0)]:
        if w.reshape(-1)[idx] <= min_weight:
            break
        j, k = divmod(int(idx), m)
        for x in (j, k):
            if x not in seen and len(anchored) < cap:
                seen.add(x)
                anchored.append(x)
        if len(anchored) >= cap:
            break

    load = np.zeros(g)
    count = np.zeros(g, int)
    placed: List[Tuple[int, int]] = []
    for x in anchored:
        placed.append((x, anchor))
        load[anchor] += tot[x] / counts[x]
        count[anchor] += 1
    _greedy_place_copies(tot, counts, g, cap, load, count, placed)
    return _pack_copies([ce for ce, _ in placed], [cd for _, cd in placed],
                        g, cap)


def rep_device_fractions(inv: np.ndarray, num_experts: int, g: int
                         ) -> np.ndarray:
    """F[e, p] = fraction of expert e's copies living on device p (rows sum
    to 1) — the load split replica dispatch realizes."""
    inv = np.asarray(inv)
    dev = slot_devices(len(inv), g)
    f = np.zeros((num_experts, g))
    np.add.at(f, (inv, dev), 1.0)
    return f / f.sum(1, keepdims=True)


def rep_row_imbalance(A: np.ndarray, inv: np.ndarray, g: int) -> float:
    """Eq. 8-9 generalized: per-device load with each expert's activations
    split equally across its replicas."""
    frac = rep_device_fractions(inv, A.shape[1], g)      # (E, g)
    loads = A @ frac                                     # (L, g)
    ideal = A.sum(1, keepdims=True) / g
    return float(np.abs(loads - ideal).max())


def rep_comm_cut(W: np.ndarray, inv: np.ndarray, g: int) -> float:
    """Eq. 11 generalized: pair (j, k) crosses a device boundary with
    probability 1 - sum_p F[j,p]*F[k,p] under uniform replica dispatch.
    Diagonal excluded, matching ``comm_cut``."""
    frac = rep_device_fractions(inv, W.shape[0], g)
    colocate = frac @ frac.T                             # (E, E)
    cross = 1.0 - colocate
    np.fill_diagonal(cross, 0.0)
    return float((W * cross).sum())


def placement_coupling(A: np.ndarray, W: np.ndarray, slot_map: np.ndarray,
                       g: int) -> Tuple[float, float]:
    """The two MoE coupling factors recomputed from a (possibly replicated)
    placement — the numbers the expert level hands the cost model
    (the simulator's cost model reads them):

      * ``moe_mult``   — hotspot multiplier: hottest device's expert load /
                         mean device load (per layer, averaged), with each
                         expert's activations split equally across its
                         replicas' devices;
      * ``cross_frac`` — fraction of inter-layer expert traffic crossing a
                         device boundary (pair (j, k) crosses with
                         probability 1 - sum_p F[j,p]*F[k,p] under uniform
                         replica dispatch).

    A: (L, E) activation counts; W: (E, E) inter-layer traffic; slot_map:
    (S,) slot -> logical expert (S = E means no replication)."""
    frac = rep_device_fractions(slot_map, A.shape[1], g)   # (E, g)
    loads = A @ frac                                       # (L, g)
    moe_mult = float(np.mean(loads.max(1) / np.maximum(loads.mean(1), 1e-9)))
    cross_frac = float(rep_comm_cut(W, slot_map, g) / max(W.sum(), 1e-9))
    return moe_mult, cross_frac


def rep_migration_cost(old_inv: np.ndarray, new_inv: np.ndarray, g: int,
                       bytes_per_expert: int) -> Tuple[int, int]:
    """Expert-copy transfers to realize ``new_inv`` from ``old_inv``: a copy
    of expert e materializing on a device that did not already hold e costs
    one expert transfer over the interconnect."""
    old_inv, new_inv = np.asarray(old_inv), np.asarray(new_inv)
    old_dev = slot_devices(len(old_inv), g)
    new_dev = slot_devices(len(new_inv), g)
    old_has = {(int(e), int(p)) for e, p in zip(old_inv, old_dev)}
    moved = len({(int(e), int(p)) for e, p in zip(new_inv, new_dev)}
                - old_has)
    return moved, moved * bytes_per_expert
