"""Leaf order and leaf paths of the port's nested trees, as ``jax.tree_util``
gives them for the reference's pytrees.

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or any
other objects) as leaves; ``None`` is an empty subtree, as in JAX.  Dict
keys are walked in sorted order, as JAX flattens a dict, so the optimizer's
summation order and a checkpoint's leaf files come out in the reference's
order, and each leaf's path is the string ``jax.tree_util.keystr`` gives
it: ``[0]['blocks']['attn']['wq']`` for a key or an index,
``[1].m['embed']['embedding']`` for a NamedTuple field.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, prefix: str) -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _walk(v, f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX's flatten order."""
    return list(_walk(tree, ""))


def leaves(tree) -> list:
    return [leaf for _, leaf in _walk(tree, "")]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure whose leaves, in flatten order, are
    ``new_leaves`` (any iterable, consumed exactly)."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each congruent tree of
    ``rest``, leaf by leaf in flatten order; the result has ``tree``'s
    structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, (fn(*args) for args in zip(leaves(tree), *others)))
