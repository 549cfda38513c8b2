"""Parameter trees: nested dicts, lists and tuples of tensors, walked in
the JAX package's pytree order (dict keys sorted, sequences in order).

Where that order sets a float sum (the norms of the fed round, the flat
(K, D) buffer of ``fed_aggregate_tree``), it then runs as JAX's does.
"""
from __future__ import annotations

from typing import Callable, List

__all__ = ["tree_leaves", "tree_map"]


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), visited in JAX's order; the
    result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)
