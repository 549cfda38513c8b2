"""Parameter trees: nested dicts, lists and tuples of tensors, walked in
the JAX package's pytree order (dict keys sorted, sequences in order).

Where that order sets a float sum (the norms of the fed round, the flat
(K, D) buffer of ``fed_aggregate_tree``), it then runs as JAX's does.
A named tuple (an optimizer's state) is a sequence of its fields.
"""
from __future__ import annotations

from typing import Callable, List

__all__ = ["tree_leaves", "tree_leaves_with_path", "tree_map",
           "tree_unflatten"]


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_leaves_with_path(tree, is_leaf=None, path: tuple = ()) -> List:
    """``(path, leaf)`` pairs in JAX's order; a path is the tuple of dict
    keys and sequence indices from the root to the leaf (JAX's
    ``tree_flatten_with_path`` keys, as ``str`` shows them).  A node for
    which ``is_leaf`` is true is a leaf (a ``ShapeDtype``, say)."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], is_leaf, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in tree_leaves_with_path(t, is_leaf, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, items):
    """``tree``'s container type around ``items``."""
    if hasattr(tree, "_fields"):            # a named tuple
        return type(tree)(*items)
    return type(tree)(items)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), visited in JAX's order; the
    result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, t, *(r[i] for r in rest))
                               for i, t in enumerate(tree)])
    return fn(tree, *rest)


def tree_unflatten(tree, leaves, is_leaf=None):
    """``tree``'s structure (its leaves as :func:`tree_leaves_with_path`
    finds them) with ``leaves``, in JAX's order, in their place."""
    it = iter(leaves)

    def build(node):
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [build(t) for t in node])
        return next(it)
    out = build(tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out
