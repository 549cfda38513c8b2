"""Checkpointing: flat-path npz files of parameter trees (port of
``repro.checkpoint.ckpt``).

Server state in federated training is (params, server-opt state, rate
tracker r(t), round counter, RNG key).  Saving r(t) matters: F3AST's
selection policy is exactly the learned rate — losing it on restart resets
the policy to the burn-in phase (paper Thm B.1).

The file layout is the JAX package's, so a checkpoint written by either
package loads in the other bit for bit: leaves in JAX's pytree order
(``repro_torch.tree``), each under its path of dict keys and list indices
joined by ``"|"`` (``_root`` for a bare leaf), in ``<tag>_<step:08d>.npz``
written to ``.tmp.npz`` first and moved into place.
"""
from __future__ import annotations

import os
import re
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from ..convert import _leaf_from_numpy, _leaf_to_numpy

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]

_SEP = "|"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[tuple]:
    """(path, leaf) pairs in JAX's leaf order; a path entry is what JAX's
    ``getattr(p, "key", getattr(p, "idx", p))`` prints: a dict key, a
    sequence index, ``.field`` for a named tuple.  ``None`` is an empty
    subtree, as in JAX."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _paths(getattr(tree, f), prefix + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (str(i),))
    else:
        yield prefix, tree


def _key(path) -> str:
    return _SEP.join(path) or "_root"


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return _leaf_to_numpy(leaf)
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {_key(path): _to_numpy(leaf) for path, leaf in _paths(tree)}


def save_checkpoint(directory: str, step: int, tree: Any,
                    tag: str = "state") -> str:
    """Write ``tree`` (tensors on any device, numpy arrays, scalars) to
    ``<directory>/<tag>_<step:08d>.npz``; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{tag}_{step:08d}.npz")
    tmp = path + ".tmp.npz"   # np.savez keeps names already ending in .npz
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)
    return path


def _rebuild(like, leaves: Iterator):
    """``like``'s structure with its leaves taken from ``leaves`` in
    order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(t, leaves) for t in like)
    return next(leaves)


def restore_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf shape-checked and
    given the dtype of ``like``'s leaf, and its device where that is a
    tensor (a numpy leaf comes back as numpy)."""
    out = []
    with np.load(path) as data:
        for p, leaf in _paths(like):
            key = _key(p)
            arr = data[key]
            shape = tuple(leaf.shape) if torch.is_tensor(leaf) \
                else tuple(np.shape(leaf))
            assert arr.shape == shape, (key, arr.shape, shape)
            if torch.is_tensor(leaf):
                out.append(_leaf_from_numpy(arr, leaf.device).to(leaf.dtype))
            else:
                out.append(arr.astype(np.asarray(leaf).dtype))
    return _rebuild(like, iter(out))


def latest_step(directory: str, tag: str = "state") -> Optional[int]:
    """The largest step saved under ``tag`` in ``directory`` (None if
    none)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(rf"{tag}_(\d+)\.npz$", f))]
    return max(steps) if steps else None
