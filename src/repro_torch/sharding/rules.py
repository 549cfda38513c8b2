"""Sharding rules of the port (``repro.sharding.rules``): the model axis
of the (clients, model) mesh and the client dimension.

**The model axis.**  :func:`spec_for_leaf` assigns each parameter leaf a
tensor-parallel dim for the ``model`` mesh axis by name hint
(Megatron-style: in-projections shard their output dim, out-projections
their input dim, embeddings their vocab dim), falling back to the largest
divisible dim, falling back to replication; with ``fsdp_axes`` it also
places an FSDP split (fused onto the model dim where divisible).  Leaves
under the stacked-layer collections (:data:`STACKED_KEYS`) never shard
their leading (layer) dim.  :func:`model_specs` maps it over a tree,
:func:`client_model_specs` composes it with the client dimension and
:func:`state_specs_like` gives an optimizer state its parameters' specs.

A spec is a plain tuple with one entry per tensor dimension: None, an
axis name, or a tuple of names (what JAX's ``PartitionSpec`` holds), made
by :func:`P`.  A mesh is anything with a ``shape`` mapping from axis name
to size (``launch.mesh.FedMesh``, ``ClientMesh``).  Paths are the tree
paths of ``tree.tree_leaves_with_path`` joined with ``/``, so the name
hints match the same leaves as in the JAX package.

**The client dimension.**  The sharded engine pads the client dimension
to a multiple of the clients axis' size × 32 and gives each shard one
block of it.  A leaf of an availability process's state carries the
client dimension when its first dimension is N; the others (a cluster
chain, a round counter) stay replicated.

**The serving programs.**  :func:`param_shardings`, :func:`batch_shardings`
and :func:`decode_state_shardings` give the spec trees of JAX's
``in_shardings`` (the specs its ``NamedSharding`` s hold, entry for entry).
:func:`local_blocks` carves a rank's blocks out of a full tree by a spec
tree (over a mesh of any number of axes: the engine's model axis alone,
or a serving program's), :func:`gather_full` gathers them back.
``decode_state_shardings`` puts the model axis on a cache's last dim,
head_dim; the programs of ``launch.steps`` hold their caches by kv heads
instead (each rank's attention reads whole heads), which that module
states.
"""
from __future__ import annotations

import math
import re
from typing import NamedTuple, Optional, Tuple

import torch

from ..tree import (tree_leaves, tree_leaves_with_path, tree_map,
                    tree_unflatten)

__all__ = ["P", "STACKED_KEYS", "spec_for_leaf", "model_specs",
           "client_model_specs", "state_specs_like", "model_dim",
           "specs_up_to", "local_blocks", "gather_full", "param_shardings",
           "batch_shardings", "decode_state_shardings", "any_client_leaf",
           "client_dim_flags", "map_client_leaves", "pad_client_dim"]

STACKED_KEYS = ("blocks", "groups", "tail", "enc_blocks", "dec_blocks",
                "lstm")

# name hint -> preferred model-parallel dim ("last" = output dim of an
# in-projection, "first" = input dim of an out-projection)
_MODEL_DIM_HINTS = [
    (re.compile(r"(wq|wk|wv|w1|w3|wx|wy|w_i|w_a|in_proj|router|fc_w|out_w)$"),
     "last"),
    (re.compile(r"(wo|w2|out_proj|proj)$"), "first"),
    # unembed before embed: "unembed" also matches the embed$ search
    (re.compile(r"unembed$"), "last"),      # vocab-parallel unembedding
    (re.compile(r"embed$"), "first"),       # vocab-parallel embedding
]


def P(*entries) -> tuple:
    """A partition spec: one entry a tensor dimension, each None
    (replicated), an axis name or a tuple of names; a tuple of one name is
    that name, as JAX's ``PartitionSpec`` holds it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


class _Shape(NamedTuple):
    shape: tuple


def _has_shape(x) -> bool:
    return hasattr(x, "shape")


def _path_str(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def _pick_dim(shape, start, size, taken, prefer: Optional[str]):
    """Pick a dim >= start, divisible by size, not in taken."""
    cands = [d for d in range(start, len(shape))
             if d not in taken and shape[d] % size == 0 and shape[d] >= size]
    if not cands:
        return None
    if prefer == "last":
        return (cands[-1] if (len(shape) - 1) in cands
                else max(cands, key=lambda d: (shape[d], d)))
    if prefer == "first":
        return (cands[0] if start in cands
                else max(cands, key=lambda d: (shape[d], -d)))
    return max(cands, key=lambda d: (shape[d], d))


def spec_for_leaf(path, leaf, mesh, *, model_axis: str = "model",
                  fsdp_axes: Optional[Tuple[str, ...]] = None) -> tuple:
    """The spec of one parameter leaf (anything with a ``shape``)."""
    ps = _path_str(path)
    shape = tuple(leaf.shape)
    if len(shape) == 0:
        return P()
    stacked = any(k in ps.split("/") for k in STACKED_KEYS)
    start = 1 if (stacked and len(shape) > 1) else 0
    spec = [None] * len(shape)
    taken = set()

    # 1) model axis by hint
    hint = None
    for rx, pref in _MODEL_DIM_HINTS:
        if rx.search(ps):
            hint = pref
            break
    msize = _axis_size(mesh, model_axis)
    # only >= 2-D weights get a tensor-parallel split; vectors (norm
    # scales, biases) stay replicated
    if msize > 1 and len(shape) - start >= 2:
        d = _pick_dim(shape, start, msize, taken, hint)
        if d is not None:
            spec[d] = model_axis
            taken.add(d)

    # 2) fsdp axes (sequential mode only): fused onto the dim already
    # carrying the model axis where divisible, else the largest remaining
    # divisible dim
    if fsdp_axes:
        fsize = _axis_size(mesh, fsdp_axes)
        if fsize > 1:
            fused = None
            for d in taken:
                if spec[d] == model_axis and shape[d] % (msize * fsize) == 0:
                    fused = d
                    break
            if fused is not None:
                spec[fused] = (model_axis,) + tuple(fsdp_axes)
            else:
                d = _pick_dim(shape, start, fsize, taken, None)
                if d is not None:
                    spec[d] = (fsdp_axes if len(fsdp_axes) > 1
                               else fsdp_axes[0])
                    taken.add(d)

    return P(*spec)


def model_specs(tree, mesh, *, model_axis: str = "model",
                fsdp_axes: Optional[Tuple[str, ...]] = None):
    """The tree of specs of :func:`spec_for_leaf` over ``tree``'s leaves
    (tensors, or anything with a ``shape``): the layout the sharded
    engine stores its parameters in and ``make_fed_round(model_axis=)``
    gathers and slices by."""
    flat = tree_leaves_with_path(tree, _has_shape)
    return tree_unflatten(tree, [spec_for_leaf(p, leaf, mesh,
                                               model_axis=model_axis,
                                               fsdp_axes=fsdp_axes)
                                 for p, leaf in flat], _has_shape)


def param_shardings(params, mesh, *, model_axis: str = "model",
                    fsdp_axes: Optional[Tuple[str, ...]] = None):
    """The spec tree of JAX's ``param_shardings`` (the specs its
    ``NamedSharding`` s hold): :func:`model_specs`."""
    return model_specs(params, mesh, model_axis=model_axis,
                       fsdp_axes=fsdp_axes)


def _axes_entry(axes):
    return axes if isinstance(axes, str) else tuple(axes)


def batch_shardings(batch, mesh, *, batch_dim_axes, batch_dim: int = 0):
    """Every leaf's ``batch_dim`` over ``batch_dim_axes`` where their size
    divides it (and it is at least that size), else replicated."""
    size = _axis_size(mesh, batch_dim_axes)

    def spec(leaf):
        shape = tuple(leaf.shape)
        s = [None] * len(shape)
        if (len(shape) > batch_dim and shape[batch_dim] % size == 0
                and shape[batch_dim] >= size):
            s[batch_dim] = _axes_entry(batch_dim_axes)
        return P(*s)

    flat = tree_leaves_with_path(batch, _has_shape)
    return tree_unflatten(batch, [spec(leaf) for _, leaf in flat],
                          _has_shape)


_STATE_STACKED = ("caches", "groups", "tail", "self_k", "self_v", "cross_k",
                  "cross_v")


def decode_state_shardings(state, mesh, *, data_axes, model_axis="model"):
    """JAX's decode-state specs: the batch dim (the first after a stacked
    axis) over ``data_axes`` when divisible, else their split on the
    longest divisible dim; the model axis on the last divisible dim
    (``_pick_dim``'s "last"), which for a KV cache is head_dim.  The
    index and scalars replicate."""
    dsize = _axis_size(mesh, data_axes)
    msize = _axis_size(mesh, model_axis)
    data_name = _axes_entry(data_axes)

    def spec(path, leaf):
        ps = _path_str(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0 or "index" in ps:
            return P()
        stacked = any(k in ps.split("/") for k in _STATE_STACKED)
        start = 1 if (stacked and nd > 1) else 0
        s = [None] * nd
        taken = set()
        if (nd > start and shape[start] % dsize == 0 and dsize > 1
                and shape[start] >= dsize):
            s[start] = data_name
            taken.add(start)
        elif dsize > 1:
            d = _pick_dim(shape, start, dsize, taken, "last")
            if d is not None:        # the longest divisible dim instead
                d = max((i for i in range(start, nd)
                         if i not in taken and shape[i] % dsize == 0
                         and shape[i] >= dsize), key=lambda i: shape[i])
                s[d] = data_name
                taken.add(d)
        if msize > 1:
            d = _pick_dim(shape, start, msize, taken, "last")
            if d is not None:
                s[d] = model_axis
                taken.add(d)
        return P(*s)

    flat = tree_leaves_with_path(state, _has_shape)
    return tree_unflatten(state, [spec(p, leaf) for p, leaf in flat],
                          _has_shape)


def client_model_specs(tree, mesh, n_clients: int, *,
                       clients_axis: str = "clients",
                       model_axis: str = "model"):
    """Both mesh axes in one spec tree: leaves with a leading client
    dimension shard it over ``clients_axis`` and their trailing dims by
    :func:`spec_for_leaf` on the shape without it; the other leaves get
    the plain model-parallel assignment."""
    def one(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) >= 1 and shape[0] == n_clients:
            inner = spec_for_leaf(path, _Shape(shape[1:]), mesh,
                                  model_axis=model_axis)
            return P(clients_axis, *inner)
        return spec_for_leaf(path, leaf, mesh, model_axis=model_axis)

    flat = tree_leaves_with_path(tree, _has_shape)
    return tree_unflatten(tree, [one(p, leaf) for p, leaf in flat],
                          _has_shape)


def specs_up_to(params_tree, params_specs) -> list:
    """The nodes of ``params_specs`` at ``params_tree``'s leaves, in
    order (JAX's ``flatten_up_to``: a spec is a tuple, not a subtree)."""
    if _has_shape(params_tree):
        return [params_specs]
    if isinstance(params_tree, dict):
        return [s for k in sorted(params_tree)
                for s in specs_up_to(params_tree[k], params_specs[k])]
    if isinstance(params_tree, (list, tuple)):
        return [s for i, t in enumerate(params_tree)
                for s in specs_up_to(t, params_specs[i])]
    return [params_specs]


def state_specs_like(state_tree, params_tree, params_specs):
    """Specs for an optimizer state built from parameter copies: a scalar
    (a step counter, a Python int included) replicates, every other leaf
    must be a params-shaped copy in the parameters' order and takes the
    matching leaf's spec.  Anything else is rejected: a model-sharded
    server update against mismatched state shapes would broadcast."""
    p_leaves = [x for _, x in tree_leaves_with_path(params_tree, _has_shape)]
    p_specs = specs_up_to(params_tree, params_specs)
    flat = tree_leaves_with_path(state_tree, _has_shape)
    out, j = [], 0
    for _, leaf in flat:
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0:
            out.append(P())
            continue
        k = j % len(p_leaves) if p_leaves else 0
        if p_leaves and shape == tuple(p_leaves[k].shape):
            out.append(p_specs[k])
            j += 1
        else:
            raise ValueError(
                f"optimizer-state leaf of shape {shape} does not mirror the "
                f"params flatten order; model-axis sharding needs "
                f"params-shaped state copies (optim.optimizers style)")
    return tree_unflatten(state_tree, out, _has_shape)


def model_dim(spec, model_axis: str) -> Optional[int]:
    """The dim of ``spec`` that names ``model_axis``, or None."""
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        if model_axis in names:
            return i
    return None


def _entry_names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_blocks(tree, specs, mesh, *, copy: bool = False):
    """This rank's blocks of a full ``tree`` (parameters, their Δ, an
    optimizer state, a batch) laid out by ``specs`` over ``mesh``: each
    dim whose entry names axes is cut into as many equal blocks as they
    have ranks together and keeps this rank's (its index over them,
    row-major; ``mesh.axes_mesh``).  ``mesh`` is a ``launch.mesh.FedMesh``
    or one axis' ``ClientMesh`` (the engine's model axis).  Views, or with
    ``copy`` the cut leaves in a storage of their own."""
    out = []
    for x, spec in zip(tree_leaves(tree), specs_up_to(tree, specs)):
        cut = False
        for d, entry in enumerate(spec):
            names = _entry_names(entry)
            if not names:
                continue
            ax = mesh.axes_mesh(names)
            if ax.size > 1:
                n = x.shape[d] // ax.size
                x = x.narrow(d, ax.rank * n, n)
                cut = True
        out.append(x.clone() if copy and cut else x)
    return tree_unflatten(tree, out)


def gather_full(tree, specs, mesh):
    """The full tree from every rank's blocks (the inverse of
    :func:`local_blocks`): each split dim all-gathered over its axes, the
    last dims first.  Exact; every rank of the mesh must call it."""
    out = []
    for x, spec in zip(tree_leaves(tree), specs_up_to(tree, specs)):
        for d in reversed(range(len(spec))):
            names = _entry_names(spec[d])
            if names:
                x = mesh.axes_mesh(names).all_gather(x, dim=d)
        out.append(x)
    return tree_unflatten(tree, out)


def pad_client_dim(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-pad dim 0 of ``x`` from N up to ``n_pad`` (no-op when equal).
    Padded clients are never available, never selected and carry sample
    count 1, so the padding is inert."""
    x = torch.as_tensor(x)
    if x.shape[0] == n_pad:
        return x
    if x.shape[0] > n_pad:
        raise ValueError(f"client dim {x.shape[0]} exceeds padded width "
                         f"{n_pad} (leaf shape {tuple(x.shape)}); the pad "
                         f"target must be >= the real client count")
    pad = torch.zeros((n_pad - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def client_dim_flags(state, n_clients: int):
    """The tree of ``state`` with each leaf replaced by whether it carries
    the client dimension (a tensor whose first dimension is N)."""
    return tree_map(lambda leaf: (torch.is_tensor(leaf) and leaf.dim() >= 1
                                  and leaf.shape[0] == n_clients), state)


def map_client_leaves(fn, state, flags):
    """``fn(leaf)`` on the leaves of ``state`` that ``flags`` marks as
    carrying the client dimension; the others as they are."""
    return tree_map(lambda leaf, f: fn(leaf) if f else leaf, state, flags)


def any_client_leaf(flags) -> bool:
    """True when some leaf carries the client dimension."""
    return any(bool(f) for f in tree_leaves(flags))
