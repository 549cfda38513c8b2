"""The client-dimension rules of the sharded engine (port of the client
part of ``repro.sharding.rules``).

The sharded engine pads the client dimension to a multiple of the mesh
size × 32 and gives each shard one block of it.  A leaf of an
availability process's state carries the client dimension when its first
dimension is N; the others (a cluster chain, a round counter) stay
replicated.  The model-axis rules (``model_specs``, ``spec_for_leaf``,
``state_specs_like``, ``client_model_specs``) are ROADMAP.md queue 1 item
11.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["any_client_leaf", "client_dim_flags", "map_client_leaves",
           "pad_client_dim"]


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
