"""Slice-consistent PRNG draws — one shard's block of a full-width stream
(port of ``repro.core.blockrng``).

The parity contract draws every random field (availability, selection
tie-breaks) at the full (N,) client shape from a replicated key, so every
engine sees the same values; a shard of the sharded engine needs only its
own block ``[off, off + n_local)``.  The port's threefry counters are the
partitionable layout (element ``i`` of a draw hashes the counter ``i``
alone, ``repro_torch.random``), so the block is ``bits(key, (n_local,),
start=off)``: O(n_local), bitwise the slice of the full draw, with no
(N,)-shaped intermediate.

Lanes at or past ``n_total`` (the shard-padding tail) read what the JAX
package's helpers give them under ``jax_threefry_partitionable`` (its
full-width draw padded with zeros, then sliced): bits 0, uniform 0.0,
bernoulli ``uniform < p``.  Callers mask them: padded clients are never
available, never selected and score 0.
"""
from __future__ import annotations

import torch

from .. import random as jr

__all__ = ["block_bits", "block_bernoulli", "block_uniform",
           "have_block_prng"]


def have_block_prng(key) -> bool:
    """True: the port's counters are the partitionable layout, so a block
    is always drawn at O(n_local) (the JAX package's helpers need the
    non-partitionable layout and fall back to a full draw otherwise)."""
    return True


def _real(n_total: int, off: int, n_local: int, device) -> torch.Tensor:
    return (torch.arange(off, off + n_local, device=device) < n_total)


def block_bits(key: torch.Tensor, n_total: int, off: int,
               n_local: int) -> torch.Tensor:
    """``bits(key, (n_total,))[off:off + n_local]`` with lanes past
    ``n_total`` 0 (uint32 words in int64)."""
    b = jr.bits(key, (n_local,), start=int(off))
    if off + n_local <= n_total:
        return b
    return torch.where(_real(n_total, off, n_local, b.device), b, 0)


def block_uniform(key: torch.Tensor, n_total: int, off: int,
                  n_local: int) -> torch.Tensor:
    """``uniform(key, (n_total,))[off:off + n_local]`` with lanes past
    ``n_total`` 0.0."""
    u = jr.uniform(key, (n_local,), start=int(off))
    if off + n_local <= n_total:
        return u
    return torch.where(_real(n_total, off, n_local, u.device), u, 0.0)


def block_bernoulli(key: torch.Tensor, p_block, n_total: int, off: int,
                    n_local: int) -> torch.Tensor:
    """``bernoulli(key, p_full)[off:off + n_local]`` given this block's
    slice of the probabilities (a scalar or (n_local,))."""
    return block_uniform(key, n_total, off, n_local) < p_block
