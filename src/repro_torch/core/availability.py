"""Client-availability processes (paper §4.1), port of
``repro.core.availability`` for the ``scarce`` regime.

Every process produces, per round ``t``, a boolean availability mask
``A_t ∈ {0,1}^N``; samplers are pure functions of an explicit key tensor
(``repro_torch.random``), so the masks are bitwise the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import random as jr
from ..device import resolve_device
from .keys import NONEMPTY


def force_nonempty(mask: torch.Tensor, q: torch.Tensor,
                   key: torch.Tensor) -> torch.Tensor:
    """Force a non-empty available set (the paper assumes A_t ≠ ∅): if every
    client is down, wake one chosen uniformly at random among the clients
    with the highest marginal probability.  ``key`` is a derived
    ``fold_in`` key, so the common non-empty path consumes nothing from the
    main stream.  No host sync: the fallback is selected with ``where``."""
    tie = jr.uniform(key, tuple(q.shape))
    cand = torch.where(q >= q.max(), tie, torch.full_like(tie, -1.0))
    idx = torch.argmax(cand)
    fallback = torch.arange(mask.shape[0], device=mask.device) == idx
    return torch.where(mask.any(), mask, fallback)


@dataclasses.dataclass(frozen=True)
class AvailabilityProcess:
    """Base class: per-client marginal probabilities, possibly time-varying."""

    n_clients: int
    device: Optional[torch.device] = None    # None: CUDA

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def probs(self, t) -> torch.Tensor:
        """Per-client availability probability at round ``t`` — shape (N,)."""
        raise NotImplementedError

    def sample(self, key: torch.Tensor, t) -> torch.Tensor:
        """Boolean availability mask A_t, guaranteed non-empty."""
        q = self.probs(t)
        mask = jr.bernoulli(key, q)
        return force_nonempty(mask, q, jr.fold_in(key, NONEMPTY))


@dataclasses.dataclass(frozen=True)
class Scarce(AvailabilityProcess):
    """I.i.d. homogeneous availability with probability q (paper: q = 0.2)."""

    q: float = 0.2

    def probs(self, t):
        return torch.full((self.n_clients,), self.q, dtype=torch.float32,
                          device=self.device)
