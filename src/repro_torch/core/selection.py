"""The top-K_t cut and the cohort layout (port of ``repro.core.selection``).

Tie-break contract (``(score, id)``): every top-k cut — the argsort path
(:func:`_topk_mask`) and the ``fed_select`` kernel with its plain version
(``repro_torch.kernels``) — resolves equal scores to the LOWER client id,
i.e. ranks by the pair (−score, id).  That is what makes the port's masks
bit-identical to the JAX package's for the same scores.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import random as jr
from .. import xla_math

# Score sentinel for unavailable clients — low enough that no real score
# reaches it, so unavailable clients rank last.  ``kernels.ref.SELECT_NEG``
# must stay equal to it.
_NEG = -1e30


def _topk_mask(scores: torch.Tensor, avail: torch.Tensor,
               k: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the top-min(k, |avail|) available entries by score.

    A *stable* ascending sort of ``−masked`` gives the ranks with the
    ``(score, id)`` tie-break, exactly as ``jnp.argsort`` does.
    """
    n = scores.shape[0]
    masked = torch.where(avail, scores, torch.full_like(scores, _NEG))
    order = torch.sort(-masked, stable=True).indices
    ranks = torch.empty(n, dtype=torch.int32, device=scores.device)
    ranks[order] = torch.arange(n, dtype=torch.int32, device=scores.device)
    k_eff = torch.minimum(torch.as_tensor(k, device=scores.device)
                          .to(torch.int32), avail.sum().to(torch.int32))
    return (ranks < k_eff) & avail


def fedavg_select(key: torch.Tensor, avail: torch.Tensor, k, p: torch.Tensor,
                  topk: Optional[Callable] = None) -> torch.Tensor:
    """Sample min(k, |avail|) available clients without replacement, with
    probability ∝ p_k (Gumbel top-k: top-k of log p + Gumbel noise).  The
    paper's FedAvg baseline (§4).  Here p is an argument, so the log is
    XLA's runtime ``log``, as a jitted ``fedavg_select`` computes it (the
    ``fedavg`` strategy closes over p, whose log XLA folds).  ``topk``
    swaps the cut (e.g. ``kernels.fed_select.fed_select_mask``)."""
    g = jr.gumbel(key, tuple(p.shape))
    scores = xla_math.log(torch.clamp_min(p, xla_math.f32(1e-12))) + g
    return (topk or _topk_mask)(scores, avail, k)


def uniform_select(key: torch.Tensor, avail: torch.Tensor,
                   k) -> torch.Tensor:
    """Uniform without replacement over the available set: i.i.d. uniform
    scores + top-k is a uniformly random <= k subset of the available."""
    scores = jr.uniform(key, tuple(avail.shape))
    return _topk_mask(scores, avail, k)


def poc_select(key: torch.Tensor, avail: torch.Tensor, m, p: torch.Tensor,
               losses: torch.Tensor, d: int,
               topk: Optional[Callable] = None) -> torch.Tensor:
    """Power-of-Choice (Cho et al., the paper's loss-based baseline): d
    candidates sampled ∝ p_k from the available pool
    (:func:`fedavg_select`), then the top-m candidates by current loss.
    ``topk`` routes both cuts, the candidate draw and the loss cut."""
    cut = topk or _topk_mask
    cand = fedavg_select(key, avail, int(d), p, topk=cut)
    return cut(losses, cand, m)


def cohort_ids_from_mask(mask: torch.Tensor, cohort_size: int):
    """Selection mask (N,) bool → padded cohort (ids (K,) int64, valid (K,)).

    Selected ids in ascending order, slots past |S| repeating the first
    selected client with ``valid=False`` — the JAX package's layout.
    """
    n = mask.shape[0]
    ids_all = torch.arange(n, dtype=torch.int64, device=mask.device)
    ranked = torch.sort(torch.where(mask, ids_all,
                                    torch.full_like(ids_all, n))).values
    ids = ranked[:cohort_size]
    valid = ids < n
    first = torch.clamp_max(ranked[0], n - 1)   # the mask is never empty
    return torch.where(valid, ids, first), valid
