"""The top-K_t cut and the cohort layout (port of ``repro.core.selection``).

Tie-break contract (``(score, id)``): every top-k cut — the argsort path
(:func:`_topk_mask`) and the ``fed_select`` kernel with its plain version
(``repro_torch.kernels``) — resolves equal scores to the LOWER client id,
i.e. ranks by the pair (−score, id).  That is what makes the port's masks
bit-identical to the JAX package's for the same scores.
"""
from __future__ import annotations

import torch

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
