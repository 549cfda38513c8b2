"""Server-side aggregation weights (port of ``repro.core.aggregation``).

F3AST (unbiased, Lemma C.1):     Delta = sum_{k in S} (p_k / r_k) v_k
FedAvg-style (biased baseline):  Delta = sum_{k in S} p_k v_k / sum_{k in S} p_k
Unweighted mean (biased):        Delta = (1/|S|) sum_{k in S} v_k

The Δ reduction itself, :func:`weighted_aggregate`, is
``kernels.fed_aggregate_tree`` (a CUDA kernel on the card, its plain
spelling on the CPU).  The sequential cohort mode sums client by client
instead (``streaming_aggregate_init`` / ``streaming_aggregate_add``).
"""
from __future__ import annotations

import torch

from ..kernels.fed_aggregate import fed_aggregate_tree
from ..tree import tree_map
from .hfun import R_MIN

# Σ_k weights[k] · deltas[k] over the leading cohort axis of every leaf,
# accumulated in float32 and cast back to the leaf's dtype: one
# fed_aggregate launch over the whole tree on the card.
weighted_aggregate = fed_aggregate_tree


def unbiased_weights(p_sel: torch.Tensor, r_sel: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Importance weights p_k / r_k for the selected cohort."""
    w = p_sel / torch.clamp_min(r_sel, R_MIN)
    return torch.where(valid, w, torch.zeros_like(w))


def fedavg_weights(p_sel: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """p_k / Σ_S p over the cohort (the sum's order is not XLA's, so these
    weights are held to the parameter tolerance, not bitwise)."""
    w = torch.where(valid, p_sel, torch.zeros_like(p_sel))
    return w / torch.clamp_min(w.sum(), 1e-12)


def uniform_weights(valid: torch.Tensor) -> torch.Tensor:
    """1/|S| over the cohort."""
    v = valid.to(torch.float32)
    return v / torch.clamp_min(v.sum(), 1.0)


def streaming_aggregate_init(params_like, dtype=torch.float32):
    """A zero accumulator shaped like the parameter tree, in ``dtype``
    (float32 by default; bfloat16 halves it for the largest models)."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype,
                                          device=x.device), params_like)


def streaming_aggregate_add(acc, delta, weight: torch.Tensor):
    """acc += weight · delta in float32, cast back to the accumulator's
    dtype (one client at a time, sequential cohort mode)."""
    return tree_map(lambda a, d: (a.to(torch.float32) + weight
                                  * d.to(torch.float32)).to(a.dtype),
                    acc, delta)
