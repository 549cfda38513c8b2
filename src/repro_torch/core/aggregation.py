"""Server-side aggregation weights (port of ``repro.core.aggregation``).

F3AST (unbiased, Lemma C.1):     Delta = sum_{k in S} (p_k / r_k) v_k
FedAvg-style (biased baseline):  Delta = sum_{k in S} p_k v_k / sum_{k in S} p_k
Unweighted mean (biased):        Delta = (1/|S|) sum_{k in S} v_k

The Δ reduction itself — the JAX package's ``weighted_aggregate`` — is
``kernels.fed_aggregate_tree`` (a CUDA kernel on the card, its plain
spelling on the CPU).  The sequential cohort mode sums client by client
instead (``streaming_aggregate_init`` / ``streaming_aggregate_add``).
"""
from __future__ import annotations

import torch

from ..tree import tree_map
from .hfun import R_MIN


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


def streaming_aggregate_init(params_like):
    """A float32 zero accumulator shaped like the parameter tree."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params_like)


def streaming_aggregate_add(acc, delta, weight: torch.Tensor):
    """acc += weight · delta in float32, cast back to the accumulator's
    dtype (one client at a time, sequential cohort mode)."""
    return tree_map(lambda a, d: (a.to(torch.float32) + weight
                                  * d.to(torch.float32)).to(a.dtype),
                    acc, delta)
