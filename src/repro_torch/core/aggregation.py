"""Server-side aggregation weights (port of ``repro.core.aggregation``).

F3AST (unbiased, Lemma C.1):     Delta = sum_{k in S} (p_k / r_k) v_k

The Δ reduction itself — the JAX package's ``weighted_aggregate`` — is
``kernels.fed_aggregate_tree`` (a CUDA kernel on the card, its plain
spelling on the CPU).  The biased baselines' weight rules (fedavg,
uniform) come with their strategies (ROADMAP.md queue 1 item 3).
"""
from __future__ import annotations

import torch

from .hfun import R_MIN


def unbiased_weights(p_sel: torch.Tensor, r_sel: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Importance weights p_k / r_k for the selected cohort."""
    w = p_sel / torch.clamp_min(r_sel, R_MIN)
    return torch.where(valid, w, torch.zeros_like(w))

