"""The variance surrogate H(r) of F3AST (paper Eq. 3) and its gradient.

H(r) = sum_k p_k  / r_k   if client availability is positively correlated
H(r) = sum_k p_k^2/ r_k   otherwise (uncorrelated / negatively correlated)

Port of ``repro.core.hfun``: the same elementwise ops in the same order,
each correctly rounded in float32, so the scores (and hence the masks) are
bitwise those of the JAX package.
"""
from __future__ import annotations

import torch

# Rates are clipped away from zero before dividing (never-selected clients
# would otherwise produce infinite utilities); the tracked EMA itself is
# never clipped.
R_MIN = 1e-3


def h_value(r: torch.Tensor, p: torch.Tensor,
            positively_correlated: bool) -> torch.Tensor:
    """The variance surrogate H(r) (paper Eq. 3), a float32 scalar:
    Σ_k p_k²/r_k, or Σ_k p_k/r_k when availabilities are positively
    correlated.  It upper-bounds the client-sampling variance (Lemma 3.4);
    F3AST's selection is its greedy minimizer.  The sum's order is not
    XLA's, so it agrees with the JAX package to float32 rounding, not
    bitwise."""
    rc = torch.clamp_min(r, R_MIN)
    num = p if positively_correlated else p * p
    return torch.sum(num / rc)


def h_grad(r: torch.Tensor, p: torch.Tensor,
           positively_correlated: bool) -> torch.Tensor:
    """∇H(r) in closed form — shape (N,), elementwise −p_k²/r_k² (resp.
    −p_k/r_k²)."""
    rc = torch.clamp_min(r, R_MIN)
    num = p if positively_correlated else p * p
    return -num / (rc * rc)


def marginal_utility(r: torch.Tensor, p: torch.Tensor,
                     positively_correlated: bool) -> torch.Tensor:
    """−∇H(r): the marginal utility of selecting each client (Eq. 4), the
    score Algorithm 1 line 4 ranks by."""
    return -h_grad(r, p, positively_correlated)
