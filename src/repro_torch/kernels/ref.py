"""Plain PyTorch versions of the port's kernels (their CPU path and their
oracle on the card).

Port of ``repro.kernels.ref``'s ``fed_select`` and ``fed_aggregate``
oracles, op for op, so that on the CPU they are bitwise (``fed_select``)
or allclose (``fed_aggregate``) to the JAX package's.
"""
from __future__ import annotations

import torch

from ..core.hfun import R_MIN
from ..core.rates import ema

# Sentinel for unavailable clients — must match core.selection._NEG.
SELECT_NEG = -1e30

SELECT_WEIGHT_MODES = ("unbiased", "unbiased_frozen", "uniform", "fedavg")


def fed_aggregate_ref(deltas: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """(K, D), (K,) -> (D,): float32-accumulated weighted sum, returned in
    the delta dtype."""
    acc = torch.sum(deltas.to(torch.float32)
                    * weights.to(torch.float32)[:, None], dim=0)
    return acc.to(deltas.dtype)


_MANTISSA_BITS = {torch.float32: 23, torch.bfloat16: 7}


def fed_aggregate_err_bound(deltas: torch.Tensor, weights: torch.Tensor,
                            got: torch.Tensor,
                            want: torch.Tensor) -> torch.Tensor:
    """Per-lane bound on ``|got − want|`` for two evaluations of
    :func:`fed_aggregate_ref`'s contract (float32 accumulation in any order,
    one rounding to the delta dtype).  Each float32 sum lies within
    ``K·2^-24·Σ_k|w_k v[k, d]|`` of the exact one, so two differ by at most
    twice that; each then rounds once, together at most one step of the
    output dtype at the larger magnitude.  A sum accumulated in bfloat16
    breaks this bound."""
    k_rows = deltas.shape[0]
    mag = torch.sum(deltas.to(torch.float32).abs()
                    * weights.to(torch.float32).abs()[:, None], dim=0)
    big = torch.maximum(got.to(torch.float32).abs(),
                        want.to(torch.float32).abs())
    _, exp = torch.frexp(big)
    step = torch.ldexp(torch.ones_like(big),
                       exp - 1 - _MANTISSA_BITS[deltas.dtype])
    return 2.0 * k_rows * 2.0 ** -24 * mag + step


def topk_threshold_mask(scores: torch.Tensor, avail: torch.Tensor,
                        k: torch.Tensor) -> torch.Tensor:
    """The stable ``(score, id)`` top-k cut as a threshold: with ``thr`` the
    ``k_eff``-th largest masked score, select ``masked > thr`` plus the
    first ``k_eff − |{masked > thr}|`` ties in ascending id order.
    Bit-identical to ``core.selection._topk_mask``."""
    n = scores.shape[0]
    avail = avail.to(torch.bool)
    masked = torch.where(avail, scores,
                         torch.full_like(scores, SELECT_NEG)).to(torch.float32)
    n_avail = avail.sum().to(torch.int32)
    k_eff = torch.minimum(torch.as_tensor(k, device=scores.device)
                          .to(torch.int32), n_avail)
    svals = torch.sort(masked).values
    # k_eff-th largest lives at ascending index n - k_eff; k_eff == 0 clips
    # to the maximum, for which the counts below select nothing.
    idx = torch.clamp(n - k_eff, 0, n - 1).to(torch.int64)
    thr = svals[idx]
    gt = masked > thr
    g = gt.sum().to(torch.int32)
    eq = (masked == thr) & avail
    eq_i = eq.to(torch.int32)
    tie_rank = torch.cumsum(eq_i, 0, dtype=torch.int32) - eq_i
    return (gt | (eq & (tie_rank < (k_eff - g)))) & avail


def select_weights_ref(mask, new_r, p, r_weight, weight_mode: str):
    """The built-in strategies' weight rules on the selection mask."""
    zero = torch.zeros_like(p)
    if weight_mode == "unbiased":
        return torch.where(mask, p / torch.clamp_min(new_r, R_MIN), zero)
    if weight_mode == "unbiased_frozen":
        return torch.where(mask, p / torch.clamp_min(r_weight, R_MIN), zero)
    if weight_mode == "uniform":
        v = mask.to(torch.float32)
        return v / torch.clamp_min(v.sum(), 1.0)
    if weight_mode == "fedavg":
        w = torch.where(mask, p, zero)
        return w / torch.clamp_min(w.sum(), 1e-12)
    raise ValueError(f"unknown weight_mode {weight_mode!r}; "
                     f"known: {SELECT_WEIGHT_MODES}")


def fed_select_ref(scores, avail, k, r, p, beta, *,
                   weight_mode: str = "unbiased", r_weight=None):
    """The fused selection step (mask, new_r, weights): threshold cut →
    r_k EMA → cohort weights."""
    mask = topk_threshold_mask(scores, avail, k)
    new_r = ema(r, mask, beta)
    w = select_weights_ref(mask, new_r, p, r_weight, weight_mode)
    return mask, new_r, w
