"""Long-term participation-rate tracking (Algorithm 1 line 5).

r(t) = (1-beta) r(t-1) + beta * 1_{S_t}

Port of ``repro.core.rates``.  The jitted JAX engines compute the EMA as
one fused multiply-add, ``fma(1−β, r, β·m)``; an unfused mul+add differs
from it in the last bit of many lanes, which would drift the r_k
trajectory.  So the port spells it as ``torch.addcmul(β·m, r, 1−β)``, one
FMA on the CPU, with β and 1−β folded in Python and cast to float32 once,
as JAX folds its weak-typed constants.  On CUDA the EMA runs inside the
``fed_select`` kernel (``__fmaf_rn``), bit-identical to this.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import xla_math
from ..device import resolve_device


class RateState(NamedTuple):
    r: torch.Tensor        # (N,) EMA of selection indicators, float32
    t: torch.Tensor        # round counter (int32 scalar)


def init_rates(n_clients: int, r0: float = 0.5, device=None) -> RateState:
    """r(0) (Algorithm 1 line 1: "initialize r(0) arbitrarily")."""
    device = resolve_device(device)
    r = torch.full((n_clients,), float(r0), dtype=torch.float32,
                   device=device)
    return RateState(r=r, t=torch.zeros((), dtype=torch.int32,
                                        device=device))


def ema(r: torch.Tensor, mask: torch.Tensor, beta: float) -> torch.Tensor:
    """``(1 − β)·r + β·mask`` as one fused multiply-add."""
    beta_f = torch.full((), beta, dtype=torch.float32, device=r.device)
    omb_f = torch.full((), 1.0 - beta, dtype=torch.float32, device=r.device)
    return torch.addcmul(beta_f * mask.to(torch.float32), r, omb_f)


def update_rates(state: RateState, sel_mask: torch.Tensor,
                 beta: float) -> RateState:
    """One EMA step of Algorithm 1 line 5 on the (N,) bool indicator."""
    return RateState(r=ema(state.r, sel_mask, beta), t=state.t + 1)


def empirical_rate(sel_history: torch.Tensor) -> torch.Tensor:
    """Time-average participation rate (1/T) Σ_t 1_{S_t} of a (T, N)
    selection history: the estimate of the long-term rate that Theorem
    3.3's tracked EMA approaches.  The sum of 0/1 values is exact; the
    mean is the sum times 1/T rounded to float32, as XLA spells
    ``mean``, so the result is the JAX package's bit for bit."""
    total = sel_history.to(torch.float32).sum(0)
    return total * xla_math.recip(sel_history.shape[0])
