"""Communication-budget schedule registry — the K_t half of the engine
(port of ``repro.sim.budgets``).

``sample(key, t)`` returns an int32 scalar tensor on the key's device with
1 <= K_t <= ``k_max``; ``k_max`` is a static Python int that sizes the
cohort, so rounds with K_t < k_max run with zero-weighted padding slots.
``t`` is the round index (a Python int).  The float schedules compute as
the jitted JAX ones do (``xla_math``: XLA's ``sin``, ``exp``, its folded
constants and FMAs), so K_t is bitwise the JAX package's.

Registered: ``constant`` (K_t = k), ``jittered`` (uniform on [max(1,
k-jitter), k+jitter]), ``step`` (k_before until t_switch, then k_after),
``diurnal`` (sinusoidal between k_min and k_hi) and ``bandwidth``
(lognormal-noisy, diurnally modulated uplink capacity over a per-client
rate).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from .. import random as jr
from .. import xla_math
from ..core.availability import CommBudget
from ..device import OnDevice

_f32 = xla_math.f32


class BudgetSchedule:
    """Interface contract: ``sample(key, t)`` + ``k_max``."""

    k_max: int

    def sample(self, key: torch.Tensor, t) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class _Schedule(OnDevice, BudgetSchedule):
    """Base of the schedules below."""

    def _int32(self, k: int) -> torch.Tensor:
        return torch.full((), k, dtype=torch.int32, device=self.device)


@dataclasses.dataclass(frozen=True)
class Constant(_Schedule):
    """K_t = k for all t."""

    k: int = 10

    @property
    def k_max(self) -> int:
        return self.k

    def sample(self, key, t):
        return self._int32(self.k)


@dataclasses.dataclass(frozen=True)
class Jittered(_Schedule):
    """Uniform K_t ∈ [max(1, k-jitter), k+jitter] — ``CommBudget``'s
    sampler."""

    k: int = 10
    jitter: int = 3

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "_budget",
                           CommBudget(fixed=self.k, jitter=self.jitter))

    @property
    def k_max(self) -> int:
        return self.k + self.jitter

    def sample(self, key, t):
        return self._budget.sample(key, t)


@dataclasses.dataclass(frozen=True)
class StepBudget(_Schedule):
    """K_t = k_before for t < t_switch, else k_after."""

    k_before: int = 10
    k_after: int = 3
    t_switch: int = 100

    @property
    def k_max(self) -> int:
        return max(self.k_before, self.k_after)

    def sample(self, key, t):
        return self._int32(self.k_before if int(t) < self.t_switch
                           else self.k_after)


def _half_sine(t: torch.Tensor, period) -> torch.Tensor:
    """0.5 + 0.5 sin(2π t / period), one FMA after XLA's ``sin``."""
    ang = t * xla_math.two_pi_over(period)
    return xla_math.fma(xla_math.sin(ang), 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class DiurnalBudget(_Schedule):
    """Sinusoidal K_t between k_min and k_hi over ``period`` rounds:
    K_t = round(k_min + (k_hi - k_min) (0.5 + 0.5 sin(2π (t+phase)/p))),
    rounding half to even."""

    k_min: int = 2
    k_hi: int = 10
    period: int = 24
    phase: float = 0.0

    @property
    def k_max(self) -> int:
        return self.k_hi

    def sample(self, key, t):
        tt = torch.full((), float(t), dtype=torch.float32, device=self.device)
        if self.phase:
            tt = tt + _f32(self.phase)
        frac = _half_sine(tt, self.period)
        k = torch.round(xla_math.fma(frac, _f32(self.k_hi - self.k_min),
                                     _f32(self.k_min)))
        return torch.clamp(k, 1.0, float(self.k_hi)).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BandwidthCoupled(_Schedule):
    """Budget from a fluctuating uplink capacity:

    capacity_t = mean_mbps * diurnal(t) * lognormal(sigma)  [per-round draw]
    K_t        = clip(floor(capacity_t / mbps_per_client), 1, k_cap)

    ``diurnal(t)`` dips to (1 - diurnal_depth) at the trough."""

    k_cap: int = 10
    mean_mbps: float = 100.0
    mbps_per_client: float = 12.5
    sigma: float = 0.25
    period: int = 24
    diurnal_depth: float = 0.5

    @property
    def k_max(self) -> int:
        return self.k_cap

    def sample(self, key, t):
        tt = torch.full((), float(t), dtype=torch.float32, device=key.device)
        diurnal = xla_math.fma(_half_sine(tt, self.period),
                               -_f32(self.diurnal_depth), 1.0)
        noise = xla_math.exp(jr.normal(key) * _f32(self.sigma))
        capacity = diurnal * _f32(self.mean_mbps) * noise
        k = torch.floor(capacity * xla_math.recip(self.mbps_per_client))
        return torch.clamp(k, 1.0, float(self.k_cap)).to(torch.int32)


BUDGET_REGISTRY: Dict[str, Callable[..., BudgetSchedule]] = {
    "constant": Constant,
    "jittered": Jittered,
    "step": StepBudget,
    "diurnal": DiurnalBudget,
    "bandwidth": BandwidthCoupled,
}


def check_budget(name: str) -> str:
    """The registry key of a budget schedule; ``KeyError`` listing the
    known ones otherwise."""
    key = str(name).lower()
    if key not in BUDGET_REGISTRY:
        raise KeyError(f"unknown budget schedule {name!r}; "
                       f"known: {sorted(BUDGET_REGISTRY)}")
    return key


def make_budget(name: str, device=None, **kw) -> BudgetSchedule:
    """Build a registered K_t schedule by string key."""
    return BUDGET_REGISTRY[check_budget(name)](device=device, **kw)
