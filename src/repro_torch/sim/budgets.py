"""Communication-budget schedule registry — the K_t half of the engine
(port of ``repro.sim.budgets``; only ``constant`` so far).

``sample(key, t)`` returns an int32 scalar tensor on the schedule's device;
``k_max`` is a static Python int that sizes the cohort.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..device import resolve_device
from ..registry import lookup

DEFERRED_BUDGETS = ("jittered", "step", "diurnal", "bandwidth")


class BudgetSchedule:
    """Interface contract: ``sample(key, t)`` + ``k_max``."""

    k_max: int

    def sample(self, key: torch.Tensor, t) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Constant(BudgetSchedule):
    """K_t = k for all t."""

    k: int = 10
    device: Optional[torch.device] = None    # None: CUDA

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def k_max(self) -> int:
        return self.k

    def sample(self, key, t):
        return torch.full((), self.k, dtype=torch.int32, device=self.device)


BUDGET_REGISTRY: Dict[str, Callable[..., BudgetSchedule]] = {
    "constant": Constant,
}


def check_budget(name: str) -> str:
    """Fail fast on a budget schedule this port does not run."""
    return lookup("budget schedule", name, BUDGET_REGISTRY, DEFERRED_BUDGETS,
                  8)


def make_budget(name: str, device=None, **kw) -> BudgetSchedule:
    """Build a registered K_t schedule by string key."""
    return BUDGET_REGISTRY[check_budget(name)](device=device, **kw)
