"""DEPRECATED compatibility shim over :mod:`repro_torch.core.strategies`
(port of ``repro.core.algorithms``): the old string-dispatched controller
on top of the strategy registry.

    ctrl = make_algorithm("f3ast", n_clients=N, p=p, beta=1e-3)  # deprecated
    state = ctrl.init()
    mask, weights_full, state = ctrl.select(state, key, avail, k_t)

New spelling: ``make_strategy(name, N, p, beta=...)``, then
``strategy.init(N)`` and ``strategy.select(state, key, avail, k_t, ctx)``.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import torch

from .strategies import (RateTrackState, SelectCtx, SelectionStrategy,
                         make_strategy)

# Old name for the built-in strategies' state.
AlgoState = RateTrackState


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """Deprecated wrapper binding a registered strategy to the old API."""
    name: str
    n_clients: int
    p: torch.Tensor                     # client data fractions, sum to 1
    beta: float = 1e-3
    positively_correlated: bool = False
    poc_d: int = 30                     # PoC candidate-set size
    r_target: Optional[torch.Tensor] = None  # fixed-policy F3AST target

    @functools.cached_property
    def strategy(self) -> SelectionStrategy:
        kw = dict(beta=self.beta,
                  positively_correlated=self.positively_correlated)
        if self.r_target is not None:
            kw["r_target"] = self.r_target
        if self.name == "poc":
            kw["d"] = self.poc_d
        return make_strategy(self.name, self.n_clients, self.p,
                             device=self.p.device, **kw)

    def init(self, r0: float | None = None) -> AlgoState:
        """Old default: r0 = 0.1 when unspecified."""
        return self.strategy.init(self.n_clients,
                                  r0=0.1 if r0 is None else r0)

    def select(self, state: AlgoState, key: torch.Tensor,
               avail: torch.Tensor, k_t, losses=None):
        """Returns (sel_mask (N,) bool, weights (N,) f32, new state)."""
        return self.strategy.select(state, key, avail, k_t,
                                    SelectCtx(losses=losses))


def make_algorithm(name: str, n_clients: int, p, device=None,
                   **kw) -> Algorithm:
    warnings.warn(
        "make_algorithm/Algorithm are deprecated; use "
        "repro_torch.core.strategies.make_strategy (and register_strategy "
        "for custom policies)", DeprecationWarning, stacklevel=2)
    from ..device import resolve_device
    return Algorithm(name=name.lower(), n_clients=n_clients,
                     p=torch.as_tensor(p, dtype=torch.float32,
                                       device=resolve_device(device)), **kw)
