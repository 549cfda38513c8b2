"""Availability-process registry — the A_t half of the scenario engine
(port of ``repro.sim.processes``; only ``scarce`` so far).

    model = make_process("scarce", n_clients=100, device=dev)
    state = model.init()
    state, mask = model.step(key_t, state, t)     # mask: (N,) bool
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..core import availability as core_av
from ..registry import lookup

# The JAX package's processes that this port does not have yet.
DEFERRED_PROCESSES = ("always", "homedevices", "smartphones", "uneven",
                      "bernoulli", "markov", "gilbert_elliott", "diurnal",
                      "drift", "trace")


class AvailabilityModel:
    """Interface contract: ``n_clients``, ``init()`` and ``step(key, state,
    t) -> (state', mask)``."""

    n_clients: int

    def init(self):
        return ()

    def step(self, key: torch.Tensor, state, t):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Stateless(AvailabilityModel):
    """Adapter: a stateless ``core.availability.AvailabilityProcess``
    exposed through the stateful scenario interface."""

    proc: core_av.AvailabilityProcess

    @property
    def n_clients(self) -> int:
        return self.proc.n_clients

    def init(self):
        return ()

    def step(self, key, state, t):
        return state, self.proc.sample(key, t)


def _stateless(cls):
    def make(n_clients: int, p=None, device=None, **kw):
        return Stateless(cls(n_clients=n_clients, device=device, **kw))
    return make


PROCESS_REGISTRY: Dict[str, Callable[..., AvailabilityModel]] = {
    "scarce": _stateless(core_av.Scarce),
}


def check_process(name: str) -> str:
    """Fail fast on an availability process this port does not run."""
    return lookup("availability process", name, PROCESS_REGISTRY,
                  DEFERRED_PROCESSES, 8)


def make_process(name: str, n_clients: int, p: Optional[object] = None,
                 device=None, **kw) -> AvailabilityModel:
    """Build a registered availability model by string key."""
    return PROCESS_REGISTRY[check_process(name)](n_clients, p=p,
                                                 device=device, **kw)
