"""The :class:`Scenario` spec and its string-keyed registry (port of
``repro.sim.scenario``; only ``scarce`` so far).

A Scenario binds one availability process × one K_t budget schedule × one
completion process × one training task into a declarative experiment cell.
Its fields are the JAX package's, so an inline scenario in a RunSpec JSON
means the same thing to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

from .budgets import BudgetSchedule, make_budget
from .completion import CompletionModel, make_completion, resolve_completion
from ..registry import lookup
from .processes import AvailabilityModel, make_process

# The JAX package's built-in scenarios that this port does not have yet.
DEFERRED_SCENARIOS = ("always", "homedevices", "smartphones", "uneven",
                      "bernoulli", "markov", "gilbert_elliott", "diurnal",
                      "drift", "trace", "bandwidth", "stepk", "dropout",
                      "straggler")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One experiment cell: process × budget × completion × task."""

    name: str
    availability: str
    availability_kwargs: Mapping = dataclasses.field(default_factory=dict)
    budget: str = "constant"
    budget_kwargs: Mapping = dataclasses.field(default_factory=dict)
    completion: str = "always"
    completion_kwargs: Mapping = dataclasses.field(default_factory=dict)
    task: str = "synthetic11"
    task_kwargs: Mapping = dataclasses.field(default_factory=dict)
    algorithms: Tuple[str, ...] = ("f3ast", "fedavg")
    rounds: Optional[int] = None
    description: str = ""

    def build_availability(self, n_clients: int, p=None,
                           device=None) -> AvailabilityModel:
        return make_process(self.availability, n_clients, p=p, device=device,
                            **dict(self.availability_kwargs))

    def build_completion(self, n_clients: int, avail_model=None,
                         override: Optional[str] = None,
                         override_kwargs=None) -> CompletionModel:
        name, kw = resolve_completion(self, override, override_kwargs)
        return make_completion(name, n_clients, avail_model=avail_model,
                               **kw)

    def build_budget(self, default_k: Optional[int] = None,
                     device=None) -> BudgetSchedule:
        """``default_k`` fills ``k`` of the schedules that take one when the
        scenario does not pin it (the paper-task default M = 10)."""
        kw = dict(self.budget_kwargs)
        if default_k is not None and "k" not in kw \
                and self.budget in ("constant", "jittered"):
            kw["k"] = default_k
        return make_budget(self.budget, device=device, **kw)


SCENARIO_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(sc: Scenario, overwrite: bool = False) -> Scenario:
    if not overwrite and sc.name in SCENARIO_REGISTRY:
        raise KeyError(f"scenario {sc.name!r} already registered")
    SCENARIO_REGISTRY[sc.name] = sc
    return sc


def get_scenario(sc: Union[str, Scenario]) -> Scenario:
    """Resolve a scenario by string key (pass-through for Scenario objects)."""
    if isinstance(sc, Scenario):
        return sc
    if sc in SCENARIO_REGISTRY:
        return SCENARIO_REGISTRY[sc]
    return SCENARIO_REGISTRY[lookup("scenario", sc, SCENARIO_REGISTRY,
                                    DEFERRED_SCENARIOS, 8)]


def list_scenarios() -> list:
    return sorted(SCENARIO_REGISTRY)


register_scenario(Scenario(
    "scarce", "scarce", availability_kwargs={"q": 0.2},
    description="i.i.d. homogeneous availability q=0.2 (paper §4.1)"))
