"""The :class:`Scenario` spec and its string-keyed registry (port of
``repro.sim.scenario``, with every built-in scenario).

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
from .processes import AvailabilityModel, make_process


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
                         override_kwargs=None, device=None) -> CompletionModel:
        name, kw = resolve_completion(self, override, override_kwargs)
        return make_completion(name, n_clients, avail_model=avail_model,
                               device=device, **kw)

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
    for key in (sc, sc.lower()):
        if key in SCENARIO_REGISTRY:
            return SCENARIO_REGISTRY[key]
    raise KeyError(f"unknown scenario {sc!r}; known: {list_scenarios()}")


def list_scenarios() -> list:
    return sorted(SCENARIO_REGISTRY)


# Built-in scenarios, as the JAX package registers them: the paper's §4.1
# regimes first, then the scenario engine's.  All default to Synthetic(1,1).
_BUILTIN = (
    Scenario("always", "always",
             description="all clients always available (sanity baseline)"),
    Scenario("scarce", "scarce", availability_kwargs={"q": 0.2},
             description="i.i.d. homogeneous availability q=0.2 (paper §4.1)"),
    Scenario("homedevices", "homedevices",
             description="static heterogeneous availability (paper §4.1)"),
    Scenario("smartphones", "smartphones",
             description="sine-modulated heterogeneous availability "
                         "(paper §D.4)"),
    Scenario("uneven", "uneven",
             description="availability inversely proportional to data size "
                         "(paper §4.1 worst case for FedAvg)"),
    Scenario("bernoulli", "bernoulli",
             availability_kwargs={"q": 0.6, "sigma": 0.5},
             description="i.i.d. Bernoulli with lognormal heterogeneity, "
                         "fixed budget"),
    Scenario("markov", "markov",
             description="cluster-correlated 2-state Markov availability "
                         "(arXiv:2301.04632 regime)"),
    Scenario("gilbert_elliott", "gilbert_elliott",
             description="independent per-client Gilbert-Elliott up/down "
                         "chains (temporally correlated)"),
    Scenario("diurnal", "diurnal", budget="diurnal",
             budget_kwargs={"k_min": 2, "k_hi": 10, "period": 24},
             description="day/night availability waves across timezones × "
                         "diurnal K_t budget"),
    Scenario("drift", "drift",
             availability_kwargs={"horizon": 150},
             description="non-stationary marginals drifting high→low over "
                         "the run (arXiv:2409.17446 regime)"),
    Scenario("trace", "trace",
             availability_kwargs={"length": 48, "seed": 0},
             description="replayed duty-cycle availability trace "
                         "(deterministic)"),
    Scenario("bandwidth", "homedevices", budget="bandwidth",
             budget_kwargs={"k_cap": 10},
             description="heterogeneous availability under a noisy, "
                         "diurnally-contended uplink budget"),
    Scenario("stepk", "scarce", availability_kwargs={"q": 0.5},
             budget="step",
             budget_kwargs={"k_before": 10, "k_after": 3, "t_switch": 75},
             description="abrupt mid-run budget drop 10→3 (capacity outage)"),
    Scenario("dropout", "bernoulli",
             availability_kwargs={"q": 0.6, "sigma": 0.5},
             completion="availability_coupled",
             completion_kwargs={"gamma": 1.0, "floor": 0.05},
             description="heterogeneous availability with mid-round dropout "
                         "coupled to each client's availability marginal"),
    Scenario("straggler", "scarce", availability_kwargs={"q": 0.5},
             completion="deadline",
             completion_kwargs={"deadline": 1.0, "spread": 0.4},
             description="i.i.d. availability with a per-round reporting "
                         "deadline: slow clients miss aggregation"),
)

for _sc in _BUILTIN:
    register_scenario(_sc)
