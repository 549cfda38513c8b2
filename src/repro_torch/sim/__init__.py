"""Scenario engine of the port: spec, registries, the device, sharded and
buffered engines, the host loop and the runner.  The names are the JAX
package's ``repro.sim`` (``tools/api_surface.json``)."""
from .processes import (PROCESS_REGISTRY, AvailabilityModel, Bernoulli,
                        ClusterMarkov, Diurnal, GilbertElliott,
                        NonStationaryDrift, Stateless, TraceDriven,
                        make_process)
from .budgets import (BUDGET_REGISTRY, BandwidthCoupled, BudgetSchedule,
                      Constant, DiurnalBudget, Jittered, StepBudget,
                      make_budget)
from .completion import (COMPLETION_REGISTRY, AlwaysComplete,
                         AvailabilityCoupled, BernoulliCompletion,
                         CompletionModel, DeadlineCompletion,
                         make_completion, resolve_completion)
from .spec import RunSpec
from .scenario import (SCENARIO_REGISTRY, Scenario, get_scenario,
                       list_scenarios, register_scenario)
from .runner import TrainResult, build_task, run_scenario, run_spec
from .engine import (DeviceEngine, build_engine, run_cells_vmapped,
                     run_scenario_device)
from .engine_sharded import ShardedEngine, resolve_client_mesh
from .engine_async import (STALENESS_DISCOUNTS, AsyncEngine,
                           register_staleness_discount,
                           run_scenario_buffered, staleness_weights)
