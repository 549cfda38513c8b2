"""Scenario engine of the port: spec, registries, device engine, runner."""
from .spec import RunSpec
from .scenario import (SCENARIO_REGISTRY, Scenario, get_scenario,
                       list_scenarios, register_scenario)
from .runner import TrainResult, build_task, run_spec
from .engine import DeviceEngine, build_engine, run_scenario_device
