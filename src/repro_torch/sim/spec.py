"""RunSpec: one frozen, JSON-round-trippable description of a run.

Port of ``repro.sim.spec`` with every field and the same
``to_json``/``from_json``, so one spec file drives both packages:

    spec = RunSpec.from_json(open("run.json").read())
    repro.sim.run_spec(spec)                      # JAX package
    repro_torch.sim.run_spec(spec)                # this port, on CUDA

``resolved()`` validates as the JAX package does, then checks that this
port has every registered name the spec uses, before anything runs.  A
1-D ``mesh_shape`` ``(c,)`` runs the client-sharded engine, a 2-D ``(c,
m)`` the (clients, model) mesh; the collective backend is an argument of
``runner.run_spec_dist`` (``dist_backend=``), not a field, so a spec file
crosses between the packages.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional, Union

import numpy as np

from ..core.strategies import SELECT_IMPLS, resolve_strategy
from ..optim.optimizers import make_optimizer
from ..configs.paper_tasks import DEFERRED_TASKS, PAPER_TASKS
from ..registry import lookup
from .budgets import check_budget
from .completion import check_completion, resolve_completion
from .processes import check_process
from .scenario import Scenario, get_scenario

# The JAX package's sharded top-k reductions (core.selection.TOPK_IMPLS),
# validated so that a spec is valid in both packages or in neither.
TOPK_IMPLS = ("stream", "allgather")

__all__ = ["RunSpec"]


def _real(value) -> bool:
    """True for int/float (not bool) — the scalars RunSpec accepts."""
    return (isinstance(value, (int, float, np.integer, np.floating))
            and not isinstance(value, bool))


def _check_positive_int(value, field: str, *, optional: bool = False) -> None:
    """Reject zero/negative/non-integer run-shape fields with a clear error
    instead of a ``ZeroDivisionError`` (eval_every=0 inside ``t %
    eval_every``) or an ``IndexError`` (rounds=0 on ``history[-1]``) deep
    inside an engine."""
    if value is None:
        if optional:
            return
        raise ValueError(f"RunSpec.{field} must be set")
    if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
        raise ValueError(f"RunSpec.{field} must be an int >= 1, "
                         f"got {value!r}")
    if value < 1:
        raise ValueError(f"RunSpec.{field} must be >= 1, got {value}")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Everything one (scenario × strategy) cell needs, as plain data."""

    # what to run
    scenario: Union[str, Scenario] = "scarce"   # registry key or inline spec
    strategy: str = "f3ast"                     # STRATEGY_REGISTRY key/alias
    strategy_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    completion: Optional[str] = None            # COMPLETION_REGISTRY key;
    #   None -> the scenario's own completion process (default "always").
    #   completion_kwargs overlay the scenario's kwargs when completion is
    #   None (dropout-severity sweeps), replace them when it is set.
    completion_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    rounds: Optional[int] = None                # None -> scenario/task default
    clients_per_round: Optional[int] = None     # None -> task default M
    beta: Optional[float] = None                # rate-EMA step; task default
    positively_correlated: bool = False         # H(r) variant (paper Eq. 3)
    # server aggregation semantics
    aggregation: str = "sync"                   # "sync" | "buffered" (§7.4)
    buffer_size: Optional[int] = None           # buffered: arrivals per server
    #   step (None -> max(1, M // 2), resolved when the cell is built)
    staleness_power: float = 0.5                # buffered: discount exponent
    staleness_discount: str = "polynomial"      # STALENESS_DISCOUNTS key
    # server side
    server_opt: str = "sgd"
    server_lr: Optional[float] = None           # None -> opt default (resolve)
    prox_mu: float = 0.0                        # FedProx proximal coefficient
    # execution
    seed: int = 0
    engine: str = "device"                      # "device" | "host"
    select_impl: str = "xla"                    # top-k cut: "xla" | "pallas"
    #   "pallas" routes every topk_strategy through the fused selection
    #   kernel (repro.kernels.fed_select) — bit-identical masks/rates,
    #   one pass over the client axis.  Unsupported with mesh= (the
    #   sharded engine keeps its distributed sharded_topk_mask).
    topk_impl: str = "stream"                   # sharded top-k reduction:
    #   "stream" (ppermute candidate merge, O(k·log D) traffic) |
    #   "allgather" (legacy full candidate gather).  Bit-identical masks
    #   either way (core.selection.TOPK_IMPLS); ignored off-mesh.
    mesh_shape: Optional[Any] = None            # (c,) | (c, m) | None;
    #   0 entries fill with the visible devices (launch.mesh.make_fed_mesh)
    clients_axis: str = "clients"
    model_axis: str = "model"                   # 2-D mesh trailing axis name
    chunk_size: Optional[int] = None            # device engine rounds/chunk
    fed_mode: str = "parallel"                  # cohort execution (DESIGN §4)
    # outputs
    eval_every: int = 10
    ckpt_dir: Optional[str] = None
    metrics_path: Optional[str] = None          # per-round JSONL stream

    def replace(self, **overrides) -> "RunSpec":
        return dataclasses.replace(self, **overrides)

    def resolved(self) -> "RunSpec":
        """Validate + normalize: alias resolution (``fedadam`` → fedavg +
        Adam server) and server-lr defaulting happen HERE, once, before any
        engine dispatch; unknown strategy/scenario/completion keys raise
        ``KeyError`` listing the registered names and invalid numeric
        fields raise ``ValueError`` (fail fast, never inside a compiled
        loop or as a ``ZeroDivisionError`` mid-run)."""
        name, server_opt, server_lr = resolve_strategy(
            self.strategy, self.server_opt, self.server_lr)
        sc = get_scenario(self.scenario)       # KeyError w/ known keys
        comp_name, comp_kwargs = resolve_completion(
            sc, self.completion, self.completion_kwargs)
        check_completion(comp_name)
        if self.engine not in ("device", "host"):
            raise ValueError(f"engine must be 'device' or 'host', "
                             f"got {self.engine!r}")
        if self.select_impl not in SELECT_IMPLS:
            raise ValueError(f"select_impl must be one of {SELECT_IMPLS}, "
                             f"got {self.select_impl!r}")
        if self.topk_impl not in TOPK_IMPLS:
            raise ValueError(f"topk_impl must be one of {TOPK_IMPLS}, "
                             f"got {self.topk_impl!r}")
        mesh_shape = self.mesh_shape
        if mesh_shape is not None:
            if isinstance(mesh_shape, (list, tuple)):
                mesh_shape = tuple(mesh_shape)
            bad = (not isinstance(mesh_shape, tuple) or not mesh_shape
                   or len(mesh_shape) > 2
                   or any(isinstance(s, bool)
                          or not isinstance(s, (int, np.integer)) or s < 0
                          for s in mesh_shape)
                   or sum(1 for s in mesh_shape if s == 0) > 1)
            if bad:
                raise ValueError(
                    f"RunSpec.mesh_shape must be None or a tuple of 1-2 "
                    f"non-negative ints with at most one 0 entry (= fill "
                    f"with the visible devices), got {self.mesh_shape!r}")
            mesh_shape = tuple(int(s) for s in mesh_shape)
        if self.select_impl == "pallas" and mesh_shape is not None:
            raise ValueError(
                "select_impl='pallas' fuses the single-device top-k cut; "
                "the client-sharded engine keeps its distributed "
                "sharded_topk_mask (drop mesh_shape= or use "
                "select_impl='xla')")
        if self.fed_mode not in ("parallel", "sequential"):
            raise ValueError(f"fed_mode must be 'parallel' or 'sequential', "
                             f"got {self.fed_mode!r}")
        if self.aggregation not in ("sync", "buffered"):
            raise ValueError(f"aggregation must be 'sync' or 'buffered', "
                             f"got {self.aggregation!r}")
        if self.aggregation == "buffered":
            if mesh_shape is not None:
                raise ValueError(
                    "aggregation='buffered' has no client-sharded engine "
                    "yet; drop mesh_shape= or use aggregation='sync'")
            from .engine_async import STALENESS_DISCOUNTS  # lazy: spec↔engine
            if self.staleness_discount not in STALENESS_DISCOUNTS:
                raise KeyError(
                    f"unknown staleness discount "
                    f"{self.staleness_discount!r}; "
                    f"known: {sorted(STALENESS_DISCOUNTS)}")
            if not (isinstance(self.staleness_power, (int, float))
                    and not isinstance(self.staleness_power, bool)
                    and self.staleness_power >= 0):
                raise ValueError(f"RunSpec.staleness_power must be a "
                                 f"float >= 0, got {self.staleness_power!r}")
        _check_positive_int(self.buffer_size, "buffer_size", optional=True)
        _check_positive_int(self.rounds, "rounds", optional=True)
        _check_positive_int(self.eval_every, "eval_every")
        _check_positive_int(self.chunk_size, "chunk_size", optional=True)
        _check_positive_int(self.clients_per_round, "clients_per_round",
                            optional=True)
        for fname in ("strategy_kwargs", "completion_kwargs"):
            kw = getattr(self, fname)
            if not isinstance(kw, Mapping) or not all(
                    isinstance(k, str) for k in kw):
                raise ValueError(f"RunSpec.{fname} must be a mapping with "
                                 f"string keys, got {kw!r}")
        if self.beta is not None and not (
                _real(self.beta) and 0.0 < float(self.beta) <= 1.0):
            raise ValueError(f"RunSpec.beta must be None or a float in "
                             f"(0, 1], got {self.beta!r}")
        if not isinstance(self.positively_correlated, bool):
            raise ValueError(f"RunSpec.positively_correlated must be a bool, "
                             f"got {self.positively_correlated!r}")
        if isinstance(self.seed, bool) or not isinstance(
                self.seed, (int, np.integer)) or self.seed < 0:
            raise ValueError(f"RunSpec.seed must be an int >= 0, "
                             f"got {self.seed!r}")
        if not (_real(self.prox_mu) and float(self.prox_mu) >= 0.0):
            raise ValueError(f"RunSpec.prox_mu must be a float >= 0, "
                             f"got {self.prox_mu!r}")
        if not isinstance(self.clients_axis, str) or not self.clients_axis:
            raise ValueError(f"RunSpec.clients_axis must be a non-empty "
                             f"mesh-axis name, got {self.clients_axis!r}")
        if not isinstance(self.model_axis, str) or not self.model_axis:
            raise ValueError(f"RunSpec.model_axis must be a non-empty "
                             f"mesh-axis name, got {self.model_axis!r}")
        if self.model_axis == self.clients_axis:
            raise ValueError(f"RunSpec.model_axis must differ from "
                             f"clients_axis, both are {self.model_axis!r}")
        for fname in ("ckpt_dir", "metrics_path"):
            val = getattr(self, fname)
            if val is not None and (not isinstance(val, str) or not val):
                raise ValueError(f"RunSpec.{fname} must be None or a "
                                 f"non-empty path string, got {val!r}")
        _reject_unported(sc, server_opt)
        return dataclasses.replace(self, strategy=name,
                                   server_opt=server_opt,
                                   server_lr=server_lr,
                                   mesh_shape=mesh_shape)

    # -- JSON round-trip ----------------------------------------------------

    def to_dict(self) -> dict:
        return _plain(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunSpec":
        d = dict(d)
        sc = d.get("scenario")
        if isinstance(sc, Mapping):
            sc = dict(sc)
            if "algorithms" in sc:
                sc["algorithms"] = tuple(sc["algorithms"])
            d["scenario"] = Scenario(**sc)
        ms = d.get("mesh_shape")
        if isinstance(ms, list):               # JSON round-trip: list → tuple
            d["mesh_shape"] = tuple(ms)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise KeyError(f"unknown RunSpec fields {sorted(unknown)}")
        return cls(**d)

    def to_json(self, **dumps_kwargs) -> str:
        dumps_kwargs.setdefault("indent", 1)
        return json.dumps(self.to_dict(), **dumps_kwargs)

    @classmethod
    def from_json(cls, s: str) -> "RunSpec":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "RunSpec":
        with open(path) as f:
            return cls.from_json(f.read())


def _reject_unported(sc: Scenario, server_opt: str) -> None:
    """Fail fast on a name the port's registries lack (after the JAX
    package's own validation, so an invalid spec still raises what it
    raises there)."""
    make_optimizer(server_opt)
    check_budget(sc.budget)
    check_process(sc.availability)
    lookup("task", sc.task, PAPER_TASKS, DEFERRED_TASKS, 10)


def _plain(obj):
    """Recursively coerce numpy scalars/arrays so json.dumps round-trips."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if hasattr(obj, "__array__"):      # tensors (e.g. an r_target)
        return np.asarray(obj).tolist()
    return obj
