"""Completion-process registry — the "selected ≠ completed" half of a round
(port of ``repro.sim.completion``; only ``always`` so far).

Engines derive the per-round completion key as ``fold_in(k_sel,
KEY_FOLD)``, a side stream that consumes nothing from the main split, so
``completion="always"`` keeps the availability / selection / budget / batch
draws exactly as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from ..core import keys
from ..registry import lookup

__all__ = ["COMPLETION_REGISTRY", "KEY_FOLD", "AlwaysComplete",
           "CompletionModel", "make_completion", "resolve_completion"]

KEY_FOLD = keys.COMPLETION

DEFERRED_COMPLETIONS = ("bernoulli", "availability_coupled", "deadline")


class CompletionModel:
    """Interface contract: ``n_clients``, ``trivial`` (``sample`` is the
    identity) and ``sample(key, t, sel_mask) -> completed ⊆ sel_mask``."""

    n_clients: int
    trivial: bool = False

    def sample(self, key, t, sel_mask):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AlwaysComplete(CompletionModel):
    """Idealized paper model: every selected client returns its update."""

    n_clients: int
    trivial: bool = True

    def sample(self, key, t, sel_mask):
        return sel_mask


def _direct(cls):
    def make(n_clients: int, avail_model=None, **kw):
        return cls(n_clients=n_clients, **kw)
    return make


COMPLETION_REGISTRY: Dict[str, Callable[..., CompletionModel]] = {
    "always": _direct(AlwaysComplete),
}


def check_completion(name: str) -> str:
    """Fail fast on a completion process this port does not run."""
    return lookup("completion process", name, COMPLETION_REGISTRY,
                  DEFERRED_COMPLETIONS, 8)


def make_completion(name: str, n_clients: int, avail_model=None,
                    **kw) -> CompletionModel:
    """Build a registered completion model by string key."""
    return COMPLETION_REGISTRY[check_completion(name)](
        n_clients, avail_model=avail_model, **kw)


def resolve_completion(scenario, completion: Optional[str],
                       completion_kwargs) -> tuple:
    """Effective (name, kwargs) for a run: a RunSpec that names a process
    replaces the scenario's; kwargs alone overlay the scenario's."""
    sc_name = getattr(scenario, "completion", "always") or "always"
    sc_kwargs = dict(getattr(scenario, "completion_kwargs", {}) or {})
    if completion is not None:
        return str(completion), dict(completion_kwargs or {})
    sc_kwargs.update(dict(completion_kwargs or {}))
    return sc_name, sc_kwargs
