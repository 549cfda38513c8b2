"""Server optimizers (port of ``repro.optim.optimizers``; only ``sgd`` so
far — adam, adamw and yogi are ROADMAP.md queue 1 item 5).

An :class:`Optimizer` is an (init, update) pair over parameter dicts:
``update(direction, state, params) -> (updates, state)`` returns updates to
be *added* to the params (pass the aggregated pseudo-gradient Δ; with
lr = 1, SERVEROPT(w, Δ) = w + Δ).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from ..registry import lookup

DEFERRED_OPTIMIZERS = ("adam", "adamw", "yogi")


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]


class SgdState(NamedTuple):
    t: int


def sgd(lr: float = 1.0) -> Optimizer:
    """SGD on a descent direction: updates = lr * direction (the JAX
    package's momentum option has no caller and is not ported)."""

    def init(params):
        return SgdState(0)

    def update(direction, state, params=None):
        return ({k: lr * d for k, d in direction.items()},
                SgdState(state.t + 1))

    return Optimizer(init, update)


_REGISTRY = {"sgd": sgd}


def make_optimizer(name: str, **kw) -> Optimizer:
    return _REGISTRY[lookup("optimizer", name, _REGISTRY,
                            DEFERRED_OPTIMIZERS, 5)](**kw)


def apply_updates(params: dict, updates: dict) -> dict:
    """params + updates (FEDOPT server step: w <- w + Δ-derived update)."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
