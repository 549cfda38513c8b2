"""Server optimizers (port of ``repro.optim.optimizers``): sgd, adam, adamw
and yogi, the FEDOPT family the paper composes with (FedAvg = server SGD
with lr = 1, FedAdam = server Adam).

An :class:`Optimizer` is an (init, update) pair over parameter trees
(nested dicts and lists, ``repro_torch.tree``):
``update(direction, state, params) -> (updates, state)`` returns updates to
be *added* to the params (pass the aggregated pseudo-gradient Δ; with
lr = 1, SERVEROPT(w, Δ) = w + Δ).  The Adam family computes what the JAX
one does, op for op in float32; it is held to the parameter tolerance,
not bitwise.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..registry import lookup
from ..tree import tree_map


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
        return tree_map(lambda d: lr * d, direction), SgdState(state.t + 1)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    t: int                     # steps taken
    m: Any                     # first moments, float32 (a parameter tree)
    v: Any                     # second moments, float32


def _adam_family(lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, yogi_update: bool) -> Optimizer:
    f32 = torch.float32

    def init(params):
        return AdamState(0, tree_map(lambda p: torch.zeros_like(p, dtype=f32),
                                     params),
                         tree_map(lambda p: torch.zeros_like(p, dtype=f32),
                                  params))

    def update(direction, state, params=None):
        t = state.t + 1
        d = tree_map(lambda x: x.to(f32), direction)
        m = tree_map(lambda m_, d_: b1 * m_ + (1 - b1) * d_, state.m, d)
        if yogi_update:
            # v -= (1 - b2) sign(v - d²) d²: additive, sign-controlled
            v = tree_map(lambda v_, d_: v_ - (1 - b2)
                         * torch.sign(v_ - d_ * d_) * (d_ * d_), state.v, d)
        else:
            v = tree_map(lambda v_, d_: b2 * v_ + (1 - b2) * (d_ * d_),
                         state.v, d)
        # the bias corrections 1 - b^t in float32, held as Python floats
        tf = torch.tensor(float(t), dtype=f32)
        c1 = float(1 - torch.tensor(b1, dtype=f32) ** tf)
        c2 = float(1 - torch.tensor(b2, dtype=f32) ** tf)
        upd = tree_map(lambda m_, v_: lr * (m_ / c1)
                       / (torch.sqrt(v_ / c2) + eps), m, v)
        if weight_decay and params is not None:
            upd = tree_map(lambda u, p: u - lr * weight_decay * p.to(f32),
                           upd, params)
        upd = tree_map(lambda u, x: u.to(x.dtype), upd, direction)
        return upd, AdamState(t, m, v)

    return Optimizer(init, update)


def adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _adam_family(lr, b1, b2, eps, weight_decay=0.0, yogi_update=False)


def adamw(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
          weight_decay=0.01) -> Optimizer:
    return _adam_family(lr, b1, b2, eps, weight_decay, yogi_update=False)


def yogi(lr=1e-2, b1=0.9, b2=0.999, eps=1e-3) -> Optimizer:
    return _adam_family(lr, b1, b2, eps, weight_decay=0.0, yogi_update=True)


_REGISTRY = {"sgd": sgd, "adam": adam, "adamw": adamw, "yogi": yogi}


def make_optimizer(name: str, **kw) -> Optimizer:
    return _REGISTRY[lookup("optimizer", name, _REGISTRY, (), 5)](**kw)


def apply_updates(params, updates):
    """params + updates (FEDOPT server step: w <- w + Δ-derived update)."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
