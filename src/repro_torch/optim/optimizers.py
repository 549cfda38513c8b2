"""Server optimizers (port of ``repro.optim.optimizers``): sgd, adam, adamw
and yogi, the FEDOPT family the paper composes with (FedAvg = server SGD
with lr = 1, FedAdam = server Adam).

An :class:`Optimizer` is an (init, update) pair over parameter dicts:
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


class AdamState(NamedTuple):
    t: int                     # steps taken
    m: dict                    # first moments, float32
    v: dict                    # second moments, float32


def _adam_family(lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, yogi_update: bool) -> Optimizer:
    f32 = torch.float32

    def init(params):
        zeros = {k: torch.zeros_like(p, dtype=f32) for k, p in params.items()}
        return AdamState(0, zeros, {k: z.clone() for k, z in zeros.items()})

    def update(direction, state, params=None):
        t = state.t + 1
        d = {k: x.to(f32) for k, x in direction.items()}
        m = {k: b1 * state.m[k] + (1 - b1) * d[k] for k in d}
        if yogi_update:
            # v -= (1 - b2) sign(v - d²) d²: additive, sign-controlled
            v = {k: state.v[k] - (1 - b2) * torch.sign(state.v[k] - d[k] * d[k])
                 * (d[k] * d[k]) for k in d}
        else:
            v = {k: b2 * state.v[k] + (1 - b2) * (d[k] * d[k]) for k in d}
        # the bias corrections 1 - b^t in float32, held as Python floats
        tf = torch.tensor(float(t), dtype=f32)
        c1 = float(1 - torch.tensor(b1, dtype=f32) ** tf)
        c2 = float(1 - torch.tensor(b2, dtype=f32) ** tf)
        upd = {k: lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
               for k in d}
        if weight_decay and params is not None:
            upd = {k: u - lr * weight_decay * params[k].to(f32)
                   for k, u in upd.items()}
        upd = {k: u.to(direction[k].dtype) for k, u in upd.items()}
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


def apply_updates(params: dict, updates: dict) -> dict:
    """params + updates (FEDOPT server step: w <- w + Δ-derived update)."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
