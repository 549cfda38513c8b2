"""Completion-process registry — the "selected ≠ completed" half of a round
(port of ``repro.sim.completion``).

    model = make_completion("bernoulli", n_clients=100, q=0.8, device=dev)
    completed = model.sample(key, t, sel_mask)     # (N,) bool ⊆ sel_mask

``sample`` is a pure function of (key, t, sel_mask) and the completed mask
is a subset of the selection mask.  Engines derive the per-round
completion key as ``fold_in(k_sel, KEY_FOLD)``, a side stream that consumes
nothing from the main split, so ``completion="always"`` keeps the
availability / selection / budget / batch draws exactly as they are.

Registered: ``always``, ``bernoulli`` (i.i.d., optional lognormal
heterogeneity), ``availability_coupled`` (completion probability
clip(q_k(t)^gamma, floor, 1) from the availability model's marginals) and
``deadline`` (lognormal round latencies against a reporting deadline).
The masks are bitwise the JAX package's; ``rate(t)`` is reporting only
(``deadline``'s normal cdf is ``torch.special.ndtr``, within 1e-6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import random as jr
from .. import xla_math
from ..core import keys
from ..device import OnDevice

__all__ = ["COMPLETION_REGISTRY", "KEY_FOLD", "AlwaysComplete",
           "AvailabilityCoupled", "BernoulliCompletion", "CompletionModel",
           "DeadlineCompletion", "make_completion", "resolve_completion"]

KEY_FOLD = keys.COMPLETION

_f32 = xla_math.f32


class CompletionModel:
    """Interface contract: ``n_clients``, ``trivial`` (``sample`` is the
    identity), ``has_latency`` (``latencies`` is implemented),
    ``sample(key, t, sel_mask) -> completed ⊆ sel_mask``,
    ``latencies(key, t)`` -> (N,) float32 and ``rate(t)`` -> (N,) expected
    completion probability given selection."""

    n_clients: int
    trivial: bool = False
    has_latency: bool = False

    def sample(self, key, t, sel_mask):
        raise NotImplementedError

    def latencies(self, key, t):
        raise NotImplementedError(
            f"{type(self).__name__} has no latency distribution; the "
            "buffered/async engine needs a latency-capable completion "
            "process ('always' or 'deadline')")

    def rate(self, t):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class _Model(OnDevice, CompletionModel):
    """Base of the models below."""

    n_clients: int


@dataclasses.dataclass(frozen=True)
class AlwaysComplete(_Model):
    """Idealized paper model: every selected client returns its update."""

    trivial: bool = True
    has_latency: bool = True

    def sample(self, key, t, sel_mask):
        return sel_mask

    def latencies(self, key, t):
        return torch.ones((self.n_clients,), dtype=torch.float32,
                          device=self.device)

    def rate(self, t):
        return torch.ones((self.n_clients,), dtype=torch.float32,
                          device=self.device)


@dataclasses.dataclass(frozen=True)
class BernoulliCompletion(_Model):
    """I.i.d. per-round completion with probability q; ``sigma > 0``
    modulates it per client by a normalized lognormal draw (the HomeDevices
    construction)."""

    q: float = 0.8
    sigma: float = 0.0
    seed: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.sigma > 0:
            rng = np.random.default_rng(self.seed)
            t_k = rng.lognormal(0.0, self.sigma, self.n_clients)
            qs = self.q * t_k / t_k.max()
        else:
            qs = np.full(self.n_clients, self.q)
        object.__setattr__(self, "_q", self._tensor(qs.astype(np.float32)))

    def rate(self, t):
        return self._q

    def sample(self, key, t, sel_mask):
        return sel_mask & jr.bernoulli(key, self._q)


@dataclasses.dataclass(frozen=True)
class AvailabilityCoupled(_Model):
    """P(complete | selected) = clip(q_k(t) ** gamma, floor, 1), with
    ``marginals`` the scenario's availability model's ``marginals(t)``."""

    marginals: Callable = None            # t -> (N,) availability probs
    gamma: float = 1.0
    floor: float = 0.05

    def __post_init__(self):
        super().__post_init__()
        if self.marginals is None:
            raise TypeError("availability_coupled needs the scenario's "
                            "availability model (marginals)")

    def rate(self, t):
        q = self.marginals(t).to(torch.float32)
        return torch.clamp(xla_math.pow(q, self.gamma), _f32(self.floor),
                           1.0)

    def sample(self, key, t, sel_mask):
        return sel_mask & jr.bernoulli(key, self.rate(t))


@dataclasses.dataclass(frozen=True)
class DeadlineCompletion(_Model):
    """Straggler cutoff: each client has a median latency s_k (lognormal
    across the fleet, ``spread``) and draws s_k · exp(sigma · ε) a round;
    a selected client completes iff that latency <= ``deadline``."""

    deadline: float = 1.0
    spread: float = 0.4
    sigma: float = 0.25
    seed: int = 0
    has_latency: bool = True

    def __post_init__(self):
        super().__post_init__()
        rng = np.random.default_rng(self.seed)
        s_k = rng.lognormal(np.log(0.7), self.spread, self.n_clients)
        object.__setattr__(self, "_scale",
                           self._tensor(s_k.astype(np.float32)))

    def rate(self, t):
        """Phi(log(D / s_k) / sigma) (the indicator s_k <= D at sigma = 0);
        reporting only: the cdf is ``torch.special.ndtr``."""
        if self.sigma <= 0:
            return (self._scale <= _f32(self.deadline)).to(torch.float32)
        z = xla_math.log(_f32(self.deadline) / self._scale) \
            * xla_math.recip(self.sigma)
        return torch.special.ndtr(z.to(torch.float64)).to(torch.float32)

    def latencies(self, key, t):
        eps = jr.normal(key, (self.n_clients,))
        return self._scale * xla_math.exp(eps * _f32(self.sigma))

    def sample(self, key, t, sel_mask):
        return sel_mask & (self.latencies(key, t) <= _f32(self.deadline))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _direct(cls):
    def make(n_clients: int, avail_model=None, device=None, **kw):
        return cls(n_clients=n_clients, device=device, **kw)
    return make


def _make_coupled(n_clients: int, avail_model=None, device=None, **kw):
    if avail_model is None:
        raise TypeError("availability_coupled needs the scenario's "
                        "availability model (pass avail_model=)")
    return AvailabilityCoupled(n_clients=n_clients,
                               marginals=avail_model.marginals,
                               device=device, **kw)


COMPLETION_REGISTRY: Dict[str, Callable[..., CompletionModel]] = {
    "always": _direct(AlwaysComplete),
    "bernoulli": _direct(BernoulliCompletion),
    "availability_coupled": _make_coupled,
    "deadline": _direct(DeadlineCompletion),
}


def check_completion(name: str) -> str:
    """The registry key of a completion process; ``KeyError`` listing the
    known ones otherwise."""
    key = str(name).lower()
    if key not in COMPLETION_REGISTRY:
        raise KeyError(f"unknown completion process {name!r}; "
                       f"known: {sorted(COMPLETION_REGISTRY)}")
    return key


def make_completion(name: str, n_clients: int, avail_model=None,
                    device=None, **kw) -> CompletionModel:
    """Build a registered completion model by string key; ``avail_model``
    is the scenario's availability model (``availability_coupled`` reads
    its ``marginals``)."""
    return COMPLETION_REGISTRY[check_completion(name)](
        n_clients, avail_model=avail_model, device=device, **kw)


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
