"""Availability-process registry — the A_t half of the scenario engine
(port of ``repro.sim.processes``).

    model = make_process("gilbert_elliott", n_clients=100, device=dev)
    state = model.init()
    state, mask = model.step(key_t, state, t)     # mask: (N,) bool
    q = model.marginals(t)                        # (N,) float32

``step`` is a pure function of (key, state, t) with ``t`` the round index
(a Python int); every draw comes from ``repro_torch.random`` and every
float through ``xla_math``, so masks are bitwise the JAX package's.
``marginals(t)`` reports the per-client expected availability (exact for
i.i.d. models, stationary for Markov ones); ``availability_coupled``
completion reads it.

Registered: the paper's five §4.1 / §D.4 models (``always``, ``scarce``,
``homedevices``, ``smartphones``, ``uneven``) through :class:`Stateless`,
and ``bernoulli``, ``markov``, ``gilbert_elliott``, ``diurnal``, ``drift``
and ``trace``.  ``bernoulli`` also has ``step_block``, the sharded
engine's O(n_local) step of one shard's block.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import random as jr
from .. import xla_math
from ..core import availability as core_av
from ..core.blockrng import block_bernoulli, block_uniform
from ..core.keys import NONEMPTY
from ..device import OnDevice

_f32 = xla_math.f32


def _nonempty(mask: torch.Tensor, q: torch.Tensor,
              key: torch.Tensor) -> torch.Tensor:
    """Wake a uniformly random max-marginal client if all are down
    (``core.availability.force_nonempty``; ``key`` a derived fold_in)."""
    return core_av.force_nonempty(mask, q, key)


def _t32(t: int, device) -> torch.Tensor:
    """The round index as the jitted engine sees it: float32."""
    return torch.full((), float(t), dtype=torch.float32, device=device)


class AvailabilityModel:
    """Interface contract: ``n_clients``, ``init()``, ``step(key, state, t)
    -> (state', mask)`` with a non-empty (N,) bool mask, and
    ``marginals(t)`` -> (N,) float32 expected availability."""

    n_clients: int

    def init(self):
        return ()

    def step(self, key: torch.Tensor, state, t):
        raise NotImplementedError

    def marginals(self, t) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Stateless(AvailabilityModel):
    """Adapter: a stateless ``core.availability.AvailabilityProcess``
    exposed through the stateful scenario interface."""

    proc: core_av.AvailabilityProcess

    @property
    def n_clients(self) -> int:
        return self.proc.n_clients

    def init(self):
        return ()

    def step(self, key, state, t):
        return state, self.proc.sample(key, t)

    def marginals(self, t):
        return self.proc.probs(t)


@dataclasses.dataclass(frozen=True)
class ClusterMarkov(AvailabilityModel):
    """Adapter for ``core.availability.MarkovClusters`` (clients share
    cluster-level up/down chains)."""

    proc: core_av.MarkovClusters

    @property
    def n_clients(self) -> int:
        return self.proc.n_clients

    def init(self):
        return self.proc.init_state()

    def step(self, key, state, t):
        return self.proc.step(key, state)

    def marginals(self, t):
        return self.proc.probs(t)


@dataclasses.dataclass(frozen=True)
class _OnDevice(OnDevice, AvailabilityModel):
    """Base of the models below."""

    n_clients: int


@dataclasses.dataclass(frozen=True)
class Bernoulli(_OnDevice):
    """I.i.d. Bernoulli availability; ``sigma > 0`` modulates per-client
    probabilities by a normalized lognormal draw (the HomeDevices
    construction) scaled so the most available client has probability
    ``q``."""

    q: float = 0.5
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
        qs32 = np.asarray(qs, np.float32)
        object.__setattr__(self, "_q", self._tensor(qs32))
        object.__setattr__(self, "_q_max", float(qs32.max()))

    def marginals(self, t):
        return self._q

    def step(self, key, state, t):
        mask = jr.bernoulli(key, self._q)
        return state, _nonempty(mask, self._q, jr.fold_in(key, NONEMPTY))

    def step_block(self, key, state, t, *, off: int, n_local: int, axis):
        """One shard's slice [off, off + n_local) of ``step``'s mask,
        bitwise the slice, at O(n_local) with no (N,) intermediate
        (``core.blockrng``; the non-empty guarantee reduces per-shard
        (max, argmax) candidates over the mesh ``axis``).  Pad lanes come
        back False."""
        n = self.n_clients
        ids = off + torch.arange(n_local, device=self.device)
        real = ids < n
        q_blk = torch.where(real, self._q[torch.clamp_max(ids, n - 1)],
                            0.0)
        mask = block_bernoulli(key, q_blk, n, off, n_local) & real
        tie = block_uniform(jr.fold_in(key, NONEMPTY), n, off, n_local)
        cand = torch.where(real & (q_blk >= self._q_max), tie, -1.0)
        return state, core_av.force_nonempty_block(mask, cand, off, axis)


@dataclasses.dataclass(frozen=True)
class GilbertElliott(_OnDevice):
    """Independent per-client Gilbert-Elliott chains: up→down with
    ``p_down``, down→up with ``p_up``; answering with ``q_up`` while up
    and ``q_down`` while down."""

    p_up: float = 0.25
    p_down: float = 0.08
    q_up: float = 0.95
    q_down: float = 0.05
    init_up_fraction: float = 1.0

    @property
    def stationary_up(self) -> float:
        return self.p_up / (self.p_up + self.p_down)

    def init(self):
        n_up = int(round(self.init_up_fraction * self.n_clients))
        return torch.arange(self.n_clients, device=self.device) < n_up

    def step(self, key, state, t):
        k_up, k_down, k_avail = jr.split(key, 3)
        go_up = jr.bernoulli(k_up, self.p_up, state.shape)
        go_down = jr.bernoulli(k_down, self.p_down, state.shape)
        new = torch.where(state, ~go_down, go_up)
        q = torch.where(new, _f32(self.q_up), _f32(self.q_down))
        mask = jr.bernoulli(k_avail, q)
        return new, _nonempty(mask, q, jr.fold_in(k_avail, NONEMPTY))

    def marginals(self, t):
        pi = self.stationary_up
        q = pi * self.q_up + (1.0 - pi) * self.q_down
        return torch.full((self.n_clients,), q, dtype=torch.float32,
                          device=self.device)


@dataclasses.dataclass(frozen=True)
class Diurnal(_OnDevice):
    """Periodic day/night availability with per-client phase offsets:
    q_{k,t} = clip(base + amplitude sin(2π (t + φ_k) / period), q_floor, 1),
    with φ_k uniform over the period (``phase_spread``) or all 0."""

    period: int = 24
    base: float = 0.5
    amplitude: float = 0.4
    q_floor: float = 0.02
    phase_spread: bool = True
    seed: int = 0

    def __post_init__(self):
        super().__post_init__()
        rng = np.random.default_rng(self.seed)
        phase = (rng.uniform(0.0, self.period, self.n_clients)
                 if self.phase_spread else np.zeros(self.n_clients))
        object.__setattr__(self, "_phase",
                           self._tensor(np.asarray(phase, np.float32)))

    def marginals(self, t):
        ang = (_t32(t, self.device) + self._phase) \
            * xla_math.two_pi_over(self.period)
        q = xla_math.fma(xla_math.sin(ang), _f32(self.amplitude),
                         _f32(self.base))
        return torch.clamp(q, _f32(self.q_floor), 1.0)

    def step(self, key, state, t):
        q = self.marginals(t)
        mask = jr.bernoulli(key, q)
        return state, _nonempty(mask, q, jr.fold_in(key, NONEMPTY))


@dataclasses.dataclass(frozen=True)
class NonStationaryDrift(_OnDevice):
    """Per-client marginals drifting linearly from q0 (uniform on [q0_lo,
    q0_hi]) to q1 (uniform on [q1_lo, q1_hi]) over ``horizon`` rounds, then
    staying at q1."""

    horizon: int = 200
    q0_lo: float = 0.6
    q0_hi: float = 0.9
    q1_lo: float = 0.05
    q1_hi: float = 0.4
    seed: int = 0

    def __post_init__(self):
        super().__post_init__()
        rng = np.random.default_rng(self.seed)
        q0 = rng.uniform(self.q0_lo, self.q0_hi, self.n_clients)
        q1 = rng.uniform(self.q1_lo, self.q1_hi, self.n_clients)
        object.__setattr__(self, "_q0", self._tensor(q0.astype(np.float32)))
        object.__setattr__(self, "_q1", self._tensor(q1.astype(np.float32)))

    def marginals(self, t):
        s = torch.clamp(_t32(t, self.device) * xla_math.recip(self.horizon),
                        0.0, 1.0)
        return xla_math.fma(1.0 - s, self._q0, s * self._q1)

    def step(self, key, state, t):
        q = self.marginals(t)
        mask = jr.bernoulli(key, q)
        return state, _nonempty(mask, q, jr.fold_in(key, NONEMPTY))


@dataclasses.dataclass(frozen=True)
class TraceDriven(_OnDevice):
    """Replay an explicit (T, N) boolean availability trace, cycled (the key
    is unused).  Build with :meth:`from_array` or :meth:`synthetic`."""

    trace: tuple = ()

    def __post_init__(self):
        super().__post_init__()
        arr = np.asarray(self.trace, bool)
        assert arr.ndim == 2 and arr.shape[1] == self.n_clients, arr.shape
        assert arr.any(axis=1).all(), "trace has an all-unavailable round"
        object.__setattr__(self, "_trace", self._tensor(arr))

    @classmethod
    def from_array(cls, trace: np.ndarray, device=None) -> "TraceDriven":
        trace = np.asarray(trace, bool)
        return cls(n_clients=trace.shape[1],
                   trace=tuple(map(tuple, trace.tolist())), device=device)

    @classmethod
    def synthetic(cls, n_clients: int, length: int = 48,
                  duty_lo: float = 0.2, duty_hi: float = 0.9, seed: int = 0,
                  device=None) -> "TraceDriven":
        """Duty-cycle trace: each client is up for a contiguous fraction of
        the cycle (drawn from [duty_lo, duty_hi]) from a random offset."""
        rng = np.random.default_rng(seed)
        duty = rng.uniform(duty_lo, duty_hi, n_clients)
        offset = rng.integers(0, length, n_clients)
        t_idx = np.arange(length)[:, None]
        up_len = np.maximum(1, (duty * length).astype(int))[None, :]
        rel = (t_idx - offset[None, :]) % length
        trace = rel < up_len
        assert trace.any(axis=1).all()
        return cls.from_array(trace, device=device)

    @property
    def length(self) -> int:
        return self._trace.shape[0]

    def step(self, key, state, t):
        return state, self._trace[int(t) % self.length]

    def marginals(self, t):
        return self._trace.to(torch.float32).sum(0) \
            * xla_math.recip(self.length)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _stateless(cls):
    def make(n_clients: int, p=None, device=None, **kw):
        return Stateless(cls(n_clients=n_clients, device=device, **kw))
    return make


def _make_uneven(n_clients: int, p=None, device=None, **kw):
    assert p is not None, "uneven availability needs client data fractions p"
    return Stateless(core_av.Uneven(n_clients=n_clients,
                                    p=tuple(np.asarray(p).tolist()),
                                    device=device, **kw))


def _make_markov(n_clients: int, p=None, device=None, **kw):
    return ClusterMarkov(core_av.MarkovClusters(n_clients=n_clients,
                                                device=device, **kw))


def _make_trace(n_clients: int, p=None, trace=None, device=None, **kw):
    if trace is None:
        return TraceDriven.synthetic(n_clients, device=device, **kw)
    return TraceDriven.from_array(np.asarray(trace), device=device)


def _direct(cls):
    def make(n_clients: int, p=None, device=None, **kw):
        return cls(n_clients=n_clients, device=device, **kw)
    return make


PROCESS_REGISTRY: Dict[str, Callable[..., AvailabilityModel]] = {
    # the paper's five §4.1 / §D.4 models
    "always": _stateless(core_av.Always),
    "scarce": _stateless(core_av.Scarce),
    "homedevices": _stateless(core_av.HomeDevices),
    "smartphones": _stateless(core_av.SmartPhones),
    "uneven": _make_uneven,
    # scenario-engine regimes
    "bernoulli": _direct(Bernoulli),
    "markov": _make_markov,
    "gilbert_elliott": _direct(GilbertElliott),
    "diurnal": _direct(Diurnal),
    "drift": _direct(NonStationaryDrift),
    "trace": _make_trace,
}


def check_process(name: str) -> str:
    """The registry key of an availability process; ``KeyError`` listing
    the known ones otherwise."""
    key = str(name).lower()
    if key not in PROCESS_REGISTRY:
        raise KeyError(f"unknown availability process {name!r}; "
                       f"known: {sorted(PROCESS_REGISTRY)}")
    return key


def make_process(name: str, n_clients: int, p: Optional[object] = None,
                 device=None, **kw) -> AvailabilityModel:
    """Build a registered availability model by string key."""
    return PROCESS_REGISTRY[check_process(name)](n_clients, p=p,
                                                 device=device, **kw)
