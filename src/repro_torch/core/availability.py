"""Client-availability processes (paper §4.1) and communication constraints
(port of ``repro.core.availability``).

Every process produces, per round ``t``, a boolean availability mask
``A_t ∈ {0,1}^N``; samplers are pure functions of an explicit key tensor
(``repro_torch.random``), so the masks are bitwise the JAX package's.  The
paper's five models (Always / Scarce / HomeDevices / SmartPhones / Uneven)
and the cluster-Markov model are here; ``CommBudget`` draws K_t.

The numpy constructions (the lognormal ``_q``) are the JAX package's, so
they give the same float64 values, cast once to float32 as ``jnp.asarray``
casts them.  ``t`` is a Python int (the round index).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import random as jr
from .. import xla_math
from ..device import OnDevice
from .keys import NONEMPTY


def force_nonempty(mask: torch.Tensor, q: torch.Tensor,
                   key: torch.Tensor) -> torch.Tensor:
    """Force a non-empty available set (the paper assumes A_t ≠ ∅): if every
    client is down, wake one chosen uniformly at random among the clients
    with the highest marginal probability.  ``key`` is a derived
    ``fold_in`` key, so the common non-empty path consumes nothing from the
    main stream.  No host sync: the fallback is selected with ``where``."""
    tie = jr.uniform(key, tuple(q.shape))
    cand = torch.where(q >= q.max(), tie, torch.full_like(tie, -1.0))
    idx = torch.argmax(cand)
    fallback = torch.arange(mask.shape[0], device=mask.device) == idx
    return torch.where(mask.any(), mask, fallback)


def force_nonempty_block(mask_blk: torch.Tensor, cand_blk: torch.Tensor,
                         off: int, axis) -> torch.Tensor:
    """Blockwise :func:`force_nonempty` for one shard of the client mesh
    ``axis`` (a ``launch.mesh.ClientMesh``).

    ``cand_blk`` is this shard's slice of the full-width candidate vector
    ``where(q >= q.max(), tie, -1)`` (pad lanes -1).  Each shard reduces its
    (max, first argmax) pair and its available count; one gather brings
    every shard's to every shard, and the first shard holding the global
    max wins, as a global ``argmax`` picks (shards are ordered by offset,
    and within a shard the first local index).  The triple travels as
    float64, which holds the float32 max and the integer id and count
    exactly.  No (N,) tensor anywhere.
    """
    v = cand_blk.max()
    j = torch.argmax(cand_blk)
    mine = torch.stack([v.to(torch.float64), (j + off).to(torch.float64),
                        mask_blk.sum().to(torch.float64)])
    got = axis.all_gather(mine[None]).reshape(-1, 3)
    idx = got[torch.argmax(got[:, 0]), 1].to(torch.int64)
    nonempty = got[:, 2].sum() > 0
    ids = off + torch.arange(mask_blk.shape[0], device=mask_blk.device)
    return torch.where(nonempty, mask_blk, ids == idx)


@dataclasses.dataclass(frozen=True)
class AvailabilityProcess(OnDevice):
    """Base class: per-client marginal probabilities, possibly time-varying."""

    n_clients: int

    def probs(self, t) -> torch.Tensor:
        """Per-client availability probability at round ``t`` — shape (N,)."""
        raise NotImplementedError

    def sample(self, key: torch.Tensor, t) -> torch.Tensor:
        """Boolean availability mask A_t, guaranteed non-empty."""
        q = self.probs(t)
        mask = jr.bernoulli(key, q)
        return force_nonempty(mask, q, jr.fold_in(key, NONEMPTY))


@dataclasses.dataclass(frozen=True)
class Scarce(AvailabilityProcess):
    """I.i.d. homogeneous availability with probability q (paper: q = 0.2)."""

    q: float = 0.2

    def probs(self, t):
        return torch.full((self.n_clients,), self.q, dtype=torch.float32,
                          device=self.device)


@dataclasses.dataclass(frozen=True)
class Always(AvailabilityProcess):
    """Baseline: all clients always available."""

    def probs(self, t):
        return torch.ones((self.n_clients,), dtype=torch.float32,
                          device=self.device)

    def sample(self, key, t):
        return torch.ones((self.n_clients,), dtype=torch.bool,
                          device=self.device)


@dataclasses.dataclass(frozen=True)
class HomeDevices(AvailabilityProcess):
    """q_k = T_k / max_j T_j with T_k ~ lognormal(0, sigma) (paper: 0.5)."""

    sigma: float = 0.5
    seed: int = 0

    def __post_init__(self):
        super().__post_init__()
        rng = np.random.default_rng(self.seed)
        t_k = rng.lognormal(mean=0.0, sigma=self.sigma, size=self.n_clients)
        object.__setattr__(self, "_q", self._tensor(
            (t_k / t_k.max()).astype(np.float32)))

    def probs(self, t):
        return self._q


def smartphones_factor(t: int) -> float:
    """f_t = 0.4 sin(2π (t mod 24) / 24) + 0.5 as the jitted JAX process
    computes it: the folded phase, XLA's ``sin`` and one FMA.  A Python
    float holding a float32 value."""
    phase = torch.tensor([float(t % 24)], dtype=torch.float32) \
        * xla_math.two_pi_over(24)
    s = xla_math.sin(phase)
    return float(xla_math.fma(s, xla_math.f32(0.4), 0.5)[0])


@dataclasses.dataclass(frozen=True)
class SmartPhones(HomeDevices):
    """Sine-modulated HomeDevices: q_{k,t} = f_t * q_k with
    f(t) = 0.4 sin(t) + 0.5 sampled at t = 2*pi*j/24 (paper §D.4,
    sigma=0.25)."""

    sigma: float = 0.25

    def probs(self, t):
        return smartphones_factor(int(t)) * self._q


@dataclasses.dataclass(frozen=True)
class Uneven(AvailabilityProcess):
    """Availability inversely proportional to dataset size: q_k ∝ 1/p_k."""

    p: tuple = ()  # client data fractions, length N
    q_max: float = 0.9

    def __post_init__(self):
        super().__post_init__()
        p = np.asarray(self.p, dtype=np.float64)
        inv = 1.0 / np.maximum(p, 1e-12)
        q = inv / inv.max() * self.q_max
        object.__setattr__(self, "_q", self._tensor(q.astype(np.float32)))

    def probs(self, t):
        return self._q


@dataclasses.dataclass(frozen=True)
class MarkovClusters(AvailabilityProcess):
    """Correlated availability: clients grouped into clusters, each cluster
    driven by a 2-state (up/down) Markov chain; within an up cluster each
    client is available i.i.d. with prob ``q_up``.  Stateful: use
    :meth:`step`, which threads the cluster state."""

    n_clusters: int = 4
    p_up_given_down: float = 0.3
    p_down_given_up: float = 0.1
    q_up: float = 0.9
    q_down: float = 0.05

    def init_state(self) -> torch.Tensor:
        return torch.ones((self.n_clusters,), dtype=torch.bool,
                          device=self.device)

    def cluster_of(self) -> torch.Tensor:
        return torch.arange(self.n_clients, device=self.device) \
            % self.n_clusters

    def step(self, key: torch.Tensor, state: torch.Tensor):
        k1, k1b, k2 = jr.split(key, 3)
        go_up = jr.bernoulli(k1, self.p_up_given_down, state.shape)
        go_down = jr.bernoulli(k1b, self.p_down_given_up, state.shape)
        new_state = torch.where(state, ~go_down, go_up)
        q = torch.where(new_state[self.cluster_of()],
                        xla_math.f32(self.q_up), xla_math.f32(self.q_down))
        mask = jr.bernoulli(k2, q)
        mask = force_nonempty(mask, q, jr.fold_in(k2, NONEMPTY))
        return new_state, mask

    def probs(self, t):  # stationary marginal, for reporting only
        pi_up = self.p_up_given_down / (self.p_up_given_down
                                        + self.p_down_given_up)
        q = pi_up * self.q_up + (1 - pi_up) * self.q_down
        return torch.full((self.n_clients,), q, dtype=torch.float32,
                          device=self.device)


# ---------------------------------------------------------------------------
# Communication constraints K_t
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommBudget:
    """Time-varying communication constraint ``K_t``: ``fixed`` clients a
    round, or with ``jitter > 0`` uniform on [max(1, fixed-jitter),
    fixed+jitter] (an int32 scalar on the key's device)."""

    fixed: int = 10
    jitter: int = 0

    def sample(self, key: torch.Tensor, t) -> torch.Tensor:
        if self.jitter == 0:
            return torch.full((), self.fixed, dtype=torch.int32,
                              device=key.device)
        lo = max(1, self.fixed - self.jitter)
        hi = self.fixed + self.jitter
        return jr.randint(key, (), lo, hi + 1)


AVAILABILITY_REGISTRY = {
    "always": Always,
    "scarce": Scarce,
    "homedevices": HomeDevices,
    "smartphones": SmartPhones,
    "uneven": Uneven,
    "markov": MarkovClusters,
}


def make_availability(name: str, n_clients: int, p=None,
                      **kw) -> AvailabilityProcess:
    """The paper's availability model ``name`` for ``n_clients`` clients;
    ``uneven`` needs the client data fractions ``p``.  ``kw`` goes to the
    model (``device=`` among it: None is CUDA)."""
    name = name.lower()
    if name not in AVAILABILITY_REGISTRY:
        raise KeyError(
            f"unknown availability model {name!r}; registered: "
            f"{sorted(AVAILABILITY_REGISTRY)}")
    if name == "uneven":
        assert p is not None, \
            "Uneven availability needs client data fractions p"
        return Uneven(n_clients=n_clients,
                      p=tuple(np.asarray(p).tolist()), **kw)
    return AVAILABILITY_REGISTRY[name](n_clients=n_clients, **kw)
