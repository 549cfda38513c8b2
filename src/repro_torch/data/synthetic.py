"""Synthetic federated data (port of ``repro.data.synthetic``'s numpy
makers).

* ``make_synthetic_federated`` — the paper's Synthetic(alpha, beta);
* ``make_char_lm_federated`` — the Shakespeare stand-in: per-client (per
  role) Markov character streams;
* ``make_vision_federated`` — the CIFAR100 stand-in: class-conditional
  Gaussian images, LDA-partitioned (``partition.dirichlet_partition``).

Pure numpy (``np.random.default_rng``), copied op for op, so the same seed
and kwargs give the same bytes as the JAX package's makers.

* ``SynthTask`` — Synthetic(alpha, beta) as a pure function of the client
  id, drawn from the port's threefry (``repro_torch.random``): the engines
  synthesize only the selected cohort's block each round, so client data
  costs no resident bytes at any N.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .. import random as jr
from .. import xla_math
from .partition import dirichlet_partition


@dataclasses.dataclass
class SyntheticDataset:
    """One client's data."""
    train: dict                      # {"x": ..., "y": ...}
    test: dict


def _split(d: dict, frac=0.8, seed=0):
    n = len(next(iter(d.values())))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    cut = max(int(n * frac), 1)
    tr = {k: v[perm[:cut]] for k, v in d.items()}
    te = {k: v[perm[cut:]] if cut < n else v[perm[:1]] for k, v in d.items()}
    return SyntheticDataset(train=tr, test=te)


def make_synthetic_federated(n_clients=100, dim=60, n_classes=10,
                             alpha=1.0, beta=1.0, samples_per_client=None,
                             seed=0) -> List[SyntheticDataset]:
    """Synthetic(alpha, beta) of Li et al. 2018 (paper §4.1 uses (1,1))."""
    rng = np.random.default_rng(seed)
    # power-law client sizes as in the original generator
    if samples_per_client is None:
        sizes = (rng.lognormal(4, 2, n_clients).astype(int) + 50)
        sizes = np.minimum(sizes, 1000)
    else:
        sizes = np.full(n_clients, samples_per_client)
    diag = np.array([(j + 1) ** -1.2 for j in range(dim)])
    clients = []
    for k in range(n_clients):
        u_k = rng.normal(0, alpha)
        b_mean = rng.normal(0, beta)
        v_k = rng.normal(b_mean, 1.0, size=dim)
        W = rng.normal(u_k, 1.0, size=(dim, n_classes))
        b = rng.normal(u_k, 1.0, size=n_classes)
        # x ~ N(v_k, Sigma) with Sigma_jj = j^{-1.2}: the decaying
        # covariance applies to the noise only, not the mean v_k
        x = v_k + rng.normal(0.0, 1.0, size=(sizes[k], dim)) * np.sqrt(diag)
        logits = x @ W + b
        y = logits.argmax(-1).astype(np.int32)
        clients.append(_split({"x": x.astype(np.float32), "y": y},
                              seed=seed + k))
    return clients


_SQRT2 = xla_math.f32(2.0 ** 0.5)


@dataclasses.dataclass(frozen=True)
class SynthTask:
    """On-demand keyed Synthetic(alpha, beta): client ``k``'s data is a
    function of ``fold_in(PRNGKey(seed), k)`` alone (port of
    ``repro.data.synthetic.SynthTask``).

    Per client: model W_k, b_k ~ N(u_k, 1) with u_k ~ N(0, alpha),
    features x ~ N(v_k, Σ) with v_k ~ N(b_mean, 1), b_mean ~ N(0, beta),
    Σ_jj = j^{-1.2}, labels argmax(x W_k + b_k).  :meth:`client_block`
    over any ids is bitwise the same rows of the full materialization,
    and bitwise the jitted JAX ``client_block``.  A plain frozen config:
    engines close over it.
    """

    n_clients: int
    dim: int = 32
    n_classes: int = 10
    alpha: float = 1.0
    beta: float = 1.0
    samples_per_client: int = 64
    seed: int = 0

    def client_block(self, ids: torch.Tensor) -> dict:
        """ids (K,) → {"x": (K, S, dim) f32, "y": (K, S) int32} on the
        ids' device.  Row ``j`` depends only on ``ids[j]``.

        One batched draw per field for the whole cohort (each client's
        six keys broadcast against the counters, as ``vmap`` of the JAX
        draws), spelled as jitted XLA:CPU computes it: a normal is
        ``erf_inv(u) * sqrt(2)``, and XLA folds the scale of a draw into
        the constant it multiplies and contracts the add that follows
        into an FMA — ``u = e·(√2·alpha)``, ``v = fma(e, √2, b_mean)``,
        ``W = fma(e, √2, u)``, ``b = fma(e, √2, u)``, ``x = fma(e,
        diag_sqrt·√2, v)`` — and its dot accumulates the ``dim`` products
        in 4 interleaved FMA chains (lane ``j`` takes terms ``j, j+4,
        …``), summed as ``(c0 + c1) + (c2 + c3)``.  Every step is a
        correctly rounded float32 operation (the FMAs exact through
        float64), so the card gives the CPU's bits.
        """
        ids = torch.as_tensor(ids).to(torch.int64)
        dev = ids.device
        dim, c, s = self.dim, self.n_classes, self.samples_per_client
        base = jr.PRNGKey(self.seed, device=dev)
        keys = jr.split(jr.fold_in(base, ids), 6)        # (K, 6, 2)

        def erf(i, shape):
            u = jr.uniform(keys[:, i], shape, jr._NORMAL_LO, 1.0)
            return xla_math.erf_inv(u)

        u = erf(0, ()) * xla_math.f32(_SQRT2 * xla_math.f32(self.alpha))
        b_mean = erf(1, ()) * xla_math.f32(
            _SQRT2 * xla_math.f32(self.beta))
        v = xla_math.fma(erf(2, (dim,)), _SQRT2, b_mean[:, None])
        w = xla_math.fma(erf(3, (dim, c)), _SQRT2, u[:, None, None])
        b = xla_math.fma(erf(4, (c,)), _SQRT2, u[:, None])
        scale = self.diag_sqrt(dev) * _SQRT2
        x = xla_math.fma(erf(5, (s, dim)), scale, v[:, None, :])
        logits = _dot_4_chains(x, w) + b[:, None, :]
        return {"x": x, "y": torch.argmax(logits, -1).to(torch.int32)}

    def diag_sqrt(self, device) -> torch.Tensor:
        """sqrt((arange(dim) + 1) ** -1.2) with XLA's pow and sqrt."""
        j = torch.arange(self.dim, dtype=torch.float32, device=device) + 1.0
        return xla_math.sqrt(xla_math.pow(j, -1.2))

    def counts(self, n: int = None) -> torch.Tensor:
        """(n,) int32 per-client sample counts (uniform by construction),
        on the CPU."""
        return torch.full((self.n_clients if n is None else n,),
                          self.samples_per_client, dtype=torch.int32)

    @property
    def bytes_per_client(self) -> int:
        """Staged footprint per client this task avoids: S·(dim·4 + 4)."""
        return self.samples_per_client * (self.dim * 4 + 4)


def _dot_4_chains(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(K, S, D) @ (K, D, C) as XLA:CPU's batched dot sums it: four FMA
    chains over the products (chain j takes d = j, j + 4, …, from 0),
    then ``(c0 + c1) + (c2 + c3)``.  D is zero-padded to a multiple of 4
    (an FMA of a zero product leaves a chain as it is)."""
    k, s, d = x.shape
    pad = -d % 4
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    c = w.shape[-1]
    xr = x.reshape(k, s, -1, 4, 1).expand(k, s, x.shape[-1] // 4, 4, c)
    wr = w.reshape(k, 1, -1, 4, c).expand(k, s, x.shape[-1] // 4, 4, c)
    acc = torch.zeros((k, s, 4, c), dtype=torch.float32, device=x.device)
    for i in range(xr.shape[2]):
        acc = xla_math.fma(xr[:, :, i], wr[:, :, i], acc)
    return (acc[:, :, 0] + acc[:, :, 1]) + (acc[:, :, 2] + acc[:, :, 3])


def make_char_lm_federated(n_clients=100, vocab=90, seq_len=80,
                           sentences_per_client=64, seed=0) -> List[SyntheticDataset]:
    """Shakespeare stand-in: role-specific Markov char streams.

    Each client (speaking role) has its own sparse character-transition
    matrix interpolated with a shared global one — mimicking stylistic
    heterogeneity across roles while staying learnable.
    """
    rng = np.random.default_rng(seed)
    base = rng.dirichlet(np.full(vocab, 0.3), size=vocab)          # shared LM
    clients = []
    for k in range(n_clients):
        mix = rng.uniform(0.5, 0.95)
        role = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
        P = mix * base + (1 - mix) * role
        P /= P.sum(-1, keepdims=True)
        n_sent = int(rng.integers(8, sentences_per_client + 1))
        toks = np.empty((n_sent, seq_len), np.int32)
        for s in range(n_sent):
            t = rng.integers(vocab)
            for i in range(seq_len):
                toks[s, i] = t
                t = rng.choice(vocab, p=P[t])
        clients.append(_split({"tokens": toks}, seed=seed + k))
    return clients


def make_vision_federated(n_clients=50, n_classes=20, img=16, per_class=100,
                          lda_alpha=0.1, seed=0) -> List[SyntheticDataset]:
    """CIFAR100 stand-in: class-conditional Gaussian images + LDA partition."""
    rng = np.random.default_rng(seed)
    n = n_classes * per_class
    labels = np.repeat(np.arange(n_classes), per_class).astype(np.int32)
    protos = rng.normal(0, 1, size=(n_classes, img, img, 3)).astype(np.float32)
    x = protos[labels] + rng.normal(0, 1.2, size=(n, img, img, 3)).astype(np.float32)
    parts = dirichlet_partition(labels, n_clients, lda_alpha, seed=seed)
    return [_split({"x": x[ci], "y": labels[ci]}, seed=seed + i)
            for i, ci in enumerate(parts)]
