"""Synthetic federated data (port of ``repro.data.synthetic``'s numpy
makers).

* ``make_synthetic_federated`` — the paper's Synthetic(alpha, beta);
* ``make_char_lm_federated`` — the Shakespeare stand-in: per-client (per
  role) Markov character streams;
* ``make_vision_federated`` — the CIFAR100 stand-in: class-conditional
  Gaussian images, LDA-partitioned (``partition.dirichlet_partition``).

Pure numpy (``np.random.default_rng``), copied op for op, so the same seed
and kwargs give the same bytes as the JAX package's makers.  The on-demand
``SynthTask`` is ROADMAP.md queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

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
