"""Synthetic federated data (port of ``repro.data.synthetic``'s
``make_synthetic_federated``).

Pure numpy (``np.random.default_rng``), copied op for op, so the same seed
gives the same bytes as the JAX package's generator.  The Shakespeare and
CIFAR stand-ins and the on-demand ``SynthTask`` are ROADMAP.md queue 1
items 10 and 11.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


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
