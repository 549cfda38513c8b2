"""Federated data partitioning (port of ``repro.data.partition``).

Pure numpy, copied op for op, so the same labels and seed give the same
index lists as the JAX package's.

``dirichlet_partition`` reproduces the LDA partition of Reddi et al. (used by
the paper for CIFAR100): each client draws a label distribution
theta_k ~ Dir(alpha * prior) and samples are assigned accordingly.
``size_skewed_partition`` produces unbalanced client dataset sizes (power-law)
— the source of heterogeneous p_k that the Uneven availability model keys on.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2):
    """Returns list of index arrays, one per client."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    for _ in range(20):
        props = rng.dirichlet(np.full(n_classes, alpha), size=n_clients)  # (K, C)
        # normalize per class, split class indices proportionally
        client_idx = [[] for _ in range(n_clients)]
        for c, idx in enumerate(idx_by_class):
            pc = props[:, c] / props[:, c].sum()
            cuts = (np.cumsum(pc)[:-1] * len(idx)).astype(int)
            for k, part in enumerate(np.split(idx, cuts)):
                client_idx[k].append(part)
        client_idx = [np.concatenate(parts) for parts in client_idx]
        if min(len(ci) for ci in client_idx) >= min_size:
            return [np.sort(ci) for ci in client_idx]
    # Deterministic repair: at extreme skew (tiny alpha, many clients) the
    # min-size constraint is almost never met by resampling — move samples
    # from the largest shards to the starved ones instead of looping forever.
    client_idx = [list(ci) for ci in client_idx]
    for k in range(n_clients):
        while len(client_idx[k]) < min_size:
            donor = max(range(n_clients), key=lambda j: len(client_idx[j]))
            if len(client_idx[donor]) <= min_size:
                break
            client_idx[k].append(client_idx[donor].pop())
    return [np.sort(np.asarray(ci, dtype=np.int64)) for ci in client_idx]


def size_skewed_partition(n_samples: int, n_clients: int, zipf_a: float = 1.2,
                          seed: int = 0, min_size: int = 2):
    """Power-law client sizes; returns list of index arrays."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(zipf_a, size=n_clients).astype(np.float64)
    sizes = np.maximum((raw / raw.sum() * n_samples).astype(int), min_size)
    # trim/grow to exactly n_samples
    while sizes.sum() > n_samples:
        sizes[np.argmax(sizes)] -= 1
    perm = rng.permutation(n_samples)
    out, start = [], 0
    for s in sizes:
        out.append(np.sort(perm[start:start + s]))
        start += s
    return out


def client_fractions(client_indices) -> np.ndarray:
    """p_k = n_k / n — the distribution P over users (paper §2.1)."""
    sizes = np.array([len(ci) for ci in client_indices], dtype=np.float64)
    return (sizes / sizes.sum()).astype(np.float32)
