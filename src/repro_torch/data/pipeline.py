"""Client datasets staged on the device + the cohort gather (port of
``repro.data.pipeline``'s device path).

Every client's train split is staged once into padded device tensors
(N, S, ...) with per-client sample counts; ``staged_cohort_batch`` then
assembles a (K, E, B, ...) cohort batch on the device from the same
``randint`` draw as the JAX package (per-row bounds ``counts[ids]``), so
the same key gives the same batch.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from .. import random as jr
from .synthetic import SyntheticDataset


@dataclasses.dataclass
class FederatedData:
    clients: List[SyntheticDataset]

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    @property
    def p(self) -> np.ndarray:
        sizes = np.array([len(next(iter(c.train.values())))
                          for c in self.clients], dtype=np.float64)
        return (sizes / sizes.sum()).astype(np.float32)

    def test_batch(self, max_per_client: int = 64) -> dict:
        """Pooled test set (per-sample metrics, paper §4.1)."""
        keys = self.clients[0].test.keys()
        return {k: np.concatenate([c.test[k][:max_per_client]
                                   for c in self.clients]) for k in keys}


class StagedData(NamedTuple):
    """All clients' train splits as padded device tensors: ``arrays``
    {feature: (N, S, ...)} zero-padded past each client's count, and
    ``counts`` (N,) int32.  Minibatch indices are always drawn < count."""

    arrays: dict
    counts: torch.Tensor


def staged_cohort_batch(staged: StagedData, key: torch.Tensor,
                        ids: torch.Tensor, local_steps: int,
                        local_batch: int) -> dict:
    """Device-side cohort gather: {feature: (K, E, B, ...)}; ``ids`` is the
    (K,) padded cohort."""
    k = ids.shape[0]
    counts = staged.counts[ids]
    idx = jr.randint(key, (k, local_steps, local_batch), 0,
                     counts[:, None, None]).long()
    return {name: arr[ids[:, None, None], idx]
            for name, arr in staged.arrays.items()}


@dataclasses.dataclass
class CohortSampler:
    """Stages client data for the cohort gather (the JAX package's host-side
    ``cohort_batch`` path is ROADMAP.md queue 1 item 6)."""
    data: FederatedData

    def stage_device(self, device) -> StagedData:
        """Stage every client's train split onto ``device`` (one transfer)."""
        clients = self.data.clients
        counts = np.asarray(
            [len(next(iter(c.train.values()))) for c in clients], np.int32)
        s_max = int(counts.max())
        arrays = {}
        for name, leaf in clients[0].train.items():
            stacked = np.zeros((len(clients), s_max) + leaf.shape[1:],
                               leaf.dtype)
            for i, c in enumerate(clients):
                stacked[i, :counts[i]] = c.train[name]
            arrays[name] = torch.from_numpy(stacked).to(device)
        return StagedData(arrays=arrays,
                          counts=torch.from_numpy(counts).to(device))
