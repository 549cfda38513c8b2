"""Client datasets and cohort batch assembly (port of
``repro.data.pipeline``).

Two batch paths produce stacked cohort batches with static shapes
(K, E, B, ...) — K = cohort size, E = local steps, B = local batch.
Unselected cohort slots repeat a valid client and get zero weight.

* **host path** (``CohortSampler.cohort_batch``, the host loop's): data
  stays numpy; each round gathers the selected clients' minibatches on the
  host.  With a PRNG ``key`` the indices come from the port's ``randint``,
  so the batch is bitwise the one ``staged_cohort_batch`` gathers from the
  same key; without one, from the legacy numpy stream (numpy is shared
  with the JAX package, so that batch is bitwise JAX's too).
* **device path** (``CohortSampler.stage_device`` + ``staged_cohort_batch``):
  every client's train split is staged once into padded device tensors
  (N, S, ...) with per-client sample counts; the gather then assembles a
  cohort batch on the device from the same ``randint`` draw as the JAX
  package (per-row bounds ``counts[ids]``).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

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
    """Assembles static-shape cohort batches.  ``cohort_size`` (K, the
    largest K_t), ``local_steps`` (E) and ``local_batch`` (B) size the host
    path's batches; staging needs none of them."""
    data: FederatedData
    cohort_size: Optional[int] = None
    local_steps: Optional[int] = None
    local_batch: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

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

    def cohort_batch(self, selected: Sequence[int],
                     key: Optional[torch.Tensor] = None):
        """``selected``: client ids (any length <= cohort_size).

        Returns (batch {feature: (K, E, B, ...)} numpy, valid (K,) bool,
        client ids (K,) int32): slots past ``len(selected)`` repeat the
        first selected client with valid=False.  With ``key`` (on any
        device) the minibatch indices are the port's ``randint`` draw of
        the device path; without it, the legacy numpy stream.
        """
        K, E, B = self.cohort_size, self.local_steps, self.local_batch
        if None in (K, E, B):
            raise ValueError("cohort_batch needs cohort_size, local_steps "
                             "and local_batch")
        sel = [int(c) for c in selected]
        assert sel, "cohort must be non-empty"
        ids = (sel + [sel[0]] * K)[:K]
        valid = np.zeros(K, bool)
        valid[:min(len(sel), K)] = True
        keys = self.data.clients[0].train.keys()
        counts = np.asarray(
            [len(next(iter(self.data.clients[c].train.values())))
             for c in ids])
        if key is None:
            idx = np.stack([self._rng.integers(0, n, size=(E, B))
                            for n in counts])
        else:
            bound = torch.from_numpy(counts.astype(np.int32)).to(key.device)
            idx = jr.randint(key, (K, E, B), 0,
                             bound[:, None, None]).cpu().numpy()
        out = {k: [] for k in keys}
        for i, cid in enumerate(ids):
            tr = self.data.clients[cid].train
            for k in keys:
                out[k].append(tr[k][idx[i]])
        return ({k: np.stack(v) for k, v in out.items()},
                valid, np.asarray(ids, np.int32))
