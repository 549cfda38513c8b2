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
* **on-demand path** (``synth_cohort_batch``): with a ``SynthTask`` no
  client data is staged at all; each round synthesizes the selected
  cohort's (K, S, ...) block and gathers from it with the same draw.

Under a mesh (the sharded engine) each rank stages only its own block of
the client dimension, padded to a multiple of (the clients axis' size ×
32); the ranks of a model axis stage the same block.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import random as jr
from .synthetic import SynthTask, SyntheticDataset


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


def synth_cohort_batch(task: SynthTask, key: torch.Tensor, ids: torch.Tensor,
                       local_steps: int, local_batch: int) -> dict:
    """On-demand cohort batch: synthesize only the selected (K, S, ...)
    block.  The same ``randint`` draw as :func:`staged_cohort_batch` (the
    per-row bound is the task's uniform sample count, what
    ``staged.counts[ids]`` holds on the staged path) and the same gather,
    so the batch is bitwise the staged one for the same (key, ids)."""
    k = ids.shape[0]
    counts = torch.full((k,), task.samples_per_client, dtype=torch.int32,
                        device=key.device)
    idx = jr.randint(key, (k, local_steps, local_batch), 0,
                     counts[:, None, None]).long()
    block = task.client_block(ids)
    rows = torch.arange(k, device=key.device)[:, None, None]
    return {name: arr[rows, idx] for name, arr in block.items()}


# Client-dim padding quantum per mesh shard: keeps every shard's block a
# multiple of 32, so the sharded engine streams packed masks with no pad
# bits mid-mask (core.bitmask).  Padded clients stay inert.
SHARD_PAD_QUANTUM = 32


def stage_client_arrays(arrays: dict, counts: np.ndarray, device, *,
                        mesh=None, axis: str = "clients") -> StagedData:
    """Place pre-stacked per-client arrays ({feature: (N, S, ...)}, counts
    (N,)) on ``device`` as a :class:`StagedData`.

    ``mesh=None``: every client.  With a mesh (``launch.mesh``) the
    client dimension is padded to a multiple of (the size of its ``axis``
    × 32) and this rank stages only its own block ``[i · nl, (i + 1) ·
    nl)`` of the arrays, i its index on that axis (replicated over a
    model axis, as JAX's ``P(axis)`` specs place it); ``counts`` stay whole
    (n_pad,), read for any cohort id on every rank, and a padded client
    gets sample count 1 so a bounded ``randint`` stays defined (it is
    never selected).  Zero rows pad the arrays."""
    counts = np.asarray(counts, np.int32)
    if mesh is None:
        return StagedData(
            arrays={k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in arrays.items()},
            counts=torch.from_numpy(counts).to(device))
    cm = mesh.axis_mesh(axis)
    n = counts.shape[0]
    quantum = cm.size * SHARD_PAD_QUANTUM
    n_pad = -(-n // quantum) * quantum
    nl = n_pad // cm.size
    lo = cm.rank * nl
    m = max(0, min(lo + nl, n) - lo)
    placed = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        blk = np.zeros((nl,) + arr.shape[1:], arr.dtype)
        blk[:m] = arr[lo:lo + m]
        placed[name] = torch.from_numpy(blk).to(device)
    counts_pad = np.concatenate([counts, np.ones(n_pad - n, np.int32)])
    return StagedData(arrays=placed,
                      counts=torch.from_numpy(counts_pad).to(device))


def stage_synth_task(task: SynthTask, device, *, mesh=None,
                     axis: str = "clients", block: int = 8192) -> StagedData:
    """Materialize a :class:`SynthTask` into :class:`StagedData`, generated
    in blocks of ``block`` clients through the same keyed generator the
    on-demand path uses (on ``device``), so ``staged_cohort_batch`` on the
    result is bitwise ``synth_cohort_batch`` on the task."""
    n = task.n_clients
    arrays = None
    for lo in range(0, n, block):
        ids = torch.arange(lo, min(lo + block, n), device=device)
        blk = {k: v.cpu().numpy() for k, v in task.client_block(ids).items()}
        if arrays is None:
            arrays = {name: np.empty((n,) + v.shape[1:], v.dtype)
                      for name, v in blk.items()}
        for name, v in blk.items():
            arrays[name][lo:lo + ids.shape[0]] = v
    return stage_client_arrays(arrays, task.counts().numpy(), device,
                               mesh=mesh, axis=axis)


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

    def stage_device(self, device, mesh=None,
                     axis: str = "clients") -> StagedData:
        """Stage every client's train split onto ``device`` (one transfer);
        with a ``mesh``, this rank's padded block of it over ``axis``
        (:func:`stage_client_arrays`)."""
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
            arrays[name] = stacked
        return stage_client_arrays(arrays, counts, device, mesh=mesh,
                                   axis=axis)

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
