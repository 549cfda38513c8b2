"""Client-sharded round engine: the client dimension N split over the
clients axis of a mesh, and optionally the stored model over its model
axis (port of ``repro.sim.engine_sharded``).

The device engine (:mod:`repro_torch.sim.engine`) keeps every (N,)-shaped
object — availability state, scores, the staged (N, S, ...) client data —
on one device.  This engine splits the client dimension over the shards
of a ``launch.mesh.ClientMesh``, padded to a multiple of (shards × 32).

**How it maps.**  JAX runs one process over a ``shard_map``; the port
runs one process a shard, each running the same round body below:

* ``jax.lax.axis_index(axis)`` is the process's rank in the mesh;
* ``psum`` is ``all_reduce`` (:meth:`ClientMesh.all_reduce`);
* ``all_gather(tiled=True)`` is ``all_gather`` and a concatenation in rank
  order (:meth:`ClientMesh.all_gather`);
* ``ppermute`` is a paired ``send``/``recv`` through
  ``batch_isend_irecv`` (:meth:`ClientMesh.exchange`).

``run_spec`` launches the shards itself (``torch.multiprocessing``, start
method ``spawn``) when no process group is initialized, or runs as one
shard of the initialized group (``torchrun``).

Per round, step by step as the JAX ``round_step``:

* **keys** — the same five-way split and completion fold as every engine;
* **availability** — a model with ``step_block`` and no client-dimension
  state steps its own block (O(n_local), the non-empty guarantee a tiny
  gather); otherwise the client-dimension state is gathered, the model
  steps at full width and each shard keeps its block;
* **selection** — ``core.strategies.as_sharded``: the block's scores
  (``score_block``, or the full-width ``score`` sliced), the distributed
  cut ``core.selection.sharded_topk_mask`` (per-shard top-k_max
  candidates reduced by ``ppermute`` steps or an ``all_gather``, per
  ``topk_impl``), the selection mask gathered packed, and ``finalize`` at
  full (N,) shape on every shard, so r_k is replicated and identical;
* **cohort** — ids from ``sharded_cohort_ids_from_mask``; each slot's
  weight summed from its owner shard; the cohort's data synthesized
  (``SynthTask``: every shard makes the single-device engine's call, so
  the block is replicated with no sum) or gathered from the staged blocks
  by their owners and summed;
* **round** — each shard trains its ``kb = ceil(K / d)`` cohort slots
  (``make_fed_round(cohort_axis=mesh)``: one ``fed_aggregate`` over them,
  then one ``all_reduce`` of Δ);
* **stream** — each shard packs its blocks of the selection and completed
  masks; at the end of a chunk the shards' words are gathered, so every
  shard (rank 0 the one that reports) returns the whole stream.

Masks, K_t, |avail| and r_k are bitwise the single-device engine's for
the same seed; losses and parameters agree within float tolerance (the
Δ sum runs in another order).

**The model axis** (``model_axis=``, a ``(c, m)`` mesh): the carry holds
this rank's blocks of the parameters and of the server optimizer's state,
leaf by leaf as ``sharding.rules.model_specs`` and ``state_specs_like``
lay them out (``sharding.rules.local_blocks``), by the one spec tree
``fed_round`` was built with (``make_fed_round(model_axis=,
param_specs=)``, which the round carries as ``param_specs``).  Every client-side
step above uses the clients axis alone (its index and size, its
collectives), so every rank of a model axis computes the same masks, K_t
and r_k.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import random as jr
from ..core.bitmask import pack_bits
from ..core.keys import COMPLETION as KEY_FOLD
from ..core.selection import sharded_cohort_ids_from_mask
from ..core.strategies import SelectCtx, as_sharded
from ..data.pipeline import SHARD_PAD_QUANTUM, synth_cohort_batch
from ..data.synthetic import SynthTask
from ..device import resolve_device
from ..launch.mesh import ClientMesh, FedMesh, make_fed_mesh
from ..sharding.rules import (any_client_leaf, client_dim_flags,
                              gather_full, local_blocks, map_client_leaves,
                              pad_client_dim, state_specs_like)
from .engine import EngineCarry, _stack, _staged_nbytes

__all__ = ["ShardedEngine", "resolve_client_mesh"]


def _selection_comm_bytes(*, d: int, nl: int, k: int, topk_impl: str,
                          gathers: int = 1) -> int:
    """Per-round selection traffic, bytes received per shard (the JAX
    package's formula): the top-k candidate reduction ((f32 score, i32
    gid) pairs — one int64 key each here), the cohort-id reduction (i32
    ids, same schedule) and ``gathers`` full-width packed mask gathers (1
    on the fast path, 2 when a blockwise availability step leaves a
    full-width score without its mask).  Cohort-batch and Δ sums are model
    traffic and not counted."""
    if d == 1:
        return 0
    kk = min(k, nl)

    def stream_items(cap: int) -> int:
        if d & (d - 1) == 0:            # butterfly: send current list/stage
            total, length = 0, kk
            for _ in range(d.bit_length() - 1):
                total += length
                length = min(cap, 2 * length)
            return total
        return (d - 1) * kk             # ring: fixed kk-buffer, d-1 hops
    items = stream_items(k) if topk_impl == "stream" else (d - 1) * kk
    mask_bytes = gathers * (d - 1) * (nl // 8 if nl % 32 == 0 else nl)
    return items * 8 + items * 4 + mask_bytes


def resolve_client_mesh(mesh, axis: str = "clients",
                        model_axis: str = "model"):
    """Accept a :class:`ClientMesh` or :class:`FedMesh` (it must have the
    ``axis``), a shard count (<= 0: the group's size), a 1- or 2-D
    ``mesh_shape`` (``(c,)``, ``(c, m)``; 0 fills with the group's ranks)
    or None."""
    if mesh is None or isinstance(mesh, (ClientMesh, FedMesh)):
        if mesh is not None and axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no {axis!r} axis")
        return mesh
    if isinstance(mesh, int):
        mesh = (max(mesh, 0),)      # legacy shard count: <= 0 → all ranks
    return make_fed_mesh(tuple(mesh), axis_names=(axis, model_axis))


class ShardedEngine:
    """One shard of the client-sharded engine: the driver surface of
    :class:`repro_torch.sim.engine.DeviceEngine` (``init_carry``,
    ``set_r0``, ``chunk``, ``k_max``, ``n_clients``, ``n_staged_bytes``,
    ``selection_comm_bytes_per_round``).  ``staged`` is this shard's
    ``StagedData`` (``CohortSampler.stage_device(mesh=...)`` or
    ``data.stage_client_arrays(mesh=...)``) or a ``SynthTask``.
    ``topk_impl`` picks the distributed cut's reduction
    (``core.selection.TOPK_IMPLS``); ``device`` (None: CUDA) is where
    this shard's tensors go.  ``axis`` names the mesh's client axis;
    ``model_axis`` its model axis (a ``make_fed_mesh((c, m))`` mesh),
    over which the stored parameters and optimizer state are split by the
    spec tree ``fed_round`` was built with (its ``param_specs``)."""

    def __init__(self, *, mesh, axis: str = "clients",
                 avail_model, budget, strategy, staged, fed_round,
                 init_params, opt, client_lr, local_steps, local_batch,
                 n_clients: int, completion=None, topk_impl: str = "stream",
                 model_axis: Optional[str] = None, device=None):
        self.mesh, self.axis = mesh, axis
        self.model_axis = model_axis
        if model_axis is not None:
            if model_axis == axis:
                raise ValueError(f"model_axis {model_axis!r} collides with "
                                 f"the client axis")
            if model_axis not in mesh.axis_names:
                raise ValueError(f"mesh {mesh.axis_names} has no "
                                 f"{model_axis!r} axis; build it with "
                                 f"launch.mesh.make_fed_mesh((c, m))")
        others = [a for a, size in mesh.shape.items()
                  if a not in (axis, model_axis) and size > 1]
        if others:
            raise ValueError(f"mesh axes {others} of {mesh.axis_names} are "
                             f"neither the client axis nor model_axis; a "
                             f"2-D mesh needs model_axis=")
        # the clients axis: this rank's shard of the client dimension
        self._cm = cm = mesh.axis_mesh(axis)
        self.avail_model = avail_model
        self.budget = budget
        self.strategy = strategy
        self.completion = completion
        self.device = device = resolve_device(device)
        self.topk_impl = topk_impl
        self.n_clients = n = int(n_clients)
        self.k_max = k = budget.k_max
        self._synth = isinstance(staged, SynthTask)
        d = cm.size
        if self._synth:
            if staged.n_clients != n:
                raise ValueError(f"SynthTask of {staged.n_clients} clients "
                                 f"for an engine of {n}")
            quantum = d * SHARD_PAD_QUANTUM
            n_pad = -(-n // quantum) * quantum
        else:
            n_pad = int(staged.counts.shape[0])
        if n_pad % d or n_pad < n or (n_pad // d) % SHARD_PAD_QUANTUM:
            raise ValueError(
                f"client dim {n_pad} (N = {n}) does not split into {d} "
                f"blocks of a multiple of {SHARD_PAD_QUANTUM}: stage through "
                f"data.pipeline.stage_client_arrays(mesh=...)")
        self._n_pad, self._nl = n_pad, n_pad // d
        self._off = cm.rank * self._nl
        self._k_pad = -(-k // d) * d
        self._kb = self._k_pad // d
        self._staged = staged
        # the whole staged dataset, every shard's block (as JAX counts its
        # sharded arrays); the sample counts are whole on each shard
        self.n_staged_bytes = 0 if self._synth else (
            d * (_staged_nbytes(staged) - staged.counts.numel()
                 * staged.counts.element_size())
            + staged.counts.numel() * staged.counts.element_size())
        self._fed_round = fed_round
        self._init_params = init_params
        self._opt = opt
        self._client_lr = float(client_lr)
        self._local_steps, self._local_batch = local_steps, local_batch
        self._trivial = completion is None or completion.trivial
        self._flags = client_dim_flags(avail_model.init(), n)
        # blockwise availability: a model with step_block and no (N,)
        # state steps only its block
        self._block_avail = (hasattr(avail_model, "step_block")
                             and not any_client_leaf(self._flags))
        gathers = 1 + (1 if self._block_avail
                       and strategy.score_block is None else 0)
        self.selection_comm_bytes_per_round = _selection_comm_bytes(
            d=d, nl=self._nl, k=k, topk_impl=topk_impl, gathers=gathers)
        self._select_blk = as_sharded(strategy, axis=cm, k_max=k,
                                      n_pad=n_pad, topk_impl=topk_impl)
        self._slot_mask = (torch.arange(self._k_pad, device=device)
                           < k).to(torch.float32)
        self._r0 = None
        self._caps = {}
        # the stored model: whole, or this rank's blocks over model_axis,
        # laid out by the spec tree fed_round gathers and slices by
        self._mm = None
        self.param_specs = getattr(fed_round, "param_specs", None)
        if model_axis is not None:
            if self.param_specs is None:
                raise ValueError("model_axis needs a fed_round built with "
                                 "make_fed_round(model_axis=, param_specs=)"
                                 ": the carry is stored by its spec tree")
            self._mm = mesh.axis_mesh(model_axis)

    def full_params(self, params):
        """The whole parameters from this rank's blocks (an all-gather
        over the model axis, exact; every rank of it must call this)."""
        if self._mm is None:
            return params
        return gather_full(params, self.param_specs, self._mm)

    def _block(self, leaf: torch.Tensor) -> torch.Tensor:
        """This shard's block of a full-width (N, ...) tensor, padded."""
        return pad_client_dim(leaf, self._n_pad)[
            self._off:self._off + self._nl]

    def set_r0(self, r0: float) -> None:
        """Pin the rate-EMA initialization."""
        self._r0 = r0

    def init_carry(self, key: torch.Tensor) -> EngineCarry:
        params = self._init_params(key)
        opt_state = self._opt.init(params)
        if self._mm is not None:
            # every rank draws the same full parameters and keeps its
            # blocks, each in a storage of its own
            opt_specs = state_specs_like(opt_state, params, self.param_specs)
            params = local_blocks(params, self.param_specs, self._mm,
                                  copy=True)
            opt_state = local_blocks(opt_state, opt_specs, self._mm,
                                     copy=True)
        return EngineCarry(
            key=key, params=params, opt_state=opt_state,
            algo_state=self.strategy.init(self.n_clients, r0=self._r0),
            avail_state=map_client_leaves(self._block,
                                          self.avail_model.init(),
                                          self._flags))

    def _cap(self, k_cap: int) -> torch.Tensor:
        if k_cap not in self._caps:
            self._caps[k_cap] = torch.tensor(int(k_cap), dtype=torch.int32,
                                             device=self.device)
        return self._caps[k_cap]

    def round_step(self, carry: EngineCarry, t: int,
                   k_cap: Optional[int] = None):
        """One round of this shard; returns (carry', per-round outputs)
        with this shard's packed mask blocks."""
        mesh, n, nl, off = self._cm, self.n_clients, self._nl, self._off
        k, k_pad, kb = self.k_max, self._k_pad, self._kb
        key, k_av, k_sel, k_bud, k_batch = jr.split(carry.key, 5)
        if self._block_avail:
            avail_state, avail_blk = self.avail_model.step_block(
                k_av, carry.avail_state, t, off=off, n_local=nl, axis=mesh)
            avail_full = None
            n_avail = mesh.all_reduce(
                avail_blk.sum().to(torch.int32).reshape(1))[0]
        else:
            full_state = map_client_leaves(
                lambda leaf: mesh.all_gather(leaf)[:n], carry.avail_state,
                self._flags)
            new_full, avail_full = self.avail_model.step(k_av, full_state, t)
            avail_state = map_client_leaves(self._block, new_full,
                                            self._flags)
            avail_blk = self._block(avail_full)
            n_avail = avail_full.sum().to(torch.int32)
        k_t = self.budget.sample(k_bud, t)
        if k_cap is not None:
            k_t = torch.minimum(k_t, self._cap(k_cap))
        if self._trivial:
            complete_fn = None
        else:
            k_comp = jr.fold_in(k_sel, KEY_FOLD)

            def complete_fn(m):
                return self.completion.sample(k_comp, t, m)
        mask_blk, w_blk, algo_state, completed_full = self._select_blk(
            carry.algo_state, k_sel, avail_blk, k_t,
            SelectCtx(t=t, complete=complete_fn), avail_full=avail_full)
        completed_blk = (mask_blk if self._trivial
                         else self._block(completed_full))

        ids, valid = sharded_cohort_ids_from_mask(mask_blk, k, mesh, n,
                                                  method=self.topk_impl)
        if k_pad > k:           # shard-count padding: zero-weight repeats
            ids_p = torch.cat([ids, ids[:1].expand(k_pad - k)])
            valid_p = torch.cat([valid, torch.zeros(
                k_pad - k, dtype=torch.bool, device=valid.device)])
        else:
            ids_p, valid_p = ids, valid
        # each slot's weight lives on its owner shard
        in_range = (ids_p >= off) & (ids_p < off + nl)
        loc = torch.where(in_range, ids_p - off, 0)
        w_sel = mesh.all_reduce(torch.where(in_range, w_blk[loc], 0.0)) \
            * valid_p
        if not self._trivial:
            # dropped slots contribute nothing even if finalize ignored
            # the completion hook
            w_sel = w_sel * completed_full[ids_p]

        e, b = self._local_steps, self._local_batch
        if self._synth:
            # every shard makes the single-device engine's call: the block
            # is bitwise that engine's and replicated, with no sum
            batch = synth_cohort_batch(self._staged, k_batch, ids, e, b)
            if k_pad > k:
                batch = {name: torch.cat([v, v.new_zeros(
                    (k_pad - k,) + tuple(v.shape[1:]))])
                    for name, v in batch.items()}
        else:
            # the single-device engine's (K, E, B) draw; padded slots read
            # row 0 at zero weight; owners contribute, the sum assembles
            counts = self._staged.counts[ids]
            idx = jr.randint(k_batch, (k, e, b), 0,
                             counts[:, None, None]).long()
            if k_pad > k:
                idx = torch.cat([idx, idx.new_zeros((k_pad - k, e, b))])
            batch = {}
            for name, arr in self._staged.arrays.items():
                rows = arr[loc[:, None, None], idx]
                keep = in_range.reshape((k_pad,) + (1,) * (rows.dim() - 1))
                batch[name] = mesh.all_reduce(
                    torch.where(keep, rows, torch.zeros_like(rows)))

        i = mesh.rank
        lb = {name: v[i * kb:(i + 1) * kb] for name, v in batch.items()}
        params, opt_state, m = self._fed_round(
            carry.params, carry.opt_state, lb, w_sel[i * kb:(i + 1) * kb],
            self._client_lr, self._slot_mask[i * kb:(i + 1) * kb])
        out = (pack_bits(mask_blk), pack_bits(completed_blk), k_t, n_avail,
               m.loss, m.delta_norm)
        return EngineCarry(key, params, opt_state, algo_state,
                           avail_state), out

    def chunk(self, carry: EngineCarry, ts, k_cap: Optional[int] = None):
        """Advance one chunk of rounds; returns (carry', RoundStream) with
        the whole stream (every shard's words) on every shard."""
        outs = []
        for t in ts:
            carry, out = self.round_step(carry, int(t), k_cap)
            outs.append(out)
        s = _stack(outs)

        def whole(words):                # (C, nl/32) blocks, rank order
            return self._cm.all_gather(words.T.contiguous()).T
        return carry, s._replace(sel_mask=whole(s.sel_mask),
                                 completed=whole(s.completed))
