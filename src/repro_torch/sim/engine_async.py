"""Buffered asynchronous aggregation (FedBuff-style server loop; port of
``repro.sim.engine_async``).

The round-synchronous engines end a round when the cohort's survivors
report, so one straggler stretches the whole round.  A buffered server
instead dispatches work whenever it selects clients, takes each update
when its latency has elapsed, and applies one update as soon as a buffer
of M arrivals has filled, discounting stale contributions.  The arrival
times are the completion process's own latencies (``latencies`` of
``always`` or ``deadline``, drawn from ``fold_in(k_sel, KEY_FOLD)``).

Two executors, as in the JAX package, bitwise each other:

* ``engine="device"`` — :class:`AsyncEngine`: a fixed-capacity arrival
  pool of tensors kept sorted by three stable sorts, stepped as an eager
  loop of rounds on the device (the JAX package's ``lax.scan``);
* ``engine="host"`` — an event-driven loop over a sorted Python list of
  pending arrivals, the cohort batch gathered in numpy.

Semantics (DESIGN.md §7.4):

* Server step t splits the round key as the sync engines do; selected
  clients are *dispatched*: an arrival (time = t + latency, client,
  dispatch step) enters the pool.  The strategy's rate EMA tracks
  dispatches (no completion hook: a buffered server has no within-step
  completion).
* The pool is ordered by (arrival time, client id, dispatch step), a total
  order, so the executors agree on ties.  At capacity the *latest*
  arrivals are dropped (``n_overflow``).
* The step aggregates the first ``buffer_size`` pending arrivals with
  weights ``discount(staleness)`` normalised over the buffer,
  ``staleness = t − dispatch step``; the discount comes from
  ``STALENESS_DISCOUNTS`` (default polynomial ``1/(1+s)^power``).  The
  weights depend only on integer staleness, and both executors call the
  one function, so they agree bit for bit.  Updates are computed from the
  current params at flush time; missing slots are zero-weighted.

JAX's device executor runs each chunk inside ``core.sanitize``'s transfer
guard; that tooling is not ported (ROADMAP.md queue 1 item 13).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import random as jr
from .. import xla_math
from ..checkpoint import save_checkpoint
from ..core.fedstep import make_fed_round
from ..core.keys import COMPLETION as KEY_FOLD
from ..core.selection import cohort_ids_from_mask
from ..core.strategies import (SelectCtx, get_strategy_entry, make_strategy,
                               resolve_strategy)
from ..data import CohortSampler
from ..data.pipeline import staged_cohort_batch
from ..device import resolve_device
from ..optim import make_optimizer
from .scenario import get_scenario

__all__ = ["STALENESS_DISCOUNTS", "ArrivalPool", "AsyncCarry", "AsyncEngine",
           "AsyncStream", "register_staleness_discount",
           "run_scenario_buffered", "staleness_weights"]


# ---------------------------------------------------------------------------
# Staleness discounts
# ---------------------------------------------------------------------------

STALENESS_DISCOUNTS: Dict[str, Callable] = {}


def register_staleness_discount(name: str, fn: Callable) -> Callable:
    """Register ``fn(staleness_f32, power) -> discount`` under ``name``:
    a function of a float32 staleness tensor.  Both executors call the
    same registered function, so their weights agree bit for bit."""
    STALENESS_DISCOUNTS[str(name).lower()] = fn
    return fn


# The JAX package's discounts as its jitted device executor computes them,
# ``power`` a constant there: XLA rewrites ``x ** -1.0`` into ``1 / x``
# (``xla_math.pow``), where its eager host executor calls ``powf`` and parts
# from it in a few lanes.  One spelling here, so the two executors agree at
# every power.
register_staleness_discount(
    "polynomial", lambda s, p: xla_math.pow(1.0 + s, -p))
register_staleness_discount(
    "exponential", lambda s, p: xla_math.exp(s * xla_math.f32(-p)))


def staleness_weights(staleness, valid, power: float,
                      discount: str = "polynomial") -> torch.Tensor:
    """Normalised buffer weights: ``discount(staleness)`` on valid slots,
    divided by their sum (all-zero when the buffer is empty).

    A pure function of the integer staleness and the valid mask (tensors
    on any device, or numpy), so the executors agree bit for bit.  The sum
    runs left to right over the M slots, as XLA:CPU's jitted sum does at
    these sizes, on either device.
    """
    if discount not in STALENESS_DISCOUNTS:
        raise KeyError(f"unknown staleness discount {discount!r}; "
                       f"known: {sorted(STALENESS_DISCOUNTS)}")
    s = torch.as_tensor(staleness).to(torch.float32)
    valid = torch.as_tensor(valid, device=s.device).to(torch.bool)
    raw = torch.where(valid, STALENESS_DISCOUNTS[discount](s, power),
                      torch.zeros_like(s))
    total = raw[0]
    for i in range(1, raw.shape[0]):
        total = total + raw[i]
    pos = total > 0
    return torch.where(pos, raw / torch.where(pos, total,
                                              torch.ones_like(total)),
                       torch.zeros_like(raw))


def default_pool_slots(buffer_size: int, k_max: int) -> int:
    """Pending-pool capacity: room for the buffer plus ~4 dispatch waves of
    in-flight updates."""
    return int(buffer_size + 4 * k_max)


# ---------------------------------------------------------------------------
# The pending-arrival pool (device representation)
# ---------------------------------------------------------------------------

class ArrivalPool(NamedTuple):
    """Fixed-capacity pending-update pool, kept sorted by (time, cid,
    round).  Empty slots are (time=+inf, cid=N, round=0, valid=False), so
    they sort after every real arrival."""
    time: torch.Tensor     # (P,) f32 arrival time in server-step units
    cid: torch.Tensor      # (P,) i32 client id (N = empty sentinel)
    round: torch.Tensor    # (P,) i32 dispatch server step
    valid: torch.Tensor    # (P,) bool


def empty_pool(pool_slots: int, n_clients: int, device=None) -> ArrivalPool:
    return ArrivalPool(
        time=torch.full((pool_slots,), float("inf"), dtype=torch.float32,
                        device=device),
        cid=torch.full((pool_slots,), n_clients, dtype=torch.int32,
                       device=device),
        round=torch.zeros((pool_slots,), dtype=torch.int32, device=device),
        valid=torch.zeros((pool_slots,), dtype=torch.bool, device=device))


def _lex_order(time, cid, rnd) -> torch.Tensor:
    """Stable argsort by ``time``, then ``cid``, then ``rnd``: three stable
    sorts, least significant key first (``sorted(key=(time, cid, rnd))``
    of the host executor)."""
    o = torch.sort(rnd, stable=True).indices
    o = o[torch.sort(cid[o], stable=True).indices]
    return o[torch.sort(time[o], stable=True).indices]


def pool_insert(pool: ArrivalPool, new: ArrivalPool):
    """Merge ``new`` arrivals into the pool, re-sort, truncate to capacity.
    Returns ``(pool', n_overflow)``: the valid arrivals dropped at
    capacity, by construction the latest in the order."""
    p_slots = pool.time.shape[0]
    cat = ArrivalPool(*(torch.cat([a, b]) for a, b in zip(pool, new)))
    order = _lex_order(cat.time, cat.cid, cat.round)
    cat = ArrivalPool(*(a[order] for a in cat))
    n_overflow = torch.clamp_min(cat.valid.sum().to(torch.int32) - p_slots,
                                 0)
    return ArrivalPool(*(a[:p_slots] for a in cat)), n_overflow


def pool_flush(pool: ArrivalPool, buffer_size: int, t, n_clients: int):
    """Pop the first ``buffer_size`` pending arrivals (the buffer).

    Returns ``(pool', buf_ids, buf_valid, buf_staleness)``; ``buf_ids``
    follows the cohort convention: invalid slots repeat the first buffered
    client, and an empty buffer clamps to client N-1, all invalid.
    """
    m = buffer_size
    buf = ArrivalPool(*(a[:m] for a in pool))
    first = torch.where(buf.valid[0], buf.cid[0],
                        torch.full_like(buf.cid[0], n_clients - 1))
    buf_ids = torch.where(buf.valid, buf.cid, first).to(torch.int32)
    staleness = torch.where(buf.valid, int(t) - buf.round,
                            torch.zeros_like(buf.round)).to(torch.int32)
    empties = empty_pool(m, n_clients, device=pool.time.device)
    rest = ArrivalPool(*(torch.cat([a[m:], e])
                         for a, e in zip(pool, empties)))
    return rest, buf_ids, buf.valid, staleness


# ---------------------------------------------------------------------------
# The device executor
# ---------------------------------------------------------------------------

class AsyncCarry(NamedTuple):
    """Sync-engine state plus the pending-arrival pool."""
    key: torch.Tensor
    params: dict
    opt_state: object
    algo_state: object
    avail_state: object
    pool: ArrivalPool


class AsyncStream(NamedTuple):
    """Per-server-step outputs, stacked along the chunk axis."""
    sel_mask: torch.Tensor       # (C, N) bool — dispatched this step
    buf_ids: torch.Tensor        # (C, M) i32 — aggregated clients (padded)
    buf_valid: torch.Tensor      # (C, M) bool
    buf_staleness: torch.Tensor  # (C, M) i32 — t - dispatch step
    buf_weights: torch.Tensor    # (C, M) f32 — normalised weights
    k_t: torch.Tensor            # (C,) i32
    n_available: torch.Tensor    # (C,) i32
    n_buffered: torch.Tensor     # (C,) i32
    mean_staleness: torch.Tensor  # (C,) f32 (0 when the buffer is empty)
    n_overflow: torch.Tensor     # (C,) i32 — arrivals dropped at capacity
    train_loss: torch.Tensor     # (C,) f32
    delta_norm: torch.Tensor     # (C,) f32


class AsyncEngine:
    """One buffered-aggregation cell (scenario × strategy × task) on one
    device.  ``chunk(carry, ts)`` advances ``len(ts)`` server steps, with
    no host sync; ``init_carry(key)`` builds the step-0 state (empty
    pool).  ``device`` (None: CUDA) is where the engine's own tensors go."""

    def __init__(self, *, avail_model, budget, strategy, staged, fed_round,
                 init_params, opt, client_lr, local_steps, local_batch,
                 arrival, buffer_size, staleness_power=0.5,
                 staleness_discount="polynomial", pool_slots=None,
                 device=None):
        self.avail_model = avail_model
        self.budget = budget
        self.strategy = strategy
        self.arrival = arrival
        self.device = resolve_device(device)
        self.k_max = budget.k_max
        self.n_clients = int(staged.counts.shape[0])
        self.buffer_size = int(buffer_size)
        self.pool_slots = int(pool_slots or
                              default_pool_slots(buffer_size, budget.k_max))
        self.staleness_power = float(staleness_power)
        self.staleness_discount = str(staleness_discount)
        self._staged = staged
        self._fed_round = fed_round
        self._init_params = init_params
        self._opt = opt
        self._client_lr = float(client_lr)
        self._local_steps = local_steps
        self._local_batch = local_batch

    def init_carry(self, key: torch.Tensor) -> AsyncCarry:
        params = self._init_params(key)
        return AsyncCarry(key=key, params=params,
                          opt_state=self._opt.init(params),
                          algo_state=self.strategy.init(self.n_clients),
                          avail_state=self.avail_model.init(),
                          pool=empty_pool(self.pool_slots, self.n_clients,
                                          self.device))

    def round_step(self, carry: AsyncCarry, t: int):
        """One server step; returns (carry', per-step outputs)."""
        n = self.n_clients
        # Same split order as every other engine.  The latency key is
        # derived (fold_in off k_sel, the completion stream), so buffered
        # latencies are the deadline process's own draws.
        key, k_av, k_sel, k_bud, k_batch = jr.split(carry.key, 5)
        k_arr = jr.fold_in(k_sel, KEY_FOLD)
        avail_state, avail = self.avail_model.step(k_av, carry.avail_state,
                                                   t)
        k_t = self.budget.sample(k_bud, t)
        sel_mask, _, algo_state = self.strategy.select(
            carry.algo_state, k_sel, avail, k_t, SelectCtx(t=t))
        # dispatch the selected cohort into the pending pool
        ids, valid = cohort_ids_from_mask(sel_mask, self.k_max)
        lat = self.arrival.latencies(k_arr, t)
        t_f = torch.tensor(float(t), dtype=torch.float32,
                           device=self.device)
        new = ArrivalPool(
            time=torch.where(valid, t_f + lat[ids],
                             torch.full_like(t_f, float("inf"))),
            cid=torch.where(valid, ids, n).to(torch.int32),
            round=torch.where(valid, t, 0).to(torch.int32),
            valid=valid)
        pool, n_overflow = pool_insert(carry.pool, new)
        # flush: aggregate the first M pending arrivals
        pool, buf_ids, buf_valid, buf_stale = pool_flush(
            pool, self.buffer_size, t, n)
        weights = staleness_weights(buf_stale, buf_valid,
                                    self.staleness_power,
                                    self.staleness_discount)
        batch = staged_cohort_batch(self._staged, k_batch, buf_ids.long(),
                                    self._local_steps, self._local_batch)
        params, opt_state, m = self._fed_round(
            carry.params, carry.opt_state, batch, weights, self._client_lr)
        n_buf = buf_valid.sum().to(torch.int32)
        stale_sum = (buf_stale * buf_valid).sum().to(torch.float32)
        mean_stale = torch.where(
            n_buf > 0, stale_sum / torch.clamp_min(n_buf, 1).to(
                torch.float32), torch.zeros_like(stale_sum))
        out = (sel_mask, buf_ids, buf_valid, buf_stale, weights, k_t,
               avail.sum().to(torch.int32), n_buf, mean_stale, n_overflow,
               m.loss, m.delta_norm)
        return AsyncCarry(key, params, opt_state, algo_state, avail_state,
                          pool), out

    def chunk(self, carry: AsyncCarry, ts):
        """Advance one chunk of server steps; returns (carry',
        AsyncStream), still on the device."""
        outs = []
        for t in ts:
            carry, out = self.round_step(carry, int(t))
            outs.append(out)
        return carry, AsyncStream(*(torch.stack(col) for col in zip(*outs)))


# ---------------------------------------------------------------------------
# Cell construction shared by the two executors
# ---------------------------------------------------------------------------

def _build_async_cell(scenario, algo_name, *, device, seed,
                      clients_per_round, beta, server_opt, server_lr,
                      prox_mu, positively_correlated, fed_mode,
                      strategy_kwargs, completion, completion_kwargs,
                      buffer_size, staleness_discount, select_impl="xla"):
    from .runner import build_task    # local import: runner ↔ engine
    sc = get_scenario(scenario)
    algo_name, server_opt, server_lr = resolve_strategy(algo_name, server_opt,
                                                        server_lr)
    if get_strategy_entry(algo_name).host_only:
        raise ValueError(
            f"strategy {algo_name!r} is host-only and not supported by the "
            f"buffered/async engine (its per-round host state has no "
            f"arrival-time semantics)")
    if staleness_discount not in STALENESS_DISCOUNTS:
        raise KeyError(f"unknown staleness discount {staleness_discount!r}; "
                       f"known: {sorted(STALENESS_DISCOUNTS)}")
    task, fed, init, loss, acc = build_task(sc.task, seed, device=device,
                                            **dict(sc.task_kwargs))
    n = fed.n_clients
    m = clients_per_round or task.clients_per_round
    beta = beta if beta is not None else task.beta

    avail_model = sc.build_availability(n, p=fed.p, device=device)
    budget = sc.build_budget(default_k=m, device=device)
    arrival = sc.build_completion(n, avail_model=avail_model,
                                  override=completion,
                                  override_kwargs=completion_kwargs,
                                  device=device)
    if not getattr(arrival, "has_latency", False):
        raise ValueError(
            f"aggregation='buffered' needs a latency-capable completion "
            f"process ('always' or 'deadline'), got "
            f"{type(arrival).__name__}: a Bernoulli dropout draw has no "
            f"arrival time to buffer on")
    buffer_size = int(buffer_size) if buffer_size else max(1, m // 2)

    hyper = dict(beta=beta, positively_correlated=positively_correlated,
                 clients_per_round=m, select_impl=select_impl)
    hyper.update(strategy_kwargs or {})
    strategy = make_strategy(algo_name, n, fed.p, device=device, **hyper)
    opt = make_optimizer(server_opt, lr=server_lr)
    fed_round = make_fed_round(loss, opt, mode=fed_mode, prox_mu=prox_mu)
    # the cohort of one buffered step is the buffer, not k_max slots
    sampler = CohortSampler(fed, cohort_size=buffer_size,
                            local_steps=task.local_steps,
                            local_batch=task.local_batch, seed=seed)
    test_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in fed.test_batch().items()}
    return dict(scenario=sc, task=task, n_clients=n, algo_name=algo_name,
                rounds_default=sc.rounds or task.rounds,
                eval_loss=loss, eval_acc=acc, test_batch=test_batch,
                avail_model=avail_model, budget=budget, strategy=strategy,
                arrival=arrival, opt=opt, init=init, fed_round=fed_round,
                sampler=sampler, buffer_size=buffer_size,
                pool_slots=default_pool_slots(buffer_size, budget.k_max))


def _result(history, final, strategy, algo_state, n, sel_history,
            comp_history, async_history, streams):
    from .runner import TrainResult, _rates_np  # local: runner ↔ engine
    return TrainResult(history=history, final_metrics=final,
                       rates=_rates_np(strategy, algo_state, n),
                       empirical_rates=sel_history.mean(0),
                       sel_history=sel_history, comp_history=comp_history,
                       async_history=async_history
                       ).with_streams(**streams)


def _stack_streams(streams) -> tuple:
    """Per-chunk AsyncStream numpy structs -> (sel_history, comp_history,
    async_history, the sync streams)."""
    def cat(name):
        return np.concatenate([getattr(s, name) for s in streams], axis=0)
    sel_history = cat("sel_mask")
    buf_ids, buf_valid = cat("buf_ids"), cat("buf_valid")
    comp_history = np.zeros_like(sel_history)
    t_idx = np.repeat(np.arange(buf_ids.shape[0]), buf_ids.shape[1])
    flat_valid = buf_valid.ravel()
    comp_history[t_idx[flat_valid], buf_ids.ravel()[flat_valid]] = True
    async_history = dict(
        buf_ids=buf_ids, buf_valid=buf_valid,
        buf_staleness=cat("buf_staleness"), buf_weights=cat("buf_weights"),
        n_buffered=cat("n_buffered"), mean_staleness=cat("mean_staleness"),
        n_overflow=cat("n_overflow"))
    sync = {k: cat(k) for k in ("k_t", "n_available", "train_loss",
                                "delta_norm")}
    return sel_history, comp_history, async_history, sync


# ---------------------------------------------------------------------------
# One buffered cell end to end (either executor)
# ---------------------------------------------------------------------------

def run_scenario_buffered(scenario, algo_name: str = "f3ast", *,
                          rounds: Optional[int] = None,
                          server_opt: str = "sgd",
                          server_lr: Optional[float] = 1.0,
                          clients_per_round: Optional[int] = None,
                          beta: Optional[float] = None, seed: int = 0,
                          eval_every: int = 10,
                          chunk_size: Optional[int] = None,
                          ckpt_dir: Optional[str] = None,
                          prox_mu: float = 0.0,
                          positively_correlated: bool = False,
                          metrics_path: Optional[str] = None,
                          fed_mode: str = "parallel", strategy_kwargs=None,
                          completion: Optional[str] = None,
                          completion_kwargs=None,
                          buffer_size: Optional[int] = None,
                          staleness_power: float = 0.5,
                          staleness_discount: str = "polynomial",
                          select_impl: str = "xla", engine: str = "device",
                          algo_label: Optional[str] = None, log_fn=print,
                          device=None):
    """Run one buffered-aggregation cell on ``device`` (default CUDA) with
    the named executor: ``engine="device"`` the :class:`AsyncEngine` loop,
    ``engine="host"`` the event-driven reference.  Both give bitwise the
    same buffers, staleness, weights, masks and r_k for the same seed."""
    if engine not in ("device", "host"):
        raise ValueError(f"engine must be 'device' or 'host', got {engine!r}")
    device = resolve_device(device)
    ctx = _build_async_cell(
        scenario, algo_name, device=device, seed=seed,
        clients_per_round=clients_per_round, beta=beta,
        server_opt=server_opt, server_lr=server_lr, prox_mu=prox_mu,
        positively_correlated=positively_correlated, fed_mode=fed_mode,
        strategy_kwargs=strategy_kwargs, completion=completion,
        completion_kwargs=completion_kwargs, buffer_size=buffer_size,
        staleness_discount=staleness_discount, select_impl=select_impl)
    rounds = rounds or ctx["rounds_default"]
    run = _run_buffered_device if engine == "device" else _run_buffered_host
    return run(ctx, device=device, rounds=rounds, seed=seed,
               eval_every=eval_every, chunk_size=chunk_size,
               ckpt_dir=ckpt_dir, metrics_path=metrics_path,
               staleness_power=staleness_power,
               staleness_discount=staleness_discount,
               algo_label=algo_label or algo_name, log_fn=log_fn)


def _open_metrics(metrics_path):
    if not metrics_path:
        return None
    os.makedirs(os.path.dirname(os.path.abspath(metrics_path)),
                exist_ok=True)
    return open(metrics_path, "w")


def _record(sc, algo_label, t, *, k_t, n_available, n_selected, n_buffered,
            mean_staleness, n_overflow, train_loss, delta_norm):
    """One JSONL record a server step: the sync fields plus buffer
    occupancy, staleness and overflow."""
    return dict(scenario=sc.name, algorithm=algo_label, round=t,
                k_t=int(k_t), n_available=int(n_available),
                n_selected=int(n_selected), n_buffered=int(n_buffered),
                mean_staleness=float(mean_staleness),
                n_overflow=int(n_overflow), train_loss=float(train_loss),
                delta_norm=float(delta_norm))


def _evaluate(ctx, params):
    with torch.no_grad():
        return (float(ctx["eval_loss"](params, ctx["test_batch"])),
                float(ctx["eval_acc"](params, ctx["test_batch"])))


def _log_step(log_fn, sc, algo_label, t, test_loss, test_acc, k_t, row):
    log_fn(f"[{sc.name}/{algo_label}] step {t:4d} "
           f"loss={test_loss:.4f} acc={test_acc:.4f} k_t={k_t} "
           f"buf={row['n_buffered']} stale={row['mean_staleness']:.1f} "
           f"avail={row['n_available']}")


def _save(ckpt_dir, step, params, strategy, algo_state, n):
    from .runner import _rates_np   # local import: runner ↔ engine
    save_checkpoint(ckpt_dir, step,
                    {"params": params,
                     "rates": _rates_np(strategy, algo_state, n)})


def _run_buffered_device(ctx, *, device, rounds, seed, eval_every,
                         chunk_size, ckpt_dir, metrics_path, staleness_power,
                         staleness_discount, algo_label, log_fn):
    sc, task = ctx["scenario"], ctx["task"]
    engine = AsyncEngine(
        avail_model=ctx["avail_model"], budget=ctx["budget"],
        strategy=ctx["strategy"], staged=ctx["sampler"].stage_device(device),
        fed_round=ctx["fed_round"], init_params=ctx["init"], opt=ctx["opt"],
        client_lr=task.client_lr, local_steps=task.local_steps,
        local_batch=task.local_batch, arrival=ctx["arrival"],
        buffer_size=ctx["buffer_size"], device=device,
        staleness_power=staleness_power,
        staleness_discount=staleness_discount,
        pool_slots=ctx["pool_slots"])
    n_real = engine.n_clients
    chunk_size = max(1, min(chunk_size or eval_every, eval_every, rounds))
    carry = engine.init_carry(jr.PRNGKey(seed, device=device))
    metrics_file = _open_metrics(metrics_path)
    history, streams = [], []
    t_start = time.time()
    t_first_chunk = None
    try:
        for t0 in range(0, rounds, chunk_size):
            t1 = min(t0 + chunk_size, rounds)
            carry, out = engine.chunk(carry, range(t0, t1))
            # the one host sync of the chunk
            out_np = AsyncStream(*(x.cpu().numpy() for x in out))
            if t_first_chunk is None:
                t_first_chunk = time.time()
            streams.append(out_np)
            do_eval = (t1 == rounds
                       or any(t % eval_every == 0 for t in range(t0, t1)))
            if do_eval:
                test_loss, test_acc = _evaluate(ctx, carry.params)
                history.append(dict(
                    round=t1 - 1, train_loss=float(out_np.train_loss[-1]),
                    test_loss=test_loss, test_acc=test_acc,
                    n_selected=int(out_np.sel_mask[-1].sum()),
                    n_available=int(out_np.n_available[-1]),
                    n_buffered=int(out_np.n_buffered[-1]),
                    mean_staleness=float(out_np.mean_staleness[-1])))
                _log_step(log_fn, sc, algo_label, t1 - 1, test_loss,
                          test_acc, int(out_np.k_t[-1]), history[-1])
            if metrics_file:
                for i, t in enumerate(range(t0, t1)):
                    record = _record(
                        sc, algo_label, t, k_t=out_np.k_t[i],
                        n_available=out_np.n_available[i],
                        n_selected=out_np.sel_mask[i].sum(),
                        n_buffered=out_np.n_buffered[i],
                        mean_staleness=out_np.mean_staleness[i],
                        n_overflow=out_np.n_overflow[i],
                        train_loss=out_np.train_loss[i],
                        delta_norm=out_np.delta_norm[i])
                    if do_eval and t == t1 - 1:
                        record["test_loss"] = test_loss
                        record["test_acc"] = test_acc
                    metrics_file.write(json.dumps(record) + "\n")
                metrics_file.flush()
            if ckpt_dir:
                _save(ckpt_dir, t1, carry.params, engine.strategy,
                      carry.algo_state, n_real)
    finally:
        if metrics_file:
            metrics_file.close()
    t_end = time.time()
    sel_history, comp_history, async_history, sync = _stack_streams(streams)
    final = dict(history[-1])
    final["engine"] = "device"
    final["aggregation"] = "buffered"
    final["device"] = str(device)
    final["wall_s"] = t_end - t_start
    steady = rounds - min(chunk_size, rounds)
    if steady > 0 and t_end > t_first_chunk:
        final["steady_rounds_per_s"] = steady / (t_end - t_first_chunk)
    return _result(history, final, engine.strategy, carry.algo_state,
                   n_real, sel_history, comp_history, async_history, sync)


def _run_buffered_host(ctx, *, device, rounds, seed, eval_every, chunk_size,
                       ckpt_dir, metrics_path, staleness_power,
                       staleness_discount, algo_label, log_fn):
    """Event-driven reference loop over a sorted list of pending
    (arrival time, client, dispatch step) events; the buffer's batch is
    gathered in numpy.  ``chunk_size`` is accepted for symmetry: the host
    loop has no chunks."""
    sc, task = ctx["scenario"], ctx["task"]
    avail_model, budget = ctx["avail_model"], ctx["budget"]
    strategy, arrival = ctx["strategy"], ctx["arrival"]
    sampler, opt = ctx["sampler"], ctx["opt"]
    n = ctx["n_clients"]
    m_buf = ctx["buffer_size"]
    pool_slots = ctx["pool_slots"]
    fed_round = ctx["fed_round"]

    key = jr.PRNGKey(seed, device=device)
    params = ctx["init"](key)
    opt_state = opt.init(params)
    algo_state = strategy.init(n)
    avail_state = avail_model.init()

    pending = []   # [(time, cid, dispatch_step)] kept sorted lexically
    metrics_file = _open_metrics(metrics_path)
    history = []
    sel_history = np.zeros((rounds, n), bool)
    comp_history = np.zeros((rounds, n), bool)
    async_history = dict(
        buf_ids=np.zeros((rounds, m_buf), np.int32),
        buf_valid=np.zeros((rounds, m_buf), bool),
        buf_staleness=np.zeros((rounds, m_buf), np.int32),
        buf_weights=np.zeros((rounds, m_buf), np.float32),
        n_buffered=np.zeros(rounds, np.int32),
        mean_staleness=np.zeros(rounds, np.float32),
        n_overflow=np.zeros(rounds, np.int32))
    sync = {name: np.zeros(rounds, dt) for name, dt in (
        ("k_t", np.int32), ("n_available", np.int32),
        ("train_loss", np.float32), ("delta_norm", np.float32))}
    t_start = time.time()
    t_first_round = None
    try:
        for t in range(rounds):
            # Split order shared with AsyncEngine.round_step.
            key, k_av, k_sel, k_bud, k_batch = jr.split(key, 5)
            k_arr = jr.fold_in(k_sel, KEY_FOLD)
            avail_state, avail = avail_model.step(k_av, avail_state, t)
            k_t = budget.sample(k_bud, t)
            sel_mask, _, algo_state = strategy.select(
                algo_state, k_sel, avail, k_t, SelectCtx(t=t))
            sel_ids = np.flatnonzero(sel_mask.cpu().numpy())
            sel_history[t, sel_ids] = True
            # dispatch: one arrival event per selected client, its time a
            # float32 sum as the device pool's
            lat = arrival.latencies(k_arr, t).cpu().numpy()
            t_f = np.float32(t)
            for cid in sel_ids:
                pending.append((float(t_f + lat[cid]), int(cid), t))
            pending.sort()
            n_overflow = max(0, len(pending) - pool_slots)
            del pending[pool_slots:]
            # flush: the first M pending arrivals form the buffer
            buf = pending[:m_buf]
            del pending[:m_buf]
            buf_cids = [e[1] for e in buf]
            stale = np.zeros(m_buf, np.int32)
            bvalid = np.zeros(m_buf, bool)
            for i, (_, cid, t_disp) in enumerate(buf):
                stale[i] = t - t_disp
                bvalid[i] = True
            weights = staleness_weights(
                torch.from_numpy(stale).to(device),
                torch.from_numpy(bvalid).to(device), staleness_power,
                staleness_discount)
            batch_np, _, ids_pad = sampler.cohort_batch(
                buf_cids if buf_cids else [n - 1], key=k_batch)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch_np.items()}
            params, opt_state, metrics = fed_round(params, opt_state, batch,
                                                   weights, task.client_lr)
            train_loss = float(metrics.loss)
            if t == 0:
                t_first_round = time.time()
            comp_history[t, buf_cids] = True
            async_history["buf_ids"][t] = ids_pad
            async_history["buf_valid"][t] = bvalid
            async_history["buf_staleness"][t] = stale
            async_history["buf_weights"][t] = weights.cpu().numpy()
            async_history["n_buffered"][t] = len(buf)
            async_history["mean_staleness"][t] = (
                float(stale[bvalid].mean()) if buf else 0.0)
            async_history["n_overflow"][t] = n_overflow

            record = _record(sc, algo_label, t, k_t=int(k_t),
                             n_available=int(avail.sum()),
                             n_selected=len(sel_ids), n_buffered=len(buf),
                             mean_staleness=async_history["mean_staleness"][t],
                             n_overflow=n_overflow, train_loss=train_loss,
                             delta_norm=float(metrics.delta_norm))
            for name in sync:
                sync[name][t] = record[name]
            if t % eval_every == 0 or t == rounds - 1:
                record["test_loss"], record["test_acc"] = _evaluate(ctx,
                                                                    params)
                history.append(dict(
                    round=t, train_loss=record["train_loss"],
                    test_loss=record["test_loss"],
                    test_acc=record["test_acc"],
                    n_selected=record["n_selected"],
                    n_available=record["n_available"],
                    n_buffered=record["n_buffered"],
                    mean_staleness=record["mean_staleness"]))
                _log_step(log_fn, sc, algo_label, t, record["test_loss"],
                          record["test_acc"], record["k_t"], record)
            if metrics_file:
                metrics_file.write(json.dumps(record) + "\n")
                metrics_file.flush()
            if ckpt_dir and (t + 1) % 100 == 0:
                _save(ckpt_dir, t + 1, params, strategy, algo_state, n)
    finally:
        if metrics_file:
            metrics_file.close()
    t_end = time.time()
    final = dict(history[-1])
    final["engine"] = "host"
    final["aggregation"] = "buffered"
    final["device"] = str(device)
    final["wall_s"] = t_end - t_start
    if rounds > 1 and t_first_round is not None and t_end > t_first_round:
        final["steady_rounds_per_s"] = (rounds - 1) / (t_end - t_first_round)
    return _result(history, final, strategy, algo_state, n, sel_history,
                   comp_history, async_history, sync)
