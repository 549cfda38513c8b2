"""Device-resident round engine (port of ``repro.sim.engine``'s
``DeviceEngine``).

Every round runs on the device — availability step, K_t budget, the
strategy's ``select`` (the ``fed_select`` kernel on CUDA), cohort gather
from data staged once, the federated round (the ``fed_aggregate`` kernel on
CUDA) — with no host sync inside a round.  Per-round outputs stay on the
device and are stacked per *chunk* of rounds, so the host syncs once per
chunk.  Where the JAX engine is one ``lax.scan`` over a chunk, this one is
a Python loop of eager rounds.

Parity with the JAX device engine is exact by construction: the round key
is split the same way (``split(key, 5)`` → avail / select / budget /
batch, the completion key ``fold_in(k_sel, KEY_FOLD)``), and every draw
comes from the port's bit-identical threefry, so the same seed and the same
RunSpec give bitwise the same availability masks, K_t, selection and
completion masks and r_k trajectory.

The data is staged once (``StagedData``) or synthesized on demand: with a
``data.SynthTask`` as ``staged`` the cohort's block is drawn each round
(``synth_cohort_batch``) and nothing O(N) of the data is resident, which is
what lets a round run at N = 1e6–1e7.  The selection and completion masks
stream packed (``core.bitmask``); the drivers unpack once a chunk.
With a client mesh (``mesh=``) ``build_engine`` builds the client-sharded
engine (:mod:`repro_torch.sim.engine_sharded`) instead.

``run_cells_vmapped`` runs a batch of cells (seed × budget cap) over one
data realisation, as the JAX function of that name does.  There one
vmapped program steps every cell; here each cell's round is the eager
round of :class:`DeviceEngine`, the cells stepped round by round in turn,
so a round of C cells launches each simulation kernel C times.
"""
from __future__ import annotations

import json
import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .. import random as jr
from ..checkpoint import save_checkpoint
from ..convert import params_to_numpy
from ..core.bitmask import pack_bits, unpack_bits_np
from ..core.fedstep import make_fed_round
from ..core.keys import COMPLETION as KEY_FOLD
from ..core.selection import cohort_ids_from_mask
from ..core.strategies import (SelectCtx, get_strategy_entry,
                               make_strategy, resolve_strategy)
from ..data import CohortSampler
from ..data.pipeline import staged_cohort_batch, synth_cohort_batch
from ..data.synthetic import SynthTask
from ..device import resolve_device
from ..optim import make_optimizer
from ..sharding.rules import model_specs
from ..tree import tree_leaves
from .scenario import Scenario, get_scenario

__all__ = ["DeviceEngine", "RoundStream", "build_engine",
           "run_cells_vmapped", "run_scenario_device"]


class EngineCarry(NamedTuple):
    """Everything that persists across rounds."""
    key: torch.Tensor
    params: dict
    opt_state: object
    algo_state: object
    avail_state: object


class RoundStream(NamedTuple):
    """Per-round outputs of a chunk, stacked along the round axis.

    The two masks stream packed: (C, ceil(N/32)) words (``core.bitmask``,
    int32 holding the uint32 bits), 8× less device→host traffic than
    (C, N) bool at million-client N.  The drivers unpack once a chunk
    (:func:`_to_host`) before anything reads them.
    """
    sel_mask: torch.Tensor     # (C, ceil(N/32)) words — cohort S_t
    completed: torch.Tensor    # (C, ceil(N/32)) words — survivors ⊆ S_t
    k_t: torch.Tensor          # (C,) int32
    n_available: torch.Tensor  # (C,) int32
    train_loss: torch.Tensor   # (C,) f32
    delta_norm: torch.Tensor   # (C,) f32


def _to_host(out: RoundStream, n: int) -> RoundStream:
    """A chunk's stream on the host (numpy), the packed masks decoded to
    (C, n) bool (bits past ``n``, the client-dim padding, are never set):
    the one host sync of the chunk."""
    out_np = RoundStream(*(x.cpu().numpy() for x in out))
    return out_np._replace(sel_mask=unpack_bits_np(out_np.sel_mask, n),
                           completed=unpack_bits_np(out_np.completed, n))


def _staged_nbytes(staged) -> int:
    """Resident device bytes of a staged client dataset (0 when the data
    is synthesized on demand: nothing is resident)."""
    if isinstance(staged, SynthTask):
        return 0
    return int(sum(a.numel() * a.element_size()
                   for a in staged.arrays.values())
               + staged.counts.numel() * staged.counts.element_size())


class DeviceEngine:
    """One (scenario × strategy × task) cell on one device.

    ``chunk(carry, ts, k_cap)`` advances ``len(ts)`` rounds and returns
    the stacked :class:`RoundStream` (still on the device);
    ``init_carry(key)`` builds the round-0 state for a cell seed.
    ``k_cap`` bounds K_t (the budget-cap axis of
    :func:`run_cells_vmapped`); None leaves every draw as it is.
    ``staged`` is a ``StagedData`` or a ``data.SynthTask`` (then
    ``n_staged_bytes`` is 0 and each round synthesizes its cohort).
    ``device`` (None: CUDA) is where the engine's own tensors go.
    """

    def __init__(self, *, avail_model, budget, strategy, staged, fed_round,
                 init_params, opt, client_lr, local_steps, local_batch,
                 completion=None, device=None):
        self.avail_model = avail_model
        self.budget = budget
        self.strategy = strategy
        self.completion = completion
        self.device = resolve_device(device)
        self.k_max = budget.k_max
        self._synth = isinstance(staged, SynthTask)
        self.n_clients = (staged.n_clients if self._synth
                          else int(staged.counts.shape[0]))
        self.n_staged_bytes = _staged_nbytes(staged)
        self.selection_comm_bytes_per_round = 0   # single device: no comm
        self._staged = staged
        self._fed_round = fed_round
        self._init_params = init_params
        self._opt = opt
        self._client_lr = float(client_lr)
        self._local_steps = local_steps
        self._local_batch = local_batch
        self._trivial = completion is None or completion.trivial
        self._caps = {}             # k_cap -> its int32 scalar on the device

    def init_carry(self, key: torch.Tensor) -> EngineCarry:
        params = self._init_params(key)
        return EngineCarry(key=key, params=params,
                           opt_state=self._opt.init(params),
                           algo_state=self.strategy.init(self.n_clients),
                           avail_state=self.avail_model.init())

    def _cap(self, k_cap: int) -> torch.Tensor:
        """``k_cap`` staged on the device once."""
        if k_cap not in self._caps:
            self._caps[k_cap] = torch.tensor(int(k_cap), dtype=torch.int32,
                                             device=self.device)
        return self._caps[k_cap]

    def round_step(self, carry: EngineCarry, t: int,
                   k_cap: Optional[int] = None):
        """One round; returns (carry', per-round outputs), all on the
        device, with no host sync.  Its stages are profiler spans
        (``round/availability``, ``round/select``, ``round/cohort_batch``,
        ``round/fed_round``), read by ``chip_smoke.py --profile``."""
        # Same split order as the JAX engine's round_step — parity.  The
        # completion key is derived (fold_in), never split from the main
        # stream, so completion="always" leaves every other draw as it is.
        key, k_av, k_sel, k_bud, k_batch = jr.split(carry.key, 5)
        with record_function("round/availability"):
            avail_state, avail = self.avail_model.step(k_av,
                                                       carry.avail_state, t)
            k_t = self.budget.sample(k_bud, t)
            if k_cap is not None:
                k_t = torch.minimum(k_t, self._cap(k_cap))
        if self._trivial:
            complete_fn = None
        else:
            k_comp = jr.fold_in(k_sel, KEY_FOLD)

            def complete_fn(m):
                return self.completion.sample(k_comp, t, m)
        with record_function("round/select"):
            sel_mask, w_full, algo_state = self.strategy.select(
                carry.algo_state, k_sel, avail, k_t,
                SelectCtx(t=t, complete=complete_fn))
        completed = sel_mask if self._trivial else complete_fn(sel_mask)
        with record_function("round/cohort_batch"):
            ids, valid = cohort_ids_from_mask(sel_mask, self.k_max)
            gather = (synth_cohort_batch if self._synth
                      else staged_cohort_batch)
            batch = gather(self._staged, k_batch, ids, self._local_steps,
                           self._local_batch)
            w = w_full[ids] * valid
            if not self._trivial:
                w = w * completed[ids]
        with record_function("round/fed_round"):
            params, opt_state, m = self._fed_round(
                carry.params, carry.opt_state, batch, w, self._client_lr)
        out = (pack_bits(sel_mask), pack_bits(completed), k_t,
               avail.sum().to(torch.int32), m.loss, m.delta_norm)
        return EngineCarry(key, params, opt_state, algo_state,
                           avail_state), out

    def chunk(self, carry: EngineCarry, ts, k_cap: Optional[int] = None):
        """Advance one chunk of rounds; returns (carry', RoundStream)."""
        outs = []
        for t in ts:
            carry, out = self.round_step(carry, int(t), k_cap)
            outs.append(out)
        return carry, _stack(outs)


def _stack(outs) -> RoundStream:
    """Per-round outputs -> the chunk's RoundStream (still on the device)."""
    return RoundStream(*(torch.stack(col) for col in zip(*outs)))


def build_engine(scenario, algo_name: str = "f3ast", *, seed: int = 0,
                 clients_per_round: Optional[int] = None,
                 beta: Optional[float] = None, server_opt: str = "sgd",
                 server_lr: Optional[float] = None, prox_mu: float = 0.0,
                 positively_correlated: bool = False,
                 fed_mode: str = "parallel", mesh=None,
                 clients_axis: str = "clients", model_axis: str = "model",
                 strategy_kwargs=None, completion: Optional[str] = None,
                 completion_kwargs=None, select_impl: str = "xla",
                 topk_impl: str = "stream", device=None):
    """Build the cell for one (scenario × strategy) on ``device`` (None:
    CUDA).

    Returns ``(engine, ctx)`` where ``ctx`` carries what the run loop needs
    on the host side (eval fns, test batch, rounds default, N).  ``seed``
    selects the data realization; the cell's model seed is what
    ``init_carry`` takes.  ``mesh`` (a ``launch.mesh`` mesh, a shard
    count or a 1- or 2-D shape, resolved over ``clients_axis`` and
    ``model_axis``) builds the client-sharded engine, this process one
    rank of it, with ``topk_impl`` its distributed cut
    (``core.selection.TOPK_IMPLS``).  A mesh with the model axis (``(c,
    m)``) stores the parameters and the server optimizer's state split
    over it by ``sharding.rules.model_specs``.
    """
    from .runner import build_task   # local import: runner ↔ engine
    from .engine_sharded import ShardedEngine, resolve_client_mesh

    device = resolve_device(device)
    mesh = resolve_client_mesh(mesh, clients_axis, model_axis)

    if mesh is not None and select_impl == "pallas":
        raise ValueError(
            "select_impl='pallas' fuses the single-device top-k cut; the "
            "client-sharded engine keeps its distributed sharded_topk_mask "
            "(drop mesh= or use select_impl='xla')")

    sc = get_scenario(scenario)
    algo_name, server_opt, server_lr = resolve_strategy(algo_name, server_opt,
                                                        server_lr)
    if get_strategy_entry(algo_name).host_only:
        raise ValueError(
            f"strategy {algo_name!r} is host-only (needs per-round host "
            f"state); use run_spec with engine='host'")
    task, fed, init, loss, acc = build_task(sc.task, seed, device=device,
                                            **dict(sc.task_kwargs))
    n = fed.n_clients
    p = torch.from_numpy(fed.p).to(device)
    m = clients_per_round or task.clients_per_round
    beta = beta if beta is not None else task.beta

    avail_model = sc.build_availability(n, p=fed.p, device=device)
    budget = sc.build_budget(default_k=m, device=device)
    comp_model = sc.build_completion(n, avail_model=avail_model,
                                     override=completion,
                                     override_kwargs=completion_kwargs,
                                     device=device)
    hyper = dict(beta=beta, positively_correlated=positively_correlated,
                 clients_per_round=m, select_impl=select_impl)
    hyper.update(strategy_kwargs or {})
    strategy = make_strategy(algo_name, n, p, device=device, **hyper)
    opt = make_optimizer(server_opt, lr=server_lr)
    common = dict(avail_model=avail_model, budget=budget, strategy=strategy,
                  init_params=init, opt=opt, client_lr=task.client_lr,
                  local_steps=task.local_steps, local_batch=task.local_batch,
                  device=device, completion=comp_model)
    if mesh is not None:
        if fed_mode != "parallel":
            raise ValueError("the client-sharded engine runs the cohort in "
                             "parallel mode only (the mesh axis carries the "
                             f"cohort split); got fed_mode={fed_mode!r}")
        use_model = model_axis in mesh.axis_names
        p_specs = None
        if use_model:
            # the per-leaf layout over the model axis, from the parameters'
            # shapes: one tree for the round and the engine's carry
            with torch.no_grad():
                p_specs = model_specs(init(jr.PRNGKey(0, device=device)),
                                      mesh, model_axis=model_axis)
        fed_round = make_fed_round(
            loss, opt, mode="parallel", prox_mu=prox_mu,
            cohort_axis=mesh.axis_mesh(clients_axis),
            cohort_slots=budget.k_max,
            model_axis=mesh.axis_mesh(model_axis) if use_model else None,
            param_specs=p_specs)
        engine = ShardedEngine(
            mesh=mesh, axis=clients_axis,
            model_axis=model_axis if use_model else None,
            staged=CohortSampler(fed).stage_device(device, mesh=mesh,
                                                   axis=clients_axis),
            fed_round=fed_round, n_clients=n, topk_impl=topk_impl, **common)
    else:
        fed_round = make_fed_round(loss, opt, mode=fed_mode,
                                   prox_mu=prox_mu)
        engine = DeviceEngine(staged=CohortSampler(fed).stage_device(device),
                              fed_round=fed_round, **common)
    test_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in fed.test_batch().items()}
    ctx = dict(scenario=sc, task=task, n_clients=n,
               rounds_default=sc.rounds or task.rounds,
               eval_loss=loss, eval_acc=acc, test_batch=test_batch)
    return engine, ctx


def _silent(*args, **kwargs) -> None:
    pass


def _chunk_spans(rounds: int, chunk_size: int):
    """Split [0, rounds) into contiguous spans of at most chunk_size."""
    return [(t0, min(t0 + chunk_size, rounds))
            for t0 in range(0, rounds, chunk_size)]


def run_scenario_device(scenario, algo_name: str = "f3ast", *,
                        rounds: Optional[int] = None,
                        server_opt: str = "sgd",
                        server_lr: Optional[float] = None,
                        clients_per_round: Optional[int] = None,
                        beta: Optional[float] = None, seed: int = 0,
                        eval_every: int = 10,
                        chunk_size: Optional[int] = None,
                        ckpt_dir: Optional[str] = None,
                        prox_mu: float = 0.0,
                        positively_correlated: bool = False,
                        metrics_path: Optional[str] = None,
                        fed_mode: str = "parallel", mesh=None,
                        clients_axis: str = "clients",
                        model_axis: str = "model", strategy_kwargs=None,
                        completion: Optional[str] = None,
                        completion_kwargs=None, select_impl: str = "xla",
                        topk_impl: str = "stream",
                        algo_label: Optional[str] = None, log_fn=print,
                        device=None):
    """Run one cell on ``device`` (None: CUDA); same semantics, cadence
    and outputs as the JAX ``run_scenario_device`` (evaluation at the end
    of any chunk
    holding an ``eval_every`` round and after the final round; the
    ``chunk_size`` default is ``eval_every``; checkpoints, if
    ``ckpt_dir``, at chunk boundaries).  With a client ``mesh`` this
    process runs its shard of the sharded engine; every shard returns the
    same result, and only shard 0 logs and writes the metrics file and
    checkpoints.  With a model axis the evaluations, the checkpoints and
    the result's ``final_params`` are of the whole parameters, gathered
    over it."""
    device = resolve_device(device)
    engine, ctx = build_engine(
        scenario, algo_name, device=device, seed=seed,
        clients_per_round=clients_per_round, beta=beta,
        server_opt=server_opt, server_lr=server_lr, prox_mu=prox_mu,
        positively_correlated=positively_correlated, fed_mode=fed_mode,
        strategy_kwargs=strategy_kwargs, completion=completion,
        completion_kwargs=completion_kwargs, select_impl=select_impl,
        mesh=mesh, clients_axis=clients_axis, model_axis=model_axis,
        topk_impl=topk_impl)
    mesh = getattr(engine, "mesh", None)    # the resolved mesh
    lead = mesh is None or mesh.rank == 0   # the global rank 0
    full_params = getattr(engine, "full_params", lambda p: p)
    # gathering the parameters is collective: every rank at the same chunks
    gather_each_chunk = bool(ckpt_dir)
    if not lead:
        metrics_path = ckpt_dir = None
        log_fn = _silent
    n_real = engine.n_clients
    sc: Scenario = ctx["scenario"]
    rounds = rounds or ctx["rounds_default"]
    chunk_size = max(1, min(chunk_size or eval_every, eval_every, rounds))
    algo_label = algo_label or algo_name

    from .runner import TrainResult, _rates_np  # local: runner ↔ engine

    carry = engine.init_carry(jr.PRNGKey(seed, device=device))
    metrics_file = None
    if metrics_path:
        os.makedirs(os.path.dirname(os.path.abspath(metrics_path)),
                    exist_ok=True)
        metrics_file = open(metrics_path, "w")

    history, streams = [], []
    t_start = time.time()
    t_first_chunk = None
    try:
        for (t0, t1) in _chunk_spans(rounds, chunk_size):
            carry, out = engine.chunk(carry, range(t0, t1))
            # the one host sync of the chunk
            out_np = _to_host(out, n_real)
            if t_first_chunk is None:
                t_first_chunk = time.time()
            streams.append(out_np)
            do_eval = (t1 == rounds
                       or any(t % eval_every == 0 for t in range(t0, t1)))
            if do_eval or gather_each_chunk:
                params = full_params(carry.params)
            if do_eval:
                with torch.no_grad():
                    test_loss = float(ctx["eval_loss"](params,
                                                       ctx["test_batch"]))
                    test_acc = float(ctx["eval_acc"](params,
                                                     ctx["test_batch"]))
                history.append(dict(
                    round=t1 - 1, train_loss=float(out_np.train_loss[-1]),
                    test_loss=test_loss, test_acc=test_acc,
                    n_selected=int(out_np.sel_mask[-1].sum()),
                    n_available=int(out_np.n_available[-1]),
                    n_completed=int(out_np.completed[-1].sum())))
                log_fn(f"[{sc.name}/{algo_label}] round {t1 - 1:4d} "
                       f"loss={test_loss:.4f} acc={test_acc:.4f} "
                       f"k_t={int(out_np.k_t[-1])} "
                       f"sel={history[-1]['n_selected']} "
                       f"done={history[-1]['n_completed']} "
                       f"avail={history[-1]['n_available']}")
            if metrics_file:
                for i, t in enumerate(range(t0, t1)):
                    record = dict(scenario=sc.name, algorithm=algo_label,
                                  round=t, k_t=int(out_np.k_t[i]),
                                  n_available=int(out_np.n_available[i]),
                                  n_selected=int(out_np.sel_mask[i].sum()),
                                  n_completed=int(out_np.completed[i].sum()),
                                  train_loss=float(out_np.train_loss[i]),
                                  delta_norm=float(out_np.delta_norm[i]))
                    if do_eval and t == t1 - 1:
                        record["test_loss"] = test_loss
                        record["test_acc"] = test_acc
                    metrics_file.write(json.dumps(record) + "\n")
                metrics_file.flush()
            if ckpt_dir:
                save_checkpoint(ckpt_dir, t1,
                                {"params": params,
                                 "rates": _rates_np(engine.strategy,
                                                    carry.algo_state,
                                                    n_real)})
    finally:
        if metrics_file:
            metrics_file.close()

    sel_history = np.concatenate([s.sel_mask for s in streams], axis=0)
    comp_history = np.concatenate([s.completed for s in streams], axis=0)
    t_end = time.time()
    final = dict(history[-1])
    final["engine"] = "device" if mesh is None else "sharded"
    final["device"] = str(device)
    final["wall_s"] = t_end - t_start
    final["n_staged_bytes"] = engine.n_staged_bytes
    final["selection_comm_bytes_per_round"] = (
        engine.selection_comm_bytes_per_round)
    steady_rounds = rounds - min(chunk_size, rounds)
    if steady_rounds > 0 and t_end > t_first_chunk:
        final["steady_rounds_per_s"] = steady_rounds / (t_end - t_first_chunk)
    rates = _rates_np(engine.strategy, carry.algo_state, n_real)
    return TrainResult(history=history, final_metrics=final, rates=rates,
                       empirical_rates=sel_history.mean(0),
                       sel_history=sel_history, comp_history=comp_history
                       ).with_streams(
        final_params=tree_leaves(params_to_numpy(params)),
        k_t=np.concatenate([s.k_t for s in streams]),
        n_available=np.concatenate([s.n_available for s in streams]),
        train_loss=np.concatenate([s.train_loss for s in streams]),
        delta_norm=np.concatenate([s.delta_norm for s in streams]))


def run_cells_vmapped(scenario, algo_name: str = "f3ast", *,
                      seeds: Sequence[int] = (0,),
                      k_caps: Optional[Sequence[int]] = None,
                      rounds: Optional[int] = None, chunk_size: int = 32,
                      data_seed: Optional[int] = None, device=None,
                      **build_kwargs) -> dict:
    """Run a batch of cells on ``device`` (default CUDA): cell ``i`` runs
    with model/PRNG seed ``seeds[i]`` under K_t capped at ``k_caps[i]``
    (default: no cap).  All cells share one data realisation
    (``data_seed``, default ``seeds[0]``) and one scenario and task — the
    sweep column of a (scenario-param × seed) grid.  Returns the JAX
    function's dict of stacked per-cell results; the host syncs once a
    chunk for all cells."""
    from .runner import _rates_np   # local import: runner ↔ engine

    device = resolve_device(device)
    seeds = list(seeds)
    n_cells = len(seeds)
    if k_caps is not None:
        assert len(k_caps) == n_cells, (len(k_caps), n_cells)
    engine, ctx = build_engine(scenario, algo_name, device=device,
                               seed=seeds[0] if data_seed is None
                               else data_seed, **build_kwargs)
    caps = ([engine.k_max] * n_cells if k_caps is None
            else [int(c) for c in k_caps])
    rounds = rounds or ctx["rounds_default"]
    carries = [engine.init_carry(jr.PRNGKey(s, device=device))
               for s in seeds]

    streams = [[] for _ in seeds]
    t_start = time.time()
    t_first_chunk = None
    for (t0, t1) in _chunk_spans(rounds, chunk_size):
        outs = [[] for _ in seeds]
        for t in range(t0, t1):
            for c in range(n_cells):
                carries[c], out = engine.round_step(carries[c], t, caps[c])
                outs[c].append(out)
        for c in range(n_cells):
            streams[c].append(_to_host(_stack(outs[c]), engine.n_clients))
        if t_first_chunk is None:
            t_first_chunk = time.time()
    t_end = time.time()

    with torch.no_grad():
        test_loss = np.asarray([float(ctx["eval_loss"](c.params,
                                                       ctx["test_batch"]))
                                for c in carries], np.float32)
        test_acc = np.asarray([float(ctx["eval_acc"](c.params,
                                                     ctx["test_batch"]))
                               for c in carries], np.float32)

    def cat(name):
        return np.stack([np.concatenate([getattr(s, name) for s in cell])
                         for cell in streams])

    sel_history = cat("sel_mask")
    result = dict(seeds=seeds, k_caps=caps, rounds=rounds,
                  test_loss=test_loss, test_acc=test_acc,
                  train_loss=cat("train_loss"),      # (cells, T)
                  sel_history=sel_history,           # (cells, T, N)
                  comp_history=cat("completed"),     # (cells, T, N)
                  rates=np.stack([_rates_np(engine.strategy, c.algo_state,
                                            engine.n_clients)
                                  for c in carries]),
                  empirical_rates=sel_history.mean(axis=1),
                  wall_s=t_end - t_start)
    steady_rounds = rounds - min(chunk_size, rounds)
    if steady_rounds > 0 and t_end > t_first_chunk:
        result["steady_rounds_per_s"] = (
            steady_rounds * n_cells / (t_end - t_first_chunk))
    return result
