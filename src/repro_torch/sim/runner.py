"""Scenario executor: one (scenario × strategy) cell end to end (port of
``repro.sim.runner``).

    spec = RunSpec()                       # or RunSpec.from_json(...)
    result = run_spec(spec)                # on CUDA
    result = run_spec(spec, device="cpu")  # the CPU path (tests)

``device=None`` means CUDA; without a card that raises ``RuntimeError``
rather than running somewhere else.  ``run_spec`` dispatches as the JAX
package does:

* ``aggregation="buffered"`` — the FedBuff-style server
  (:mod:`repro_torch.sim.engine_async`), on ``spec.engine``'s executor;
* ``engine="device"`` (default) — the device engine
  (:mod:`repro_torch.sim.engine`); with ``mesh_shape=(c,)`` the
  client-sharded engine (:mod:`repro_torch.sim.engine_sharded`) over c
  ranks, with ``(c, m)`` over c × m ranks whose model axis splits the
  stored parameters and server-optimizer state: inside an initialized
  ``torch.distributed`` group (``torchrun``) this process is its rank of
  that group; otherwise ``run_spec`` spawns the ranks itself and returns
  rank 0's result (its ``final_params`` whole);
* ``engine="host"`` — the reference loop below: availability step →
  strategy ``select`` (completion-aware) → static-shape cohort batch
  assembled in numpy → the federated round on the device → per-round
  metrics.  It is the readable ground truth the engines are held to, and
  the only path for host-only strategies (PoC's fresh per-client losses):
  with ``engine="device"`` such a strategy warns and runs here, on the
  same device.

Every path splits the round key the same way (avail / select / budget /
batch, the completion key ``fold_in(k_sel, KEY_FOLD)``) and draws the
minibatch indices from the same ``randint``, so the host loop's masks,
K_t and r_k are bitwise the device engine's.  ``run_scenario`` is the
JAX package's deprecated kwarg spelling, kept as a shim.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import random as jr
from ..checkpoint import save_checkpoint
from ..configs import PAPER_TASKS
from ..configs.paper_tasks import DEFERRED_TASKS
from ..core.fedstep import make_fed_round
from ..core.keys import COMPLETION as KEY_FOLD
from ..core.strategies import (STRATEGY_ALIASES, SelectCtx,
                               get_strategy_entry, make_strategy,
                               strategy_rates)
from ..data import (CohortSampler, FederatedData, make_char_lm_federated,
                    make_synthetic_federated, make_vision_federated)
from ..device import resolve_device
from ..models import resnet, rnn, softmax_reg
from ..optim import make_optimizer
from ..registry import lookup
from .scenario import Scenario, get_scenario
from .spec import RunSpec


@dataclasses.dataclass
class TrainResult:
    history: list            # per-eval-round dicts
    final_metrics: dict
    rates: np.ndarray        # learned r(T) (NaN for rate-free strategies)
    empirical_rates: np.ndarray   # time-average of the selection masks
    sel_history: Optional[np.ndarray] = None   # (T, N) bool selection masks
    comp_history: Optional[np.ndarray] = None  # (T, N) bool completed masks
    #   (under aggregation="buffered": the clients aggregated at t)
    async_history: Optional[dict] = None       # buffered runs only: per-step
    #   buf_ids/buf_valid/buf_staleness/buf_weights (T, M) and n_buffered /
    #   mean_staleness / n_overflow (T,) — see sim.engine_async
    # the port's per-round streams, (T,) each: set by the engine after
    # construction, so the constructor's signature is the JAX package's
    k_t: Optional[np.ndarray] = dataclasses.field(default=None, init=False)
    n_available: Optional[np.ndarray] = dataclasses.field(default=None,
                                                          init=False)
    train_loss: Optional[np.ndarray] = dataclasses.field(default=None,
                                                         init=False)
    delta_norm: Optional[np.ndarray] = dataclasses.field(default=None,
                                                         init=False)
    # the device and sharded engines' final parameters, whole (gathered
    # over a model axis), their leaves in JAX's order as numpy
    final_params: Optional[list] = dataclasses.field(default=None,
                                                     init=False)

    def with_streams(self, **streams) -> "TrainResult":
        """Set the per-round streams (``k_t``, ``n_available``,
        ``train_loss``, ``delta_norm``) and ``final_params``; returns
        ``self``."""
        for name, value in streams.items():
            setattr(self, name, value)
        return self


def build_task(task_id: str, seed: int, device=None, **task_kwargs):
    """Resolve a PAPER_TASKS key into (task, data, init, loss, acc); the
    model is initialised on ``device`` (default CUDA).

    ``task_kwargs`` are forwarded to the federated data maker — e.g.
    ``alpha``/``beta`` select the Synthetic(α, β) heterogeneity level.
    """
    device = resolve_device(device)
    task_id = lookup("task", task_id, PAPER_TASKS, DEFERRED_TASKS, 10)
    task = PAPER_TASKS[task_id]
    cfg = task.model_cfg
    if task_id == "synthetic11":
        # §D.1: "The samples are split evenly among 100 clients."
        kw = dict(samples_per_client=100)
        kw.update(task_kwargs)
        clients = make_synthetic_federated(n_clients=task.n_clients,
                                           seed=seed, **kw)
        init = functools.partial(softmax_reg.init_params, cfg, device=device)
        loss = functools.partial(softmax_reg.loss_fn, cfg)
        acc = functools.partial(softmax_reg.accuracy, cfg)
    elif task_id == "shakespeare":
        clients = make_char_lm_federated(n_clients=task.n_clients, seed=seed,
                                         **task_kwargs)
        init = functools.partial(rnn.init_params, cfg, device=device)
        loss = functools.partial(rnn.loss_fn, cfg)
        acc = functools.partial(rnn.accuracy, cfg)
    else:   # cifar
        clients = make_vision_federated(n_clients=task.n_clients, seed=seed,
                                        **task_kwargs)
        strides = resnet.block_strides(cfg)

        def init(key):
            return resnet.init_params(cfg, key, device)[0]

        def acc(p, b):
            return resnet.accuracy(cfg, p, strides, b)

        loss = resnet.make_loss_fn(cfg, strides)
    return task, FederatedData(clients), init, loss, acc


# Kwargs the deprecated run_scenario(scenario, algo, **kwargs) spelling
# accepted, mapped onto their RunSpec fields.  "mesh" (a scalar shard
# count) predates RunSpec.mesh_shape and is rewritten to a 1-D shape.
_LEGACY_FIELDS = ("rounds", "server_opt", "clients_per_round", "beta",
                  "seed", "eval_every", "ckpt_dir", "prox_mu",
                  "positively_correlated", "metrics_path", "engine",
                  "chunk_size", "mesh", "mesh_shape", "clients_axis",
                  "model_axis", "strategy_kwargs")


def _legacy_server_lr(algo_name: str, server_lr) -> Optional[float]:
    """Old-signature server_lr semantics: the default was 1.0, and only the
    alias rewrite (fedadam) treated that value as "unset" (-> 1e-2)."""
    if server_lr is None:
        server_lr = 1.0
    if server_lr == 1.0 and str(algo_name).lower() in STRATEGY_ALIASES:
        return None            # let the alias fill its own default
    return server_lr


def _legacy_spec(scenario, algo_name, kwargs) -> RunSpec:
    warnings.warn(
        "run_scenario(scenario, algo_name, **kwargs) is deprecated; build "
        "a repro_torch.sim.RunSpec and call run_scenario(spec)",
        DeprecationWarning, stacklevel=3)
    unknown = set(kwargs) - set(_LEGACY_FIELDS) - {"server_lr"}
    if unknown:
        raise TypeError(f"run_scenario() got unexpected keyword arguments "
                        f"{sorted(unknown)}")
    algo_name = algo_name or "f3ast"
    server_lr = _legacy_server_lr(algo_name, kwargs.pop("server_lr", None))
    fields = {k: v for k, v in kwargs.items() if k in _LEGACY_FIELDS}
    if "mesh" in fields:
        mesh = fields.pop("mesh")
        if "mesh_shape" in fields:
            raise TypeError("pass either mesh= (deprecated scalar) or "
                            "mesh_shape=, not both")
        if mesh is not None:
            if isinstance(mesh, bool) or not isinstance(mesh,
                                                        (int, np.integer)):
                raise TypeError(
                    f"legacy mesh= takes an int shard count (got "
                    f"{type(mesh).__name__}); tuples go through "
                    f"mesh_shape=")
            fields["mesh_shape"] = (max(int(mesh), 0),)
    return RunSpec(scenario=scenario, strategy=algo_name,
                   server_lr=server_lr, **fields)


def run_scenario(spec: Union[RunSpec, str, Scenario] = None,
                 algo_name: Optional[str] = None, *,
                 log_fn: Callable = print, device=None,
                 **kwargs) -> TrainResult:
    """Run one (scenario × strategy) cell on ``device`` (default CUDA).

    Canonical form: ``run_scenario(spec)`` with a :class:`RunSpec`.  The
    deprecated ``run_scenario(scenario, algo_name, **kwargs)`` form still
    works and warns (``DeprecationWarning``).
    """
    if spec is None and "scenario" in kwargs:
        spec = kwargs.pop("scenario")   # old first parameter, by keyword
    if spec is None:
        raise TypeError("run_scenario() needs a RunSpec (or the deprecated "
                        "scenario key/Scenario first argument)")
    if not isinstance(spec, RunSpec):
        spec = _legacy_spec(spec, algo_name, kwargs)
    elif algo_name is not None or kwargs:
        raise TypeError("with a RunSpec, pass overrides via spec.replace("
                        "...) instead of extra arguments")
    return run_spec(spec, device=device, log_fn=log_fn)


def run_spec(spec: RunSpec, *, log_fn: Callable = print,
             device=None) -> TrainResult:
    """Execute a :class:`RunSpec` on ``device`` (default CUDA), on the
    engine it names.

    ``spec.resolved()`` validates up front, and rejects what the port does
    not run yet with ``NotImplementedError``, before anything is built.
    Host-only strategies (``needs_losses``/``host_only`` registry flags)
    fall back from the device engine to the host loop, on the same device,
    with a warning; ``final_metrics["engine"]`` names the engine that ran.
    ``mesh_shape=(c,)`` spawns c ranks, ``(c, m)`` c × m, on the default
    collective backend (:func:`run_spec_dist` names another).
    """
    return run_spec_dist(spec, log_fn=log_fn, device=device)


def run_spec_dist(spec: RunSpec, *, dist_backend: Optional[str] = None,
                  log_fn: Callable = print, device=None) -> TrainResult:
    """:func:`run_spec` with the sharded engine's collective backend
    chosen (the CLIs' ``--dist-backend``).

    ``dist_backend`` is the sharded engine's collective backend
    (``mesh_shape=(c,)`` or ``(c, m)``; ignored otherwise).  None means
    gloo on the CPU and NCCL on CUDA, one card a rank (``RuntimeError``
    when the ranks outnumber the cards); ``"gloo"`` on CUDA puts every
    rank on ``device``.
    """
    dev = resolve_device(device)
    rs = spec.resolved()
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return _dispatch(rs, spec.strategy, dev, log_fn, dist_backend)
    return _dispatch(rs, spec.strategy, dev, log_fn, dist_backend)


def _dispatch(rs: RunSpec, algo_label: str, dev, log_fn,
              dist_backend: Optional[str] = None) -> TrainResult:
    sc = get_scenario(rs.scenario)
    entry = get_strategy_entry(rs.strategy)
    if rs.aggregation == "buffered":
        from .engine_async import run_scenario_buffered  # lazy: ↔ runner
        return run_scenario_buffered(
            sc, rs.strategy, device=dev, algo_label=algo_label,
            rounds=rs.rounds, server_opt=rs.server_opt,
            server_lr=rs.server_lr, clients_per_round=rs.clients_per_round,
            beta=rs.beta, seed=rs.seed, eval_every=rs.eval_every,
            chunk_size=rs.chunk_size, ckpt_dir=rs.ckpt_dir,
            prox_mu=rs.prox_mu,
            positively_correlated=rs.positively_correlated,
            metrics_path=rs.metrics_path, fed_mode=rs.fed_mode,
            strategy_kwargs=rs.strategy_kwargs, completion=rs.completion,
            completion_kwargs=rs.completion_kwargs,
            buffer_size=rs.buffer_size, staleness_power=rs.staleness_power,
            staleness_discount=rs.staleness_discount,
            select_impl=rs.select_impl, engine=rs.engine, log_fn=log_fn)
    if rs.engine == "host" and rs.mesh_shape is not None:
        raise ValueError("mesh_shape= shards the device engine's client "
                         "dimension; it cannot apply to engine='host' (drop "
                         "mesh_shape or use engine='device')")
    fallback_reason = None
    if rs.engine == "device" and entry.host_only:
        fallback_reason = (
            f"strategy {algo_label!r} needs fresh per-client losses "
            f"computed on the host each round" if entry.needs_losses else
            f"strategy {algo_label!r} is registered host-only")
        warnings.warn(
            f"algorithm {algo_label!r} is not supported by the device "
            f"engine ({fallback_reason}); falling back to engine='host'",
            stacklevel=3)
    if rs.engine == "device" and fallback_reason is None:
        if rs.mesh_shape is not None:
            return _run_sharded(rs, algo_label, dev, log_fn, dist_backend)
        return _run_device(rs, algo_label, dev, log_fn)
    return _run_host(rs, sc, dev, algo_label, fallback_reason, log_fn)


def _run_device(rs: RunSpec, algo_label: str, dev, log_fn,
                mesh=None) -> TrainResult:
    """The device engine, or one shard of the sharded engine (``mesh``)."""
    from .engine import run_scenario_device  # lazy: engine ↔ runner
    return run_scenario_device(
        get_scenario(rs.scenario), rs.strategy, device=dev,
        algo_label=algo_label, rounds=rs.rounds, server_opt=rs.server_opt,
        server_lr=rs.server_lr, clients_per_round=rs.clients_per_round,
        beta=rs.beta, seed=rs.seed, eval_every=rs.eval_every,
        chunk_size=rs.chunk_size, ckpt_dir=rs.ckpt_dir, prox_mu=rs.prox_mu,
        positively_correlated=rs.positively_correlated,
        metrics_path=rs.metrics_path, fed_mode=rs.fed_mode,
        strategy_kwargs=rs.strategy_kwargs, completion=rs.completion,
        completion_kwargs=rs.completion_kwargs, select_impl=rs.select_impl,
        mesh=mesh, clients_axis=rs.clients_axis, model_axis=rs.model_axis,
        topk_impl=rs.topk_impl, log_fn=log_fn)


def _run_sharded(rs: RunSpec, algo_label: str, dev, log_fn,
                 dist_backend: Optional[str]) -> TrainResult:
    """``mesh_shape=(c,)`` or ``(c, m)``: this process's rank of an
    initialized group, or c × m spawned ranks (the global rank 0's
    result; its log lines replayed here)."""
    from ..launch.mesh import make_fed_mesh, spawn_ranks
    axes = (rs.clients_axis, rs.model_axis)
    if dist.is_available() and dist.is_initialized():
        mesh = make_fed_mesh(rs.mesh_shape, axis_names=axes)
        if mesh.backend == "nccl" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", mesh.rank % torch.cuda.device_count())))
        return _run_device(rs, algo_label, dev, log_fn, mesh)
    # 0 fills with the visible cards (one rank on the CPU)
    ranks = torch.cuda.device_count() if dev.type == "cuda" else 1
    shape = tuple(rs.mesh_shape)
    if 0 in shape:
        fixed = math.prod(s for s in shape if s)
        shape = tuple(s if s else max(ranks // fixed, 1) for s in shape)
    size = math.prod(shape)
    if size == 1:
        return _run_device(rs, algo_label, dev, log_fn,
                           make_fed_mesh(shape, axis_names=axes))
    backend = dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("dist_backend='nccl' needs a CUDA device")
        if size > torch.cuda.device_count():
            raise RuntimeError(
                f"mesh_shape {shape} on NCCL needs one card a rank "
                f"({size}), and {torch.cuda.device_count()} are visible; "
                f'pass dist_backend="gloo" to put every rank on {dev}')
    res, lines = spawn_ranks(_sharded_rank, size, rs.to_json(), algo_label,
                             str(dev), backend=backend, mesh_shape=shape,
                             axis_names=axes)[0]
    for line in lines:
        log_fn(line)
    return res


def _sharded_rank(mesh, spec_json: str, algo_label: str, device: str):
    """One spawned rank of :func:`_run_sharded`: the global rank 0 returns
    (result, log lines), the others None."""
    dev = torch.device(device)
    if mesh.backend == "nccl":
        dev = torch.device("cuda", mesh.rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    lines = []
    res = _run_device(RunSpec.from_json(spec_json), algo_label, dev,
                      lines.append, mesh)
    return (res, lines) if mesh.rank == 0 else None


def _to_device(batch_np: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}


def _run_host(rs: RunSpec, sc: Scenario, dev, algo_label: str,
              fallback_reason: Optional[str], log_fn) -> TrainResult:
    """The host reference loop (JAX's ``runner.run_spec`` loop): each
    round's cohort batch is gathered in numpy and shipped to ``dev``; every
    tensor op runs there."""
    task, fed, init, loss, acc = build_task(sc.task, rs.seed, device=dev,
                                            **dict(sc.task_kwargs))
    rounds = rs.rounds or sc.rounds or task.rounds
    M = rs.clients_per_round or task.clients_per_round
    beta = rs.beta if rs.beta is not None else task.beta
    N = fed.n_clients

    avail_model = sc.build_availability(N, p=fed.p, device=dev)
    budget = sc.build_budget(default_k=M, device=dev)
    comp_model = sc.build_completion(N, avail_model=avail_model,
                                     override=rs.completion,
                                     override_kwargs=rs.completion_kwargs,
                                     device=dev)
    # engine-supplied defaults; explicit strategy_kwargs win on overlap
    hyper = dict(beta=beta, positively_correlated=rs.positively_correlated,
                 clients_per_round=M, select_impl=rs.select_impl)
    hyper.update(rs.strategy_kwargs)
    strategy = make_strategy(rs.strategy, N, fed.p, device=dev, **hyper)
    algo_state = strategy.init(N)    # built-ins calibrate r0 = M/N

    opt = make_optimizer(rs.server_opt, lr=rs.server_lr)
    key = jr.PRNGKey(rs.seed, device=dev)
    params = init(key)
    opt_state = opt.init(params)
    # the JAX host loop's round is always the parallel cohort mode
    fed_round = make_fed_round(loss, opt, mode="parallel",
                               prox_mu=rs.prox_mu)
    sampler = CohortSampler(fed, cohort_size=budget.k_max,
                            local_steps=task.local_steps,
                            local_batch=task.local_batch, seed=rs.seed)
    test_batch = _to_device(fed.test_batch(), dev)
    avail_state = avail_model.init()
    trivial = comp_model.trivial

    # PoC-style strategies: fresh per-client losses of the current global
    # model on each client's first 64 train samples (staged once); one
    # evaluation and one host sync a client
    loss_sets = ([_to_device({k: v[:64] for k, v in c.train.items()}, dev)
                  for c in fed.clients] if strategy.needs_losses else None)

    def fresh_losses(params) -> torch.Tensor:
        out = np.zeros(N, np.float32)
        with torch.no_grad():
            for k in range(N):
                out[k] = float(loss(params, loss_sets[k]))
        return torch.from_numpy(out).to(dev)

    metrics_file = None
    if rs.metrics_path:
        os.makedirs(os.path.dirname(os.path.abspath(rs.metrics_path)),
                    exist_ok=True)
        metrics_file = open(rs.metrics_path, "w")

    history = []
    sel_history = np.zeros((rounds, N), bool)
    comp_history = np.zeros((rounds, N), bool)
    streams = {name: np.zeros(rounds, dt) for name, dt in (
        ("k_t", np.int32), ("n_available", np.int32),
        ("train_loss", np.float32), ("delta_norm", np.float32))}
    t_start = time.time()
    t_first_round = None
    try:
        for t in range(rounds):
            # Split order shared with sim/engine.py.  The completion key is
            # derived (fold_in off k_sel), never split from the main stream.
            key, k_av, k_sel, k_bud, k_batch = jr.split(key, 5)
            avail_state, avail = avail_model.step(k_av, avail_state, t)
            k_t = budget.sample(k_bud, t)
            losses_in = fresh_losses(params) if strategy.needs_losses \
                else None
            if trivial:
                complete_fn = None
            else:
                k_comp = jr.fold_in(k_sel, KEY_FOLD)

                def complete_fn(m):
                    return comp_model.sample(k_comp, t, m)
            sel_mask, weights_full, algo_state = strategy.select(
                algo_state, k_sel, avail, k_t,
                SelectCtx(t=t, losses=losses_in, complete=complete_fn))
            sel_ids = np.flatnonzero(sel_mask.cpu().numpy())
            sel_history[t, sel_ids] = True
            # same pure draw as inside select: the same completed mask
            completed = sel_mask if trivial else complete_fn(sel_mask)
            comp_np = completed.cpu().numpy()
            comp_history[t] = comp_np

            batch_np, valid, ids = sampler.cohort_batch(sel_ids, key=k_batch)
            # dropped slots are zero-weighted whether or not the strategy's
            # finalize renormalized over the survivors
            w = torch.from_numpy(weights_full.cpu().numpy()[ids] * valid
                                 * comp_np[ids]).to(dev)
            params, opt_state, metrics = fed_round(
                params, opt_state, _to_device(batch_np, dev), w,
                task.client_lr)
            train_loss = float(metrics.loss)
            if t == 0:
                t_first_round = time.time()

            record = dict(scenario=sc.name, algorithm=algo_label, round=t,
                          k_t=int(k_t), n_available=int(avail.sum()),
                          n_selected=int(len(sel_ids)),
                          n_completed=int(comp_np.sum()),
                          train_loss=train_loss,
                          delta_norm=float(metrics.delta_norm))
            for name in streams:
                streams[name][t] = record[name]
            if t % rs.eval_every == 0 or t == rounds - 1:
                with torch.no_grad():
                    record["test_loss"] = float(loss(params, test_batch))
                    record["test_acc"] = float(acc(params, test_batch))
                history.append(dict(round=t, train_loss=record["train_loss"],
                                    test_loss=record["test_loss"],
                                    test_acc=record["test_acc"],
                                    n_selected=record["n_selected"],
                                    n_available=record["n_available"],
                                    n_completed=record["n_completed"]))
                log_fn(f"[{sc.name}/{algo_label}] round {t:4d} "
                       f"loss={record['test_loss']:.4f} "
                       f"acc={record['test_acc']:.4f} k_t={record['k_t']} "
                       f"sel={record['n_selected']} "
                       f"done={record['n_completed']} "
                       f"avail={record['n_available']}")
            if metrics_file:
                metrics_file.write(json.dumps(record) + "\n")
                metrics_file.flush()
            if rs.ckpt_dir and (t + 1) % 100 == 0:
                save_checkpoint(rs.ckpt_dir, t + 1,
                                {"params": params,
                                 "rates": _rates_np(strategy, algo_state,
                                                    N)})
    finally:
        if metrics_file:
            metrics_file.close()

    t_end = time.time()
    final = dict(history[-1]) if history else {}
    final["engine"] = "host"
    if fallback_reason is not None:
        final["engine_fallback"] = fallback_reason
    final["device"] = str(dev)
    final["wall_s"] = t_end - t_start
    # scale accounting, as the device engine reports it: the host loop
    # keeps client data in numpy (nothing staged) and selects on one
    # process (no collective traffic)
    final["n_staged_bytes"] = 0
    final["selection_comm_bytes_per_round"] = 0
    # steady-state throughput: round 0 excluded
    if rounds > 1 and t_first_round is not None and t_end > t_first_round:
        final["steady_rounds_per_s"] = (rounds - 1) / (t_end - t_first_round)
    return TrainResult(history=history, final_metrics=final,
                       rates=_rates_np(strategy, algo_state, N),
                       empirical_rates=sel_history.mean(0),
                       sel_history=sel_history, comp_history=comp_history
                       ).with_streams(**streams)


def _rates_np(strategy, algo_state, n: int) -> np.ndarray:
    """The tracked r_k as numpy (NaN for rate-free strategies)."""
    r = strategy_rates(strategy, algo_state)
    return (np.full(n, np.nan, np.float32) if r is None
            else r.detach().cpu().numpy())
