"""Scenario executor: one (scenario × strategy) cell end to end (port of
``repro.sim.runner``'s ``run_spec`` front end, device engine only).

    spec = RunSpec()                       # or RunSpec.from_json(...)
    result = run_spec(spec)                # on CUDA
    result = run_spec(spec, device="cpu")  # the CPU path (tests)

``device=None`` means CUDA; without a card that raises ``RuntimeError``
rather than running somewhere else.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import PAPER_TASKS
from ..configs.paper_tasks import DEFERRED_TASKS
from ..data import (FederatedData, make_char_lm_federated,
                    make_synthetic_federated, make_vision_federated)
from ..device import resolve_device
from ..models import resnet, rnn, softmax_reg
from ..registry import lookup
from .scenario import get_scenario
from .spec import RunSpec


@dataclasses.dataclass
class TrainResult:
    history: list            # per-eval-round dicts
    final_metrics: dict
    rates: np.ndarray        # learned r(T) (NaN for rate-free strategies)
    empirical_rates: np.ndarray   # time-average of the selection masks
    sel_history: Optional[np.ndarray] = None   # (T, N) bool selection masks
    comp_history: Optional[np.ndarray] = None  # (T, N) bool completed masks
    # per-round streams of the device engine, (T,) each
    k_t: Optional[np.ndarray] = None
    n_available: Optional[np.ndarray] = None
    train_loss: Optional[np.ndarray] = None
    delta_norm: Optional[np.ndarray] = None


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


def run_spec(spec: RunSpec, device=None, *,
             log_fn: Callable = print) -> TrainResult:
    """Execute a :class:`RunSpec` on ``device`` (default CUDA).

    ``spec.resolved()`` validates up front, and rejects what the port does
    not run yet with ``NotImplementedError``, before anything is built.
    """
    dev = resolve_device(device)
    rs = spec.resolved()
    from .engine import run_scenario_device   # local import: engine ↔ runner
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return _run(rs, spec, dev, log_fn, run_scenario_device)
    return _run(rs, spec, dev, log_fn, run_scenario_device)


def _run(rs: RunSpec, spec: RunSpec, dev, log_fn, run_scenario_device):
    return run_scenario_device(
        get_scenario(rs.scenario), rs.strategy, device=dev,
        algo_label=spec.strategy, rounds=rs.rounds,
        server_opt=rs.server_opt, server_lr=rs.server_lr,
        clients_per_round=rs.clients_per_round, beta=rs.beta, seed=rs.seed,
        eval_every=rs.eval_every, chunk_size=rs.chunk_size,
        prox_mu=rs.prox_mu, positively_correlated=rs.positively_correlated,
        metrics_path=rs.metrics_path, fed_mode=rs.fed_mode,
        strategy_kwargs=rs.strategy_kwargs, completion=rs.completion,
        completion_kwargs=rs.completion_kwargs,
        select_impl=rs.select_impl, log_fn=log_fn)
