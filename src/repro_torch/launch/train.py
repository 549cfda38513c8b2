"""Federated training CLI (port of ``repro.launch.train``).

Parses the CLI straight into one frozen :class:`repro_torch.sim.RunSpec`
and runs it through :func:`repro_torch.sim.run_spec`, on CUDA unless
``--device cpu`` is given:

  python -m repro_torch.launch.train --task cifar --algo f3ast --rounds 20
  python -m repro_torch.launch.train --task shakespeare --algo fedavg \\
      --availability homedevices --server-opt adam
  python -m repro_torch.launch.train --scenario diurnal --rounds 200
  python -m repro_torch.launch.train --spec experiments/run.spec.json

  python -m repro_torch.launch.train --scenario straggler \
      --aggregation buffered --engine host --ckpt-dir /tmp/ckpt

``--save-spec``/``--spec`` write and read the same RunSpec JSON as the JAX
package's CLI.  ``--engine host`` runs the reference host loop,
``--aggregation buffered`` the FedBuff-style server (with
``--buffer-size``, ``--staleness-power``, ``--staleness-discount``),
``--ckpt-dir`` writes checkpoints and ``--algo poc`` runs Power-of-Choice
(on the host loop).  ``--mesh-shape C`` runs the client-sharded engine
over C ranks, ``--mesh-shape C,M`` the (clients, model) mesh of C × M
ranks (``--dist-backend`` gloo or nccl).

``--arch X [--smoke]`` runs a few federated rounds of an assigned
architecture's smoke config (:func:`run_arch_smoke`, as the JAX CLI does;
``--smoke`` is accepted for its spelling and is the only mode):

  python -m repro_torch.launch.train --arch llama3.2-1b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

import numpy as np
import torch

from .. import random as jr
from ..configs import PAPER_TASKS, get_arch
from ..core.availability import make_availability
from ..core.fedstep import make_fed_round
from ..core.strategies import STRATEGY_ALIASES, list_strategies, make_strategy
from ..device import resolve_device
from ..models import get_model_api
from ..optim import make_optimizer
from ..sim.completion import COMPLETION_REGISTRY
from ..sim.runner import (TrainResult, _legacy_server_lr, run_spec,
                          run_spec_dist)
from ..sim.scenario import Scenario, list_scenarios
from ..sim.spec import RunSpec

__all__ = ["TrainResult", "run_federated", "federated_rounds",
           "run_arch_smoke", "main"]


def run_federated(task_id: str = "synthetic11", algo_name: str = "f3ast",
                  availability: str = "homedevices",
                  rounds: Optional[int] = None, server_opt: str = "sgd",
                  server_lr: Optional[float] = None,
                  clients_per_round: Optional[int] = None,
                  k_jitter: int = 0, beta: Optional[float] = None,
                  seed: int = 0, eval_every: int = 10,
                  ckpt_dir: Optional[str] = None, prox_mu: float = 0.0,
                  log_fn: Callable = print,
                  positively_correlated: bool = False,
                  metrics_path: Optional[str] = None,
                  engine: str = "device", mesh_shape=None,
                  clients_axis: str = "clients", model_axis: str = "model",
                  device=None) -> TrainResult:
    """Availability-string front end: wraps the arguments into an ad-hoc
    :class:`Scenario` + :class:`RunSpec` and runs it on ``device``
    (default CUDA)."""
    sc = Scenario(name=availability, availability=availability,
                  budget="jittered" if k_jitter else "constant",
                  budget_kwargs={"jitter": k_jitter} if k_jitter else {},
                  task=task_id)
    spec = RunSpec(scenario=sc, strategy=algo_name, rounds=rounds,
                   server_opt=server_opt,
                   server_lr=_legacy_server_lr(algo_name, server_lr),
                   clients_per_round=clients_per_round, beta=beta, seed=seed,
                   eval_every=eval_every, ckpt_dir=ckpt_dir, prox_mu=prox_mu,
                   positively_correlated=positively_correlated,
                   metrics_path=metrics_path, engine=engine,
                   mesh_shape=mesh_shape, clients_axis=clients_axis,
                   model_axis=model_axis)
    return run_spec(spec, device=device, log_fn=log_fn)


def federated_rounds(fed_round, params, opt_state, key, *, vocab: int,
                     shape, rounds: int, n_clients: int = 16,
                     client_lr: float = 1e-2, embeds=None):
    """The round loop of :func:`run_arch_smoke`: f3ast over ``n_clients``
    equally weighted ``scarce`` (q = 0.5) clients with K_t = K, a
    ``randint`` cohort batch of ``shape`` = (K, E, B, S) tokens a round and
    the key split five ways a round, as JAX's loop.  ``embeds`` = (name,
    trailing shape) adds a batch entry (K, E, B) + trailing shape,
    float32 from the round's fifth key (JAX's draw for a float32 model,
    as the smoke configs are): a vlm's ("patch_embeds", (n_patches,
    vit_dim)), the audio family's ("frames", (enc_seq, d_model)).
    ``key`` is the key
    the parameters were drawn from.  Yields ``(t, mask, metrics,
    opt_state)`` after each round: the selection mask, the round's
    ``RoundMetrics`` and the server optimizer's new state (Adam's first
    moment after the first round is (1 - b1) times the round's delta); the
    parameters are carried inside."""
    device = key.device
    K = shape[0]
    p = np.full(n_clients, 1.0 / n_clients, np.float32)
    strategy = make_strategy("f3ast", n_clients, p, clients_per_round=K,
                             device=device)
    algo_state = strategy.init(n_clients)
    avail_proc = make_availability("scarce", n_clients, q=0.5, device=device)
    k_t = torch.tensor(K, dtype=torch.int32, device=device)
    for t in range(rounds):
        key, k1, k2, kb, kb_aux = jr.split(key, 5)
        avail = avail_proc.sample(k1, t)
        sel, w_full, algo_state = strategy.select(algo_state, k2, avail, k_t,
                                                  None)
        sel_ids = np.flatnonzero(sel.cpu().numpy())
        ids = (list(sel_ids) + [int(sel_ids[0])] * K)[:K]
        batch = {"tokens": jr.randint(kb, tuple(shape), 0, vocab)}
        if embeds is not None:
            name, tail = embeds
            batch[name] = jr.normal(kb_aux, tuple(shape[:3]) + tuple(tail))
        w = w_full[torch.as_tensor(ids, device=device)]
        params, opt_state, m = fed_round(params, opt_state, batch, w,
                                         client_lr)
        yield t, sel, m, opt_state


def run_arch_smoke(arch_id: str, rounds: int = 3, seed: int = 0,
                   log_fn: Callable = print, device=None):
    """Few federated rounds of the REDUCED assigned-arch model, line for
    line JAX's ``run_arch_smoke``: its smoke config from ``PRNGKey(seed)``,
    Adam at lr 1e-3, the parallel round with client lr 1e-2, K = 4, E = 2,
    B = 2, S = 64 (:func:`federated_rounds`).  On ``device`` (default
    CUDA).  Returns the round losses."""
    arch = get_arch(arch_id)
    cfg = arch.smoke_model
    device = resolve_device(device)
    api = get_model_api(cfg)
    key = jr.PRNGKey(seed, device=device)
    params = api.init_params(key, device)
    opt = make_optimizer("adam", lr=1e-3)
    fed_round = make_fed_round(api.loss_fn, opt, mode="parallel")
    losses = []
    embeds = {"vlm": ("patch_embeds", (cfg.n_patches, cfg.vit_dim)),
              "audio": ("frames", (cfg.enc_seq, cfg.d_model))
              }.get(cfg.family)
    loop = federated_rounds(fed_round, params, opt.init(params), key,
                            vocab=cfg.vocab, shape=(4, 2, 2, 64),
                            rounds=rounds, embeds=embeds)
    for t, _, m, _ in loop:
        losses.append(float(m.loss))
        log_fn(f"[{arch_id}-smoke] round {t} loss={losses[-1]:.4f}")
    assert all(np.isfinite(losses)), losses
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default=None, choices=list(PAPER_TASKS))
    ap.add_argument("--arch", default=None,
                    help="a few federated rounds of the architecture's "
                         "smoke config (run_arch_smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: the smoke config (the only mode, "
                         "as in the JAX CLI)")
    ap.add_argument("--scenario", default=None, choices=list_scenarios(),
                    help="registered scenario key (overrides "
                         "--availability)")
    ap.add_argument("--algo", default="f3ast",
                    choices=sorted(list_strategies()
                                   + list(STRATEGY_ALIASES)),
                    help="registered selection strategy (or alias)")
    ap.add_argument("--availability", default="homedevices")
    ap.add_argument("--completion", default=None,
                    choices=sorted(COMPLETION_REGISTRY))
    ap.add_argument("--completion-kwargs", default=None, metavar="JSON")
    ap.add_argument("--aggregation", default="sync",
                    choices=["sync", "buffered"])
    ap.add_argument("--buffer-size", type=int, default=None)
    ap.add_argument("--staleness-power", type=float, default=0.5)
    ap.add_argument("--staleness-discount", default="polynomial")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--server-opt", default=None)
    ap.add_argument("--clients-per-round", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="stream per-round metrics to this JSONL file")
    ap.add_argument("--prox-mu", type=float, default=0.0)
    ap.add_argument("--engine", default="device", choices=["device", "host"])
    ap.add_argument("--select-impl", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--mesh-shape", default=None, metavar="C[,M]")
    ap.add_argument("--clients-axis", default="clients")
    ap.add_argument("--model-axis", default="model")
    ap.add_argument("--spec", default=None, metavar="PATH",
                    help="load a RunSpec JSON and run it (the other run "
                         "flags are ignored)")
    ap.add_argument("--save-spec", default=None, metavar="PATH",
                    help="write the assembled RunSpec JSON before running")
    ap.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                    help="the sharded engine's collectives (default: gloo "
                         "on the CPU, NCCL on CUDA with one card a rank)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.arch:
        run_arch_smoke(args.arch, rounds=args.rounds or 3, seed=args.seed,
                       device=args.device)
        return
    if args.spec:
        spec = RunSpec.load(args.spec)
    else:
        scenario = args.scenario if args.scenario else Scenario(
            name=args.availability, availability=args.availability,
            task=args.task or "synthetic11")
        spec = RunSpec(scenario=scenario, strategy=args.algo,
                       rounds=args.rounds,
                       completion=args.completion,
                       completion_kwargs=(json.loads(args.completion_kwargs)
                                          if args.completion_kwargs else {}),
                       server_opt=args.server_opt or "sgd",
                       clients_per_round=args.clients_per_round,
                       seed=args.seed, ckpt_dir=args.ckpt_dir,
                       prox_mu=args.prox_mu, engine=args.engine,
                       select_impl=args.select_impl,
                       mesh_shape=(tuple(int(x) for x in
                                         args.mesh_shape.split(","))
                                   if args.mesh_shape else None),
                       clients_axis=args.clients_axis,
                       model_axis=args.model_axis,
                       aggregation=args.aggregation,
                       buffer_size=args.buffer_size,
                       staleness_power=args.staleness_power,
                       staleness_discount=args.staleness_discount,
                       metrics_path=args.metrics_jsonl)
    spec.resolved()             # what the port lacks fails here
    if args.save_spec:
        spec.save(args.save_spec)
        print(f"wrote {args.save_spec}")
    res = run_spec_dist(spec, dist_backend=args.dist_backend,
                        device=args.device)
    print(json.dumps(res.final_metrics, indent=1))


if __name__ == "__main__":
    main()
