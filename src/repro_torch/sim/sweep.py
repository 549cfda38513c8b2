"""Scenario × strategy grid sweep with streaming JSONL metrics (port of
``repro.sim.sweep``):

    python -m repro_torch.sim.sweep --scenarios homedevices,dropout \\
        --algorithms f3ast,fedavg,fedadam --rounds 3 --device cpu

Each (scenario, strategy) cell is ``dataclasses.replace`` of one base
:class:`RunSpec`, run through the port's ``run_spec``; it streams per-round
records to ``<out>/<scenario>__<algorithm>.jsonl`` and writes its spec to
``<out>/<scenario>__<algorithm>.spec.json`` (any cell reruns from that file
alone, in either package).  ``summary.json`` holds every cell's final
metrics, keyed ``"<scenario>|<algorithm>"`` — the JAX sweep's layout.
``--scenarios all`` sweeps the whole registry; ``--list`` prints it.
``--engine host`` runs every cell on the reference host loop;
``--aggregations sync,buffered`` adds a server-aggregation axis (the
FedBuff-style buffered server).  Every cell's spec is resolved before the
first one runs, so an invalid cell fails before any work.  Runs on CUDA
unless ``--device cpu``.  ``--mesh-shape C`` runs every cell on the
client-sharded engine over C ranks, ``C,M`` on the (clients, model) mesh
of C × M ranks (``--dist-backend``: gloo or nccl, default gloo on the CPU
and NCCL on CUDA).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
from typing import Callable, Optional, Sequence

from ..device import resolve_device
from .completion import COMPLETION_REGISTRY
from .runner import run_spec_dist
from .scenario import SCENARIO_REGISTRY, get_scenario, list_scenarios
from .spec import RunSpec

# the JAX sweep's universe for --algorithms all (fixed_f3ast needs an
# r_target to differ from f3ast; fedavg_weighted is a variant of fedavg)
ALGORITHMS = ("f3ast", "fedavg", "fedadam", "poc", "uniform")


def run_sweep(scenarios: Sequence[str],
              algorithms: Optional[Sequence[str]] = None, *,
              completions: Optional[Sequence[str]] = None,
              aggregations: Optional[Sequence[str]] = None,
              rounds: Optional[int] = None, out_dir: str = "experiments/sweep",
              seed: Optional[int] = None, server_opt: Optional[str] = None,
              eval_every: Optional[int] = None,
              engine: Optional[str] = None, device=None,
              base_spec: Optional[RunSpec] = None, mesh_shape=None,
              dist_backend: Optional[str] = None,
              log_fn: Callable = print) -> dict:
    """Run the grid on ``device`` (default CUDA); returns {(scenario,
    algorithm[, completion][, aggregation]): final_metrics}.
    ``algorithms=None`` takes each scenario's own grid; ``completions``
    adds a completion-process axis and ``aggregations`` a sync/buffered
    one; ``rounds``, ``seed``, ``server_opt`` and ``engine`` override
    ``base_spec`` where given; ``eval_every`` defaults to a fifth of the
    rounds."""
    device = resolve_device(device)    # no card: fail before any file
    overrides = {k: v for k, v in dict(rounds=rounds, seed=seed,
                                       server_opt=server_opt,
                                       engine=engine,
                                       mesh_shape=mesh_shape).items()
                 if v is not None}
    base = dataclasses.replace(base_spec or RunSpec(), **overrides)
    cells = []
    for sc_key in scenarios:
        sc = get_scenario(sc_key)
        algos = tuple(algorithms) if algorithms else sc.algorithms
        grid = itertools.product(
            algos, tuple(completions) if completions else (None,),
            tuple(aggregations) if aggregations else (None,))
        for algo, comp, agg in grid:
            cell = f"{sc.name}__{algo}"
            cell_key = (sc.name, algo)
            if completions:
                cell, cell_key = f"{cell}__{comp}", cell_key + (comp,)
            if aggregations:
                cell, cell_key = f"{cell}__{agg}", cell_key + (agg,)
            path = os.path.join(out_dir, f"{cell}.jsonl")
            ev = eval_every or max(1, (base.rounds or sc.rounds or 150)
                                   // 5)
            spec = dataclasses.replace(base, scenario=sc, strategy=algo,
                                       eval_every=ev, metrics_path=path)
            if comp is not None:
                spec = dataclasses.replace(spec, completion=comp)
            if agg is not None:
                spec = dataclasses.replace(spec, aggregation=agg)
            spec.resolved()            # fail before any cell runs
            cells.append((cell, cell_key, spec, path))
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for cell, cell_key, spec, path in cells:
        spec.save(os.path.join(out_dir, f"{cell}.spec.json"))
        res = run_spec_dist(spec, dist_backend=dist_backend,
                            log_fn=lambda *_: None, device=device)
        results[cell_key] = fm = res.final_metrics
        log_fn(f"sweep,{','.join(cell_key)},"
               f"acc={fm.get('test_acc', float('nan')):.4f},"
               f"loss={fm.get('test_loss', float('nan')):.4f},"
               f"wall_s={fm['wall_s']:.1f} -> {path}")
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"|".join(k): m for k, m in results.items()}, f, indent=1)
    return results


def _parse_list(arg: str, universe: Sequence[str]) -> list:
    if arg == "all":
        return list(universe)
    return [x.strip() for x in arg.split(",") if x.strip()]


def _parse_mesh_shape(arg: str) -> tuple:
    """'4' -> (4,); '2,2' -> (2, 2).  Validation lives in RunSpec.resolved."""
    return tuple(int(x.strip()) for x in arg.split(",") if x.strip())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Scenario × strategy sweep on the PyTorch port "
                    "(see repro_torch/sim/scenario.py)")
    ap.add_argument("--scenarios", default="bernoulli,markov,diurnal",
                    help="comma-separated scenario keys, or 'all'")
    ap.add_argument("--algorithms", default=None,
                    help="comma-separated strategy names, or 'all' "
                         f"({','.join(ALGORITHMS)}); default: each "
                         "scenario's own grid")
    ap.add_argument("--completions", default=None,
                    help="comma-separated completion-process keys, or "
                         "'all' (default: each scenario's own)")
    ap.add_argument("--aggregations", default=None,
                    help="comma-separated server-aggregation modes from "
                         "{sync,buffered}, or 'all' (default: sync only)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--out", default="experiments/sweep")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--server-opt", default="sgd")
    ap.add_argument("--eval-every", type=int, default=None)
    ap.add_argument("--engine", default="device", choices=["device", "host"],
                    help="the device engine (default) or the reference "
                         "host loop")
    ap.add_argument("--mesh-shape", default=None, metavar="C[,M]",
                    help="run every cell on the client-sharded engine over "
                         "C ranks, or on the (clients, model) mesh of C x M "
                         "ranks")
    ap.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                    help="the sharded engine's collectives (default: gloo "
                         "on the CPU, NCCL on CUDA with one card a rank)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in list_scenarios():
            sc = SCENARIO_REGISTRY[name]
            print(f"{name:<16} avail={sc.availability:<16} "
                  f"budget={sc.budget:<9} task={sc.task:<12} "
                  f"{sc.description}")
        return

    scenarios = _parse_list(args.scenarios, list_scenarios())
    algorithms = (_parse_list(args.algorithms, ALGORITHMS) if args.algorithms
                  else None)
    completions = (_parse_list(args.completions, sorted(COMPLETION_REGISTRY))
                   if args.completions else None)
    aggregations = (_parse_list(args.aggregations, ("sync", "buffered"))
                    if args.aggregations else None)
    run_sweep(scenarios, algorithms, completions=completions,
              aggregations=aggregations, rounds=args.rounds,
              out_dir=args.out, seed=args.seed, server_opt=args.server_opt,
              eval_every=args.eval_every, engine=args.engine,
              device=args.device, dist_backend=args.dist_backend,
              mesh_shape=(_parse_mesh_shape(args.mesh_shape)
                          if args.mesh_shape is not None else None))


if __name__ == "__main__":
    main()
