#!/usr/bin/env python3
"""The client-sharded engine on NCCL across cards, held to the one-card
device engine.

    python3 chip_mesh_nccl.py        # from the root of a checkout, >= 2 cards

Needs two cards; the 4-rank cells need four cards of one host and are
skipped with fewer.  Builds the kernels, then prints one JSON line a
cell:

1. ``run_spec_nccl``: ``run_spec(RunSpec(rounds=100, mesh_shape=s))`` on
   CUDA with the default backend (NCCL, one card a rank; ``run_spec``
   spawns the ranks) for s = (2,) and (4,), and the (clients, model)
   meshes (2, 2), (1, 4) and (4, 1) (each rank's parameters and
   server-optimizer state its blocks over the model axis), against
   ``run_spec(RunSpec(rounds=100))`` on cuda:0: masks, K_t, |avail| and
   final r_k bitwise, train loss and delta norm within 1e-4, steady ms a
   round beside the device engine's; the final parameters bitwise, (2,
   2) the (2,) run's, (4, 1) the (4,) run's and (1, 4) the one-card
   run's (the all-gather over the model axis is exact, slicing commutes
   with the clients-axis sum, which has at most 2 terms or the 1-D run's
   buffer);
2. ``sharded_nccl``: the million-client cell of ``chip_smoke.py``
   (``nscale_engine``, N = 10^6) over 2 NCCL ranks, 30 rounds under each
   ``topk_impl``, against the same cell on cuda:0: the same checks, each
   rank's launches and the comm bytes.

Exits non-zero if a check fails.  The last line is the card's name and
power limit as nvidia-smi gives them.
"""
from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOSS_TOL = 1e-4
ROUNDS = 100
SHARDED_ROUNDS = 30
MESH_SHAPES = ((2,), (4,), (2, 2), (1, 4), (4, 1))
# the run whose final parameters each 2-D mesh's must equal bit for bit
PARAMS_REFERENCE = {(2, 2): (2,), (4, 1): (4,), (1, 4): (1,)}


def main() -> int:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_mesh_nccl: needs two CUDA devices", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.sim import RunSpec, run_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda:0")
    ok = True
    ref = run_spec(RunSpec(rounds=ROUNDS), device=dev, log_fn=lambda *a: None)
    runs = {(1,): ref}
    for shape in MESH_SHAPES:
        if math.prod(shape) > torch.cuda.device_count():
            continue
        t0 = time.perf_counter()
        res = run_spec(RunSpec(rounds=ROUNDS, mesh_shape=shape),
                       device="cuda", log_fn=lambda *a: None)
        runs[shape] = res
        bit = {"sel_mask": res.sel_history.tobytes()
               == ref.sel_history.tobytes(),
               "completed": res.comp_history.tobytes()
               == ref.comp_history.tobytes(),
               "k_t": res.k_t.tobytes() == ref.k_t.tobytes(),
               "n_available": res.n_available.tobytes()
               == ref.n_available.tobytes(),
               "final_r": res.rates.tobytes() == ref.rates.tobytes()}
        errs = cs.stream_errs(
            dict(train_loss=res.train_loss, delta_norm=res.delta_norm),
            dict(train_loss=ref.train_loss, delta_norm=ref.delta_norm),
            ROUNDS)
        row = dict(cell="run_spec_nccl", mesh_shape=list(shape),
                   shards=shape[0], rounds=ROUNDS,
                   engine=res.final_metrics["engine"],
                   steady_round_ms=cs.steady_ms(res.final_metrics),
                   device_steady_round_ms=cs.steady_ms(ref.final_metrics),
                   bitwise_vs_device=bit, **errs, tol=LOSS_TOL,
                   wall_s=time.perf_counter() - t0)
        p_ref = PARAMS_REFERENCE.get(shape)
        if p_ref in runs:
            row["params_reference"] = list(p_ref)
            row["params_bitwise"] = all(
                a.tobytes() == b.tobytes() for a, b in zip(
                    res.final_params, runs[p_ref].final_params))
            ok &= row["params_bitwise"]
        cs.emit(row)
        ok &= all(bit.values()) and max(errs.values()) <= LOSS_TOL
    engine = cs.nscale_engine(cs.CLIENTS_N, dev)
    spans = ((0, 10), (10, 20), (20, SHARDED_ROUNDS))
    card, rates, walls, _ = cs.drive_engine(engine, dev, spans,
                                            keep=(SHARDED_ROUNDS,))
    del engine
    t0 = time.perf_counter()
    ranks = spawn_ranks(cs.clients_mesh_rank, 2, str(dev), cs.CLIENTS_N,
                        SHARDED_ROUNDS, False, backend="nccl", threads=2)
    for impl in ("stream", "allgather"):
        r0 = ranks[0][impl]
        bit = cs.same_streams(card, r0["streams"], SHARDED_ROUNDS)
        bit["r_after_30"] = r0["rates"].tobytes() == rates[
            SHARDED_ROUNDS].tobytes()
        errs = cs.stream_errs(card, r0["streams"], SHARDED_ROUNDS)
        cs.emit(dict(cell="sharded_nccl", topk_impl=impl, n=cs.CLIENTS_N,
                     rounds=SHARDED_ROUNDS, bitwise_vs_device=bit, **errs,
                     tol=LOSS_TOL,
                     steady_round_ms=r0["steady_round_ms"],
                     device_steady_round_ms=cs.steady_chunk_ms(walls),
                     launches=[r[impl]["launches"] for r in ranks],
                     selection_comm_bytes_per_round=r0["comm"],
                     spawn_wall_s=time.perf_counter() - t0))
        ok &= all(bit.values()) and max(errs.values()) <= LOSS_TOL
    print(cs.gpu_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
