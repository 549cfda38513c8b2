#!/usr/bin/env python3
"""The client-sharded engine and the serving programs over a (data,
model) mesh on NCCL across cards, each held to its one-card program.

    python3 chip_mesh_nccl.py                  # both groups of cells
    python3 chip_mesh_nccl.py --cells serve    # the serving cells alone
    python3 chip_mesh_nccl.py --cells engine   # the engine cells alone

Run from the root of a checkout.  The engine cells need two cards (their
4-rank cells four, skipped with fewer), the serving cells four cards of
one host.  Builds the kernels, then prints one JSON line a cell.

The engine cells:

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

The serving cells (``launch.steps.build_prefill_step`` and
``build_decode_step`` with a ``mesh=``, one NCCL rank a card, one spawn
of 4 ranks; every mesh made inside it by ``make_fed_mesh``):

3. ``decode_32k``: llama3.2-1b at full width and depth, at the shape's
   batch of 128 (its KV cache is 137 GB, never on one card: each rank
   holds its block, (16, 128/d, 32,768, 8/m, 64)), 8 teacher-forced steps
   from index 32,760 at (4, 1), (2, 2) and (1, 4).  The cache is filled
   32 rows at a time (``chip_smoke.fill_kv``), so that the one-card
   program can step the same rows: each rank first steps its 32 rows
   alone (the reference and its ms a step at batch 32), and the
   references are gathered.  (4, 1) must be bitwise each rank's own rows;
   every mesh's distance from the float32 decode of each rank's first 16
   rows (the same weights and cache) at most SERVE_F32_RATIO times the
   one card's.  ms a step, tokens/s and each rank's peak memory; beside
   them the distance from one card and the floor, the one-card program's
   own rows stepped in two blocks of 16 against it; and a fault control,
   (1, 4) with each rank's row-parallel partials rounded to bf16 before
   their sum, against the same float32 rows;
4. ``prefill_32k``: llama3.2-1b at its batch of 32 x 32,768, the same
   three meshes, against the one-card prefill of 8 rows a card (what one
   card holds at once); (4, 1) bitwise, the others within 2e-2; wall;
   the floor: the 8 rows prefilled as two blocks of 4;
5. ``qwen3-14b``: full depth (40 layers), prefill B = 1, S = 8,192 at
   (1, 4) and (1, 2) (the (1, 2) mesh over ranks 0 and 1 of the group:
   a FedMesh over a group of two): each mesh's distance from the float32
   prefill of the same weights on card 0 at most SERVE_F32_RATIO times
   the one-card prefill's; wall beside the one card's; the distance from
   one card; the same fault control at (1, 4).

Exits non-zero if a check fails, or if a cell cannot run (it reports
why).  The last line is the cards' names and power limits as nvidia-smi
gives them.
"""
from __future__ import annotations

import contextlib
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

SERVE_ARCH = "llama3.2-1b"
SERVE_MESHES = ((4, 1), (2, 2), (1, 4))
DECODE_BLOCK = 32          # decode_32k's rows one card steps (34.4 GB)
DECODE_START = 32_760
DECODE_STEPS = 8
PREFILL_BLOCK = 8          # prefill_32k's rows one card prefills at once
QWEN_ARCH = "qwen3-14b"
QWEN_SEQ = 8192
QWEN_MESHES = ((1, 4), (1, 2))
SERVE_TOL = 2e-2           # bf16 prefill vs one card, over the largest
                           # magnitude (one card's prefill is bitwise
                           # across its row blockings)
# bf16 decode and qwen3-14b's 40 layers: each program's distance from the
# float32 run of the same rows, over the one card's bf16 distance from it
# (one card's own decode moves 2.6-2.9e-2 of the scale between row
# blockings, above SERVE_TOL; a fault in the split, a wrong block or a
# missing sum, puts the logits O(1) off)
SERVE_F32_RATIO = 1.5
SERVE_SEED = 23
SERVE_CELLS = ("decode", "prefill", "qwen")


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="engine,serve",
                    help="comma-separated: engine, serve")
    cells = set(ap.parse_args(argv[1:]).cells.split(","))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_mesh_nccl: needs two CUDA devices", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    ok = True
    if "engine" in cells:
        ok &= engine_cells(torch, cs)
    if "serve" in cells:
        ok &= serve_cells(torch, cs)
    print(cs.gpu_line(), flush=True)
    return 0 if ok else 1


def engine_cells(torch, cs) -> bool:
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.sim import RunSpec, run_spec

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
    return ok


# ---------------------------------------------------------------------------
# The serving programs over a (data, model) mesh
# ---------------------------------------------------------------------------

def _sync_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _rel_err(torch, got, want) -> tuple:
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / scale, scale


@contextlib.contextmanager
def partials_rounded():
    """The fault control: each rank's row-parallel partial product
    rounded to bf16 before the float32 sum over the model axis (after
    ``wo`` and ``w2``, twice a layer), as the programs first did."""
    from repro_torch.models import layers
    plain = layers.row_parallel

    def rounded(x, w, logical):
        return layers.sum_partials(x @ w, logical).to(x.dtype)

    layers.row_parallel = rounded
    try:
        yield
    finally:
        layers.row_parallel = plain


# each mesh's runs: (mesh shape, whether under the fault control)
SERVE_RUNS = tuple((s, False) for s in SERVE_MESHES) + (((1, 4), True),)
QWEN_RUNS = tuple((s, False) for s in QWEN_MESHES) + (((1, 4), True),)


def decode_cell(torch, cs, world, dev):
    """decode_32k at batch 128: each rank's 32 rows on the one-card
    program first, then the three meshes."""
    from repro_torch import random as jr
    from repro_torch.configs import INPUT_SHAPES, get_arch
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models import transformer
    from repro_torch.sharding.rules import local_blocks

    arch = get_arch(SERVE_ARCH)
    cfg = arch.model
    B = INPUT_SHAPES["decode_32k"]["global_batch"]
    M = INPUT_SHAPES["decode_32k"]["seq_len"]
    params = transformer.init_params(cfg, jr.PRNGKey(SERVE_SEED, device=dev),
                                     dev)
    toks = torch.randint(0, cfg.vocab, (B, DECODE_STEPS),
                         generator=torch.Generator().manual_seed(SERVE_SEED),
                         dtype=torch.int32)
    step, _, _ = build_decode_step(arch, "decode_32k")
    r0 = world.rank * DECODE_BLOCK
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = transformer.init_decode_state(cfg, DECODE_BLOCK, M, dev)
    cs.fill_kv(torch, st["caches"], SERVE_SEED, row0=r0,
               kv_heads=cfg.n_kv_heads, block=DECODE_BLOCK)
    st["index"].fill_(DECODE_START)
    mine = toks[r0:r0 + DECODE_BLOCK].to(dev)
    ref, ref_ms = [], []
    for t in range(DECODE_STEPS):
        (lg, st), ms = _sync_ms(torch, lambda: step(params, st,
                                                    mine[:, t:t + 1]))
        ref.append(lg)
        ref_ms.append(ms)
    ref_peak = torch.cuda.max_memory_allocated()
    del st
    ref = torch.stack(ref)                        # (steps, 32, 1, V)
    # the floor: the same rows stepped by the one-card program in two
    # blocks of 16 (other GEMM shapes, the same function)
    half = DECODE_BLOCK // 2
    floor = 0.0
    for h in range(2):
        st = transformer.init_decode_state(cfg, half, M, dev)
        cs.fill_kv(torch, st["caches"], SERVE_SEED, row0=r0 + h * half,
                   kv_heads=cfg.n_kv_heads, block=DECODE_BLOCK)
        st["index"].fill_(DECODE_START)
        for t in range(DECODE_STEPS):
            lg, st = step(params, st,
                          mine[h * half:(h + 1) * half, t:t + 1])
            floor = max(floor, _rel_err(
                torch, lg, ref[t, h * half:(h + 1) * half])[0])
        del st
    full_ref = world.all_gather(ref, dim=1)       # (steps, 128, 1, V)
    rows, got = [], {}
    for shape, control in SERVE_RUNS:
        mesh = make_fed_mesh(shape, axis_names=("data", "model"))
        dec = build_decode_step(arch, "decode_32k", mesh)
        (p_spec, st_spec, tok_spec), _ = dec.specs(B)
        p_loc = local_blocks(params, p_spec, mesh, copy=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st = dec.init_state(B, M, dev)
        off = cs.rank_offsets(mesh, st_spec["caches"]["k"],
                              st["caches"]["k"].shape)
        cs.fill_kv(torch, st["caches"], SERVE_SEED, row0=off[1], kv0=off[3],
                   kv_heads=cfg.n_kv_heads, block=DECODE_BLOCK)
        st["index"].fill_(DECODE_START)
        tok = local_blocks(toks, tok_spec, mesh).to(dev)
        walls, err, scale, bitwise = [], 0.0, 0.0, shape[1] == 1
        got[shape, control] = []
        with partials_rounded() if control else contextlib.nullcontext():
            for t in range(DECODE_STEPS):
                (lg, st), ms = _sync_ms(torch, lambda: dec.fn(
                    p_loc, st, tok[:, t:t + 1]))
                walls.append(ms)
                if shape[1] == 1:
                    bitwise &= bool(torch.equal(lg, ref[t]))
                full = dec.gather(lg, B)
                got[shape, control].append(full[r0:r0 + half].clone())
                e, sc = _rel_err(torch, full, full_ref[t])
                err, scale = max(err, e), max(scale, sc)
                del full
        rows.append(dict(cell="decode_32k_fault_control" if control
                         else "decode_32k", arch=SERVE_ARCH,
                         mesh_shape=list(shape), rank=world.rank, batch=B,
                         steps=DECODE_STEPS, start_index=DECODE_START,
                         cache_shape=list(st["caches"]["k"].shape),
                         ms_per_step=walls,
                         ms_per_step_median=sorted(walls)[DECODE_STEPS // 2],
                         one_card_ms_per_step=ref_ms,
                         one_card_ms_median=sorted(ref_ms)[DECODE_STEPS // 2],
                         one_card_batch=DECODE_BLOCK,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         one_card_peak_gb=ref_peak / 1e9,
                         one_card_reblocked_max_rel_err=floor,
                         max_rel_err=err, logit_scale=scale,
                         bitwise_one_card=bitwise if shape[1] == 1 else None))
        del st, p_loc
    torch.cuda.empty_cache()
    # each bf16 program against the float32 decode of the same weights and
    # cache on the rank's first 16 rows (a 34.4 GB float32 cache): how far
    # bf16 itself is from the function, beside how far the meshes are from
    # one card
    truth = _decode_f32(torch, cs, cfg, params, r0, half, M,
                        mine[:half], dev)
    for row in rows:
        key = (tuple(row["mesh_shape"]), row["cell"] != "decode_32k")
        row["mesh_vs_f32_max_rel_err"] = max(
            _rel_err(torch, g, w)[0] for g, w in zip(got[key], truth))
        row["one_card_vs_f32_max_rel_err"] = max(
            _rel_err(torch, ref[t, :half], w)[0]
            for t, w in enumerate(truth))
        row["f32_rows"] = half
    del params, got, truth
    torch.cuda.empty_cache()
    return rows


def _decode_f32(torch, cs, cfg, params, r0: int, rows: int, M: int, toks,
                dev) -> list:
    """The float32 decode of ``rows`` rows from ``r0``: the bf16 weights
    cast in place (the caller's tree is float32 after), the bf16 cache
    drawn as the bf16 programs' and cast; each step's logits."""
    from repro_torch.models import transformer
    f32 = cfg.replace(dtype="float32")
    _leaves_to_f32(torch, params)
    st = transformer.init_decode_state(f32, rows, M, dev)
    draw = transformer.init_decode_state(cfg, rows, M, dev)["caches"]
    cs.fill_kv(torch, draw, SERVE_SEED, row0=r0, kv_heads=cfg.n_kv_heads,
               block=DECODE_BLOCK)
    for name in ("k", "v"):
        st["caches"][name].copy_(draw[name])
    del draw
    st["index"].fill_(DECODE_START)
    out = []
    for t in range(DECODE_STEPS):
        lg, st = transformer.decode_step(f32, params, st, toks[:, t:t + 1])
        out.append(lg)
    del st
    return out


def prefill_cell(torch, cs, world, dev):
    """prefill_32k at 32 x 32,768: each rank's 8 rows on the one-card
    program first, then the three meshes."""
    from repro_torch import random as jr
    from repro_torch.configs import INPUT_SHAPES, get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import transformer
    from repro_torch.sharding.rules import local_blocks

    arch = get_arch(SERVE_ARCH)
    cfg = arch.model
    B = INPUT_SHAPES["prefill_32k"]["global_batch"]
    S = INPUT_SHAPES["prefill_32k"]["seq_len"]
    params = transformer.init_params(cfg, jr.PRNGKey(SERVE_SEED, device=dev),
                                     dev)
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(
                               SERVE_SEED + 1), dtype=torch.int32)
    one, _ = build_prefill_step(arch, "prefill_32k")
    r0 = world.rank * PREFILL_BLOCK
    mine = {"tokens": tokens[r0:r0 + PREFILL_BLOCK].to(dev)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ref, ref_ms = _sync_ms(torch, lambda: one(params, mine))
    ref_peak = torch.cuda.max_memory_allocated()
    half = PREFILL_BLOCK // 2                     # the floor, as decode's
    floor = max(_rel_err(torch, one(params, {
        "tokens": mine["tokens"][h * half:(h + 1) * half]}),
        ref[h * half:(h + 1) * half])[0] for h in range(2))
    full_ref = world.all_gather(ref, dim=0)       # (32, 1, V)
    rows = []
    for shape in SERVE_MESHES:
        mesh = make_fed_mesh(shape, axis_names=("data", "model"))
        pre = build_prefill_step(arch, "prefill_32k", mesh)
        (p_spec, b_spec), _ = pre.specs(B)
        p_loc = local_blocks(params, p_spec, mesh, copy=True)
        b_loc = {"tokens": local_blocks({"tokens": tokens}, b_spec,
                                        mesh)["tokens"].to(dev)}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        lg, ms = _sync_ms(torch, lambda: pre.fn(p_loc, b_loc))
        launches = flash_attention.launches
        bitwise = bool(torch.equal(lg, ref)) if shape[1] == 1 else None
        err, scale = _rel_err(torch, pre.gather(lg, B), full_ref)
        rows.append(dict(cell="prefill_32k", arch=SERVE_ARCH,
                         mesh_shape=list(shape), rank=world.rank,
                         layers=cfg.n_layers, batch=B,
                         seq_len=S, local_batch=list(b_loc["tokens"].shape),
                         flash_launches=launches, wall_ms=ms,
                         one_card_rows=PREFILL_BLOCK, one_card_wall_ms=ref_ms,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         one_card_peak_gb=ref_peak / 1e9,
                         one_card_reblocked_max_rel_err=floor,
                         max_rel_err=err, logit_scale=scale,
                         bitwise_one_card=bitwise))
        del p_loc, b_loc, lg
    del params
    torch.cuda.empty_cache()
    return rows


def qwen_cell(torch, cs, world, dev):
    """qwen3-14b at full depth: the one-card prefill on rank 0, then
    (1, 4) over the group and (1, 2) over ranks 0 and 1."""
    import torch.distributed as dist
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import ClientMesh, FedMesh, make_fed_mesh
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import transformer
    from repro_torch.sharding.rules import local_blocks

    arch = get_arch(QWEN_ARCH)
    cfg = arch.model
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, jr.PRNGKey(SERVE_SEED, device=dev),
                                     dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab, (1, QWEN_SEQ),
                           generator=torch.Generator().manual_seed(
                               SERVE_SEED + 2), dtype=torch.int32)
    batch = {"tokens": tokens.to(dev)}
    ref = torch.empty((1, 1, cfg.vocab), dtype=cfg.torch_dtype, device=dev)
    ref_ms = []
    if world.rank == 0:
        one, _ = build_prefill_step(arch, "prefill_32k")
        for _ in range(3):
            out, ms = _sync_ms(torch, lambda: one(params, batch))
            ref_ms.append(ms)
        ref.copy_(out)
        del out
    dist.broadcast(ref, src=0)
    pair = dist.new_group([0, 1])               # every rank makes it
    rows, got = [], {}
    for shape, control in QWEN_RUNS:
        if shape == (1, 2):
            if world.rank > 1:
                continue
            mesh = FedMesh(axes=(ClientMesh(axis="data"), ClientMesh(
                rank=world.rank, size=2, axis="model", group=pair,
                backend="nccl", ranks=(0, 1))), rank=world.rank,
                backend="nccl")
        else:
            mesh = make_fed_mesh(shape, axis_names=("data", "model"))
        pre = build_prefill_step(arch, "prefill_32k", mesh)
        (p_spec, _), _ = pre.specs(1)
        p_loc = local_blocks(params, p_spec, mesh, copy=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        flash_attention.launches = 0
        with partials_rounded() if control else contextlib.nullcontext():
            for _ in range(3):
                lg, ms = _sync_ms(torch, lambda: pre.fn(p_loc, batch))
                walls.append(ms)
        launches = flash_attention.launches // 3
        got[shape, control] = pre.gather(lg, 1)
        err, scale = _rel_err(torch, got[shape, control], ref)
        rows.append(dict(cell=f"{QWEN_ARCH}_fault_control" if control
                         else QWEN_ARCH, arch=QWEN_ARCH,
                         mesh_shape=list(shape), rank=world.rank,
                         layers=cfg.n_layers, batch=1, seq_len=QWEN_SEQ,
                         init_params_s=init_s, flash_launches=launches,
                         wall_ms_runs=walls, wall_ms_median=sorted(walls)[1],
                         one_card_wall_ms_runs=ref_ms,
                         one_card_wall_ms_median=(sorted(ref_ms)[1]
                                                  if ref_ms else None),
                         param_gb_per_rank=sum(
                             x.numel() * x.element_size()
                             for x in cs.tree_leaves(p_loc)) / 1e9,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         max_rel_err=err, logit_scale=scale))
        del p_loc, lg
        torch.cuda.empty_cache()
    if world.rank == 0:
        # both bf16 programs against the float32 prefill of the same
        # weights (59 GB, cast leaf by leaf in place)
        _leaves_to_f32(torch, params)
        truth = transformer.prefill(cfg.replace(dtype="float32"), params,
                                    batch)
        for row in rows:
            key = (tuple(row["mesh_shape"]), row["cell"] != QWEN_ARCH)
            row["mesh_vs_f32_max_rel_err"] = _rel_err(torch, got[key],
                                                      truth)[0]
            row["one_card_vs_f32_max_rel_err"] = _rel_err(torch, ref,
                                                          truth)[0]
        del truth
    del params, got
    torch.cuda.empty_cache()
    return rows


def _leaves_to_f32(torch, tree) -> None:
    """Every leaf of a nested dict cast to float32 in place, one at a
    time (the bf16 leaf freed as its copy is made)."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            _leaves_to_f32(torch, tree[k])
        else:
            tree[k] = tree[k].float()


def serve_rank(world, cells):
    """One NCCL rank of the serving cells (``world``: the 1-D mesh over
    the group): each cell's rows, or the reason it could not run."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    dev = torch.device("cuda", world.rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = {"decode": decode_cell, "prefill": prefill_cell,
           "qwen": qwen_cell}
    out = []
    for name in cells:
        try:
            out.extend(fns[name](torch, cs, world, dev))
        except torch.cuda.OutOfMemoryError as e:   # reported, then fails
            out.append(dict(cell=name, rank=world.rank, error=str(e)[:400]))
            torch.cuda.empty_cache()
    return out


def serve_cells(torch, cs) -> bool:
    """The serving cells over 4 NCCL ranks; one JSON line a (cell, mesh)
    with every rank's numbers beside each other."""
    from repro_torch.launch.mesh import spawn_ranks
    if torch.cuda.device_count() < 4:
        cs.emit(dict(cell="serve", error=f"needs 4 cards, found "
                     f"{torch.cuda.device_count()}"))
        return False
    t0 = time.perf_counter()
    ranks = spawn_ranks(serve_rank, 4, list(SERVE_CELLS), backend="nccl",
                        threads=2)
    wall = time.perf_counter() - t0
    ok = True
    groups = {}
    for rows in ranks:
        for row in rows:
            groups.setdefault((row["cell"], tuple(row.get("mesh_shape",
                                                          ()))), []
                              ).append(row)
    for (cell, shape), rows in groups.items():
        rows.sort(key=lambda r: r["rank"])
        if any("error" in r for r in rows):
            cs.emit(dict(cell=cell, errors=[r.get("error") for r in rows]))
            ok = False
            continue
        line = dict(cell=cell, mesh_shape=list(shape), backend="nccl",
                    ranks=[r["rank"] for r in rows])
        for k in rows[0]:
            if k in ("cell", "mesh_shape", "rank"):
                continue
            vals = [r.get(k) for r in rows]
            line[k] = vals[0] if all(v == vals[0] for v in vals) else vals
        err = max(r["max_rel_err"] for r in rows)
        bit = [r.get("bitwise_one_card") for r in rows]
        if "one_card_vs_f32_max_rel_err" in rows[0]:
            # decode and qwen3-14b: held to the float32 run of the same
            # rows, beside the one card's distance from it
            mesh_f32 = max(r["mesh_vs_f32_max_rel_err"] for r in rows
                           if r.get("mesh_vs_f32_max_rel_err") is not None)
            card_f32 = max(r["one_card_vs_f32_max_rel_err"] for r in rows
                           if r.get("one_card_vs_f32_max_rel_err")
                           is not None)
            line["f32_ratio"] = (mesh_f32 / card_f32 if card_f32 else
                                 0.0 if mesh_f32 == 0 else math.inf)
            line["f32_ratio_limit"] = SERVE_F32_RATIO
            cell_ok = line["f32_ratio"] <= SERVE_F32_RATIO
        else:
            line["tol"] = SERVE_TOL
            cell_ok = err <= SERVE_TOL
        if shape[1:] == (1,):
            cell_ok &= all(b is True for b in bit)
        if cell == "decode_32k":
            med = max(r["ms_per_step_median"] for r in rows)
            line["tokens_per_s"] = rows[0]["batch"] / (med / 1e3)
            line["one_card_tokens_per_s"] = DECODE_BLOCK / (
                rows[0]["one_card_ms_median"] / 1e3)
        if "flash_launches" in rows[0]:
            cell_ok &= all(r["flash_launches"] == r["layers"] for r in rows)
        floors = [r["one_card_reblocked_max_rel_err"] for r in rows
                  if "one_card_reblocked_max_rel_err" in r]
        if floors:      # reported beside the limit, not held
            line["within_one_card_floor"] = err <= max(floors)
        if cell.endswith("_fault_control"):
            # not held: whether the limit tells the fault from the program
            line["caught"] = not cell_ok
            cs.emit(line)
            continue
        line["ok"] = cell_ok
        cs.emit(line)
        ok &= cell_ok
    want = {("decode_32k", s) for s in SERVE_MESHES} | {
        ("prefill_32k", s) for s in SERVE_MESHES} | {
        (QWEN_ARCH, s) for s in QWEN_MESHES} | {
        ("decode_32k_fault_control", (1, 4)),
        (f"{QWEN_ARCH}_fault_control", (1, 4))}
    missing = sorted(want - set(groups))
    cs.emit(dict(cell="serve_summary", spawn_wall_s=wall,
                 missing=[list(m) for m in missing]))
    return ok and not missing


if __name__ == "__main__":
    sys.exit(main(sys.argv))
