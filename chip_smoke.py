#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # where the main path's time goes

Drives ``repro_torch`` only (no JAX, nothing of the JAX package ``repro``):

1. ``build``     compiles every CUDA kernel of the main path from
                 ``src/repro_torch/kernels/csrc`` (one nvcc each, in
                 parallel) and reads the card's name and power limit;
2. ``fed_select`` holds the selection kernel against its plain PyTorch
                 version at N = 100, 2^20 and 1,000,003, a heavy-tie case
                 and the edges (k = 0, k >= |avail|, nobody available), in
                 all four weight modes and mask-only: mask, new_r and the
                 unbiased / unbiased_frozen / uniform weights must match
                 bit for bit; fedavg weights within rtol 1e-5;
3. ``fed_aggregate`` holds the aggregation kernel against its plain
                 version at (10, 610) float32, (10, 2^24) float32 and
                 (10, 2^24 + 3) bfloat16: every lane within
                 ``ref.fed_aggregate_err_bound`` (float32 accumulation in
                 any order plus one step of the output dtype, which a
                 bfloat16 sum breaks), and within the tolerances of the JAX
                 package's kernel tests (float32 2e-5, bf16 2e-2);
4. ``timing``    median of CUDA-event times (>= 20 runs after warm-up) of
                 each kernel, its plain version and, where one exists, a
                 library call computing the same function, beside the
                 bound (bytes moved over 3.35 TB/s);
5. ``main_path`` runs ``run_spec(RunSpec(), device="cuda")`` — the default
                 F3AST cell, 300 rounds — with the launch counts set to 0
                 just before, checks that each kernel was launched once a
                 round, and holds the run against the port's own CPU run of
                 the same spec: masks, K_t, |avail| and final r_k bitwise,
                 train loss and delta norm within 1e-4.

Each phase prints one JSON line; any failure raises (exit status != 0).
The last three lines are the card's name and power limit as nvidia-smi
reports them, the kernels summary, and ``{"ok": true, "device": ...}``.
``--profile`` runs only the build and a profiled window of the main path
(no checks, no ``ok`` line).
TF32 is off for matmuls and cuDNN throughout.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12                  # H100 SXM float32, non-tensor-core
AGG_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOSS_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float = 0.0):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, *, warmup: int = 5, runs: int = 25) -> float:
    """Median over ``runs`` of CUDA-event time of one call, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# fed_select
# ---------------------------------------------------------------------------

def select_case(n: int, seed: int, *, ties: bool = False, q: float = 0.5):
    import numpy as np
    rng = np.random.default_rng(seed)
    if ties:   # 8 score levels, with both zeros present
        levels = np.array([-1.5, -0.0, 0.0, 0.25, 0.5, 1.0, 2.0, 3.0],
                          np.float32)
        scores = levels[rng.integers(0, 8, n)]
    else:
        scores = rng.normal(size=n).astype(np.float32)
    avail = rng.random(n) < q
    r = rng.random(n).astype(np.float32)
    p = (rng.random(n) / n).astype(np.float32)
    rw = (rng.random(n) * 0.9 + 0.05).astype(np.float32)
    return scores, avail, r, p, rw


def check_fed_select(torch, dev, beta: float = 1e-3):
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_select import fed_select, fed_select_mask

    cases = [("n100_main", 100, 0, dict(q=0.2), 10),
             ("n2^20", 1 << 20, 1, {}, 1000),
             ("n1000003", 1_000_003, 2, {}, 12345),
             ("ties_n2^20", 1 << 20, 3, dict(ties=True), 100_000),
             ("k0", 4096, 4, {}, 0),
             ("k_ge_avail", 4096, 5, {}, 4096),
             ("none_avail", 4096, 6, dict(q=0.0), 17)]
    results = []
    addcmul_fuses = True
    for name, n, seed, kw, k in cases:
        scores, avail, r, p, rw = select_case(n, seed, **kw)
        cpu = [torch.from_numpy(x) for x in (scores, avail, r, p, rw)]
        gpu = [x.to(dev) for x in cpu]
        k_dev = torch.full((), k, dtype=torch.int32, device=dev)
        row = dict(case=name, n=n, k=k, n_avail=int(avail.sum()))
        m_k = fed_select_mask(gpu[0], gpu[1], k_dev)
        m_cpu = ref.topk_threshold_mask(cpu[0], cpu[1],
                                        torch.tensor(k, dtype=torch.int32))
        row["mask_only_mismatch"] = int((m_k.cpu() != m_cpu).sum())
        if int(m_k.sum()) != min(k, int(avail.sum())):
            raise AssertionError(f"{name}: |S| != min(k, |avail|)")
        for mode in ref.SELECT_WEIGHT_MODES:
            rwt = gpu[4] if mode == "unbiased_frozen" else None
            got = fed_select(gpu[0], gpu[1], k_dev, gpu[2], gpu[3], beta,
                             weight_mode=mode, r_weight=rwt)
            # the plain version on the same inputs, on the CPU (bitwise the
            # JAX package's) and on the card
            want = ref.fed_select_ref(
                cpu[0], cpu[1], torch.tensor(k, dtype=torch.int32), cpu[2],
                cpu[3], beta, weight_mode=mode,
                r_weight=cpu[4] if rwt is not None else None)
            plain_dev = ref.fed_select_ref(gpu[0], gpu[1], k_dev, gpu[2],
                                           gpu[3], beta, weight_mode=mode,
                                           r_weight=rwt)
            g = [x.cpu() for x in got]
            mm = {f: int((a.numpy().view(np.uint8 if a.dtype == torch.bool
                                         else np.uint32)
                          != b.numpy().view(np.uint8 if b.dtype == torch.bool
                                            else np.uint32)).sum())
                  for f, a, b in zip(("mask", "new_r", "w"), g, want)}
            plain_newr = int((plain_dev[1].cpu().numpy().view(np.uint32)
                              != want[1].numpy().view(np.uint32)).sum())
            addcmul_fuses &= plain_newr == 0
            row.setdefault("max_abs_err", {})[mode] = max(
                float((g[1] - want[1]).abs().max()),
                float((g[2] - want[2]).abs().max()))
            # mismatching lanes: [mask, new_r, w]
            row.setdefault("mismatch", {})[mode] = [mm["mask"], mm["new_r"],
                                                    mm["w"]]
            row["plain_on_card_new_r_mismatch"] = (
                row.get("plain_on_card_new_r_mismatch", 0) + plain_newr)
            bitwise = ["mask", "new_r"] + (["w"] if mode != "fedavg" else [])
            if any(mm[f] for f in bitwise) or row["mask_only_mismatch"]:
                raise AssertionError(f"fed_select {name} {mode}: {mm}")
            if mode == "fedavg":
                rel = float(((g[2] - want[2]).abs()
                             / want[2].abs().clamp_min(1e-30)).max())
                row["fedavg_max_rel_err"] = rel
                if rel > 1e-5:
                    raise AssertionError(f"fedavg rel err {rel}")
        results.append(row)
    emit(dict(phase="fed_select", cases=results,
              cuda_addcmul_matches_fma=addcmul_fuses))
    # the kernels line names the timed case: N = 2^20, unbiased weights
    return next(row["max_abs_err"]["unbiased"] for row in results
                if row["case"] == "n2^20")


# ---------------------------------------------------------------------------
# fed_aggregate
# ---------------------------------------------------------------------------

def check_fed_aggregate(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_aggregate import fed_aggregate

    shapes = [(10, 610, torch.float32), (10, 1 << 24, torch.float32),
              (10, (1 << 24) + 3, torch.bfloat16)]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, err_at = [], {}
    for k, d, dtype in shapes:
        v = torch.randn(k, d, generator=gen, device=dev).to(dtype)
        w = torch.rand(k, generator=gen, device=dev)
        got = fed_aggregate(v, w)
        want = ref.fed_aggregate_ref(v, w)
        over = int(((got.float() - want.float()).abs()
                    > ref.fed_aggregate_err_bound(v, w, got, want)).sum())
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        tol = AGG_TOL[str(dtype).split(".")[-1]]
        ok = over == 0 and bool(torch.allclose(got, want, rtol=tol, atol=tol))
        rows.append(dict(shape=[k, d], dtype=str(dtype), max_abs_err=err,
                         lanes_over_bound=over, tol=tol, ok=ok))
        err_at[(k, d, dtype)] = err
        if not ok:
            raise AssertionError(f"fed_aggregate {k}x{d} {dtype}: {err}, "
                                 f"{over} lanes over the bound")
        del v, got, want
    emit(dict(phase="fed_aggregate", checks=rows))
    # the kernels line names the timed float32 shape; report its error
    return err_at[(10, 1 << 24, torch.float32)]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_kernels(torch, dev, beta: float = 1e-3):
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_aggregate import fed_aggregate
    from repro_torch.kernels.fed_select import fed_select

    out = {}
    for n in (100, 1 << 20):
        scores, avail, r, p, _ = (torch.from_numpy(x).to(dev)
                                  for x in select_case(n, 7, q=0.2))
        k = torch.full((), 10 if n == 100 else 1000, dtype=torch.int32,
                       device=dev)
        # bytes: scores 4 + avail 1 + r 4 + p 4 read, mask 1 + new_r 4 +
        # w 4 written, per client; plus the budget k
        nbytes = 22 * n + 4
        b, by = bound_ms(nbytes)
        out[f"fed_select_n{n}"] = dict(
            ms=cuda_ms(lambda: fed_select(scores, avail, k, r, p, beta)),
            plain_ms=cuda_ms(lambda: ref.fed_select_ref(scores, avail, k,
                                                        r, p, beta)),
            bound_ms=b, bound_by=by, bytes=nbytes, library_ms=None)
    for k_rows, d in ((10, 610), (10, 1 << 24)):
        gen = torch.Generator(device=dev).manual_seed(1)
        v = torch.randn(k_rows, d, generator=gen, device=dev)
        w = torch.rand(k_rows, generator=gen, device=dev)
        # bytes: deltas read once, weights read once, output written once
        nbytes = 4 * (k_rows * d + k_rows + d)
        b, by = bound_ms(nbytes, flops=2.0 * k_rows * d)
        out[f"fed_aggregate_{k_rows}x{d}"] = dict(
            ms=cuda_ms(lambda: fed_aggregate(v, w)),
            plain_ms=cuda_ms(lambda: ref.fed_aggregate_ref(v, w)),
            library_ms=cuda_ms(lambda: w @ v),
            bound_ms=b, bound_by=by, bytes=nbytes)
        del v
    emit(dict(phase="timing", kernels=out))
    return out


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def main_path(torch, dev):
    import numpy as np
    from repro_torch.kernels.fed_aggregate import fed_aggregate
    from repro_torch.kernels.fed_select import fed_select, fed_select_mask
    from repro_torch.sim import RunSpec, run_spec

    spec = RunSpec()
    fed_select.launches = fed_select_mask.launches = 0
    fed_aggregate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_spec(spec, device=dev, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fed_select=fed_select.launches,
                    fed_select_mask=fed_select_mask.launches,
                    fed_aggregate=fed_aggregate.launches)
    rounds = res.sel_history.shape[0]
    if launches["fed_select"] != rounds or launches["fed_aggregate"] != rounds:
        raise AssertionError(f"launches {launches} over {rounds} rounds")
    if not (np.isfinite(res.train_loss).all()
            and np.isfinite(res.delta_norm).all()):
        raise AssertionError("non-finite losses on the card")
    t0 = time.perf_counter()
    ref_run = run_spec(spec, device="cpu", log_fn=lambda *a: None)
    cpu_wall = time.perf_counter() - t0
    bitwise = {
        "sel_mask": res.sel_history.tobytes() == ref_run.sel_history.tobytes(),
        "completed": (res.comp_history.tobytes()
                      == ref_run.comp_history.tobytes()),
        "k_t": res.k_t.tobytes() == ref_run.k_t.tobytes(),
        "n_available": (res.n_available.tobytes()
                        == ref_run.n_available.tobytes()),
        "final_r": res.rates.tobytes() == ref_run.rates.tobytes(),
    }
    loss_err = float(np.abs(res.train_loss - ref_run.train_loss).max())
    dnorm_err = float(np.abs(res.delta_norm - ref_run.delta_norm).max())
    fm = res.final_metrics
    row = dict(phase="main_path", rounds=rounds, launches=launches,
               bitwise_vs_cpu=bitwise, train_loss_max_abs_err=loss_err,
               delta_norm_max_abs_err=dnorm_err, wall_s=wall,
               steady_rounds_per_s=fm.get("steady_rounds_per_s"),
               steady_round_ms=(1e3 / fm["steady_rounds_per_s"]
                                if fm.get("steady_rounds_per_s") else None),
               test_acc=fm["test_acc"], cpu_test_acc=
               ref_run.final_metrics["test_acc"], cpu_wall_s=cpu_wall)
    emit(row)
    if not all(bitwise.values()) or max(loss_err, dnorm_err) > LOSS_TOL:
        raise AssertionError(f"main path departs from the CPU run: {row}")
    return launches


def profile_main_path(torch, dev, rounds: int = 20):
    """Where the main path's time goes (``--profile``): one torch.profiler
    window over ``rounds`` steady rounds of the default cell, after 10
    warm-up rounds; the idle share is kernel time over wall time of that
    same window.  The round time of an unprofiled window of as many rounds
    is printed beside it, for the profiler's own cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as jr
    from repro_torch.sim.engine import build_engine

    engine, _ = build_engine("scarce", "f3ast", device=dev)
    carry = engine.init_carry(jr.PRNGKey(0, device=dev))
    carry, _ = engine.chunk(carry, range(10))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = engine.chunk(carry, range(10, 10 + rounds))
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, _ = engine.chunk(carry, range(10 + rounds, 10 + 2 * rounds))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the profiler mirrors the round/* annotations onto the GPU timeline;
    # those ranges are spans, not kernels
    events = prof.events()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("round/")]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    by_kernel = {}
    for e in dev_events:
        n, us = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    spans = {}
    for e in events:
        if e.name.startswith("round/"):
            side = ("host_ms_per_round" if e.device_type == DeviceType.CPU
                    else "device_span_ms_per_round")
            row = spans.setdefault(e.name, {})
            row[side] = row.get(side, 0.0) + (e.time_range.elapsed_us()
                                              / 1e3 / rounds)
    host_ops = sorted(((e.key, e.count, e.self_cpu_time_total)
                       for e in prof.key_averages()
                       if e.key.startswith("aten::")),
                      key=lambda x: -x[2])[:8]
    emit(dict(phase="profile", rounds=rounds,
              round_ms_unprofiled=1e3 * plain_wall / rounds,
              round_ms_profiled=1e3 * wall / rounds,
              device_launches_per_round=len(dev_events) / rounds,
              device_busy_ms_per_round=busy_us / 1e3 / rounds,
              device_idle_share_profiled=1.0 - busy_us / 1e6 / wall,
              spans=spans,
              top_device_kernels=[dict(name=k[:100], launches=n,
                                       ms_per_round=us / 1e3 / rounds)
                                  for k, (n, us) in top_kernels],
              top_host_ops=[dict(op=k, calls_per_round=c / rounds,
                                 self_ms_per_round=us / 1e3 / rounds)
                            for k, c, us in host_ops]))


def main(argv) -> int:
    if argv[1:] not in ([], ["--profile"]):
        print("usage: chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    from repro_torch.kernels import _build
    gpu = gpu_line()
    t0 = time.perf_counter()
    per_kernel = _build.build()
    emit(dict(phase="build", nvcc_s=time.perf_counter() - t0,
              per_kernel_s=per_kernel, gpu=gpu,
              kind=torch.cuda.get_device_name(0), torch=torch.__version__,
              cuda=torch.version.cuda,
              ptxas={n: [ln.strip() for ln in _build.build_log(n).splitlines()
                         if "registers" in ln or "spill" in ln]
                     for n in _build.SOURCES}))

    if argv[1:] == ["--profile"]:
        profile_main_path(torch, dev)
        return 0
    sel_err = check_fed_select(torch, dev)
    agg_err = check_fed_aggregate(torch, dev)
    timing = time_kernels(torch, dev)
    launches = main_path(torch, dev)

    src = "src/repro_torch/kernels/csrc/"
    t_sel, t_agg = timing["fed_select_n1048576"], timing[
        "fed_aggregate_10x16777216"]
    kernels = [
        dict(name="fed_select", route="cuda", source=src + "fed_select.cu",
             replaces="src/repro/kernels/fed_select.py:168",
             launches=launches["fed_select"], max_abs_err=sel_err,
             shape=[1 << 20], **{k: t_sel[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="fed_aggregate", route="cuda",
             source=src + "fed_aggregate.cu",
             replaces="src/repro/kernels/fed_aggregate.py:75",
             launches=launches["fed_aggregate"], max_abs_err=agg_err,
             shape=[10, 1 << 24], **{k: t_agg[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
    ]
    print(gpu_line(), flush=True)
    emit(dict(kernels=kernels))
    emit(dict(ok=True, device=dict(platform="gpu",
                                   kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
