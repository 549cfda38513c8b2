#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # where the main path's time goes

Drives ``repro_torch`` only (no JAX, nothing of the JAX package ``repro``):

1. ``build``     compiles every CUDA kernel of the main path from
                 ``src/repro_torch/kernels/csrc`` (one nvcc each, in
                 parallel) and reads the card's name and power limit;
2. ``fed_select`` holds the selection kernel against its plain PyTorch
                 version at N = 100, 2^20, 1,000,003 and 2^22, heavy-tie
                 cases, the crossover between its one-block and cooperative
                 paths (N - 1, N, N + 1, and the one-block path's largest N,
                 each also forced through both paths) and the edges (k = 0,
                 k = 1, k >= |avail|, nobody available, everyone available
                 with k = N, a cut on the unavailable clients' -1e30), in all four weight modes and mask-only: mask,
                 new_r and the unbiased / unbiased_frozen / uniform weights
                 must match bit for bit; fedavg weights within rtol 1e-5;
                 and a torch.profiler trace of single calls on each path
                 must show exactly one device kernel a call;
3. ``fed_aggregate`` holds the aggregation kernel against its plain
                 version at (10, 610) float32, (10, 2^24) float32 and
                 (10, 2^24 + 3) bfloat16: every lane within
                 ``ref.fed_aggregate_err_bound`` (float32 accumulation in
                 any order plus one step of the output dtype, which a
                 bfloat16 sum breaks), and within the tolerances of the JAX
                 package's kernel tests (float32 2e-5, bf16 2e-2);
4. ``timing``    median of CUDA-event times (>= 20 runs after warm-up) of
                 each kernel (fed_select in both modes at N = 100 and
                 2^20), its plain version and, where one exists, a
                 library call computing the same function, beside the
                 bound (bytes moved over 3.35 TB/s); ``torch.topk`` at
                 N = 2^20, k = 1000, as context only (not the same
                 function);
5. ``main_path`` runs ``run_spec(RunSpec(), device="cuda")`` — the default
                 F3AST cell, 300 rounds — with the launch counts set to 0
                 just before, checks that each kernel was launched once a
                 round, and holds the run against the port's own CPU run of
                 the same spec: masks, K_t, |avail| and final r_k bitwise,
                 train loss and delta norm within 1e-4;
6. ``init``      the card's ``init_params`` of the llama and mamba2 smoke
                 configs (float32 and bfloat16, two seeds) is bitwise
                 the CPU's, which the CPU tests hold to JAX's (A_log within
                 an ulp), and ``random.normal`` over 2^20 lanes is bitwise;
7. ``flash_attention`` holds the attention kernel against its plain
                 version (``ref.sdpa``) at the four shapes of the JAX
                 package's kernel tests in float32 and bf16, each causal,
                 causal with window 128, non-causal and causal with soft-cap
                 30, plus llama3.2-1b's prefill shape (1, 8192, 32 heads,
                 8 KV heads, 64) causal in bf16 and float32 and a ragged
                 (2, 1000, 32, 8, 64) in every mode: within 2e-5 (float32)
                 and 2e-2 (bf16), the tolerances of
                 ``test_flash_attention_allclose``, and every bf16 lane
                 within one bf16 step of the plain output (2^-7 of its
                 magnitude + 1e-5: both round one float32 result once),
                 which at llama's shape, where outputs are ~0.02, is the
                 check that binds; plus bf16 cases through the tensor-core
                 route at hd = 128, (1, 4096, 32, 8, 128) causal and with a
                 window of 32 (smaller than a key tile), and llama's shape
                 with that window; it reports each reference's RMS;
8. ``flash_timing`` median CUDA-event times of the kernel (its bf16 route,
                 on the tensor cores, and its float32 route, on the CUDA
                 cores), its plain version and
                 ``scaled_dot_product_attention`` at llama's prefill shape,
                 beside the bound (the larger of bytes over 3.35 TB/s and
                 the unmasked QK^T + PV flops over 989 TFLOP/s bf16), the
                 bf16 route's TFLOP/s and its share of the bound;
9. ``serve_path`` drives llama3.2-1b at full width (its ``init_params``
                 timed on the card): (a) one ``prefill``
                 of B = 1, S = 8192 (16 layers, bf16) with the launch count
                 set to 0 just before, which must launch the kernel exactly
                 16 times and give finite logits, then its wall time
                 (median of 3 after that warm-up) and a profiled run for the
                 kernel's share; (b) ``serve(..., smoke=False)`` at its
                 defaults (batch 4, prompt 16, 32 steps), which must launch
                 no flash kernel; (c) at depth 2 in float32, B = 1,
                 S = 512, the card's prefill (kernel) within 1e-4 of the
                 CPU's (plain) on the same weights; (d) at depth 2 in
                 float32, S = 128, the card's prefill within 2e-3 of
                 stepping the same prompt through ``decode_step`` (the
                 limit of ``tests/test_models_consistency.py``);
10. ``ssd_chunk`` holds the Mamba-2 SSD kernel against its plain version
                 (``ref.ssd_chunk_ref``) in float32 (the CUDA-core route)
                 and with bf16 x, Bm, Cm (the tensor-core route) at the
                 three shapes of the JAX package's kernel test, the smoke
                 config's, the ssm consistency case's, mamba2-2.7b's
                 prefill layer (1, 64 chunks, 128, 80 heads, 64), N = 128,
                 a B = 2 case and x as the strided view the model passes:
                 y and states within 1e-4, decays within 1e-5 / 1e-6 (the
                 limits of ``test_ssd_chunk_allclose``), reporting each
                 reference's RMS and the worst lane's share of its limit;
                 whether the card's ``torch.cumsum`` (the plain version's
                 cum) is the kernel's left-to-right float32 sum; and the
                 composed ``ssd`` (kernel plus torch recurrence) within
                 1e-4 of ``ref.ssd_ref`` at the layer shape;
11. ``ssd_timing`` median CUDA-event times of the kernel (its bf16 route, on
                 the tensor cores, and its float32 route, on the CUDA
                 cores) and its plain version at the layer shape, beside
                 the bound (bytes over 3.35 TB/s; the operations needed,
                 over 989 TFLOP/s bf16) and the bf16 route's share of it;
                 no single PyTorch call computes it;
12. ``mamba_path`` drives mamba2-2.7b at full width after llama's weights
                 are freed (its ``init_params`` timed on the card): (a) one
                 ``prefill`` of B = 1, S = 8192 (64
                 layers, bf16) with the launch count set to 0 just before,
                 which must launch the kernel exactly 64 times and give
                 finite (1, 1, 50280) logits, then the median of 3 and a
                 profiled run, whose ssd kernels must all be the
                 tensor-core route's (``ssd_chunk_kernel_mma``); (b) one
                 prefill at S = 32,768 (64 launches, finite); (c)
                 ``serve(..., smoke=False)`` at its defaults, which must
                 launch no ssd_chunk; (d) at depth 2 in float32,
                 S = 512, the card's prefill within 1e-4 of the CPU's; (e)
                 at depth 2 in float32, S = 128, prefill within 2e-3 of
                 stepping the prompt through ``decode_step``.

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
BF16_FLOPS = 989e12                 # H100 SXM bf16 tensor cores, dense
AGG_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# test_ssd_chunk_allclose: (rtol, atol) for y, states, decays
SSD_TOL = ((1e-4, 1e-4), (1e-4, 1e-4), (1e-5, 1e-6))
ATTN_TOL = AGG_TOL                  # test_flash_attention_allclose
# Kernel and plain version both compute in float32 and round once to bf16,
# so a bf16 output may differ by one bf16 step (8 significant bits: at most
# 2^-7 of its magnitude) plus what float32 summation order moves near zero.
BF16_STEP = 2.0 ** -7
BF16_STEP_ATOL = 1e-5
LOSS_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float = 0.0, peak: float = FP32_FLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
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

def select_case(n: int, seed: int, *, ties: bool = False, q: float = 0.5,
                sentinel: bool = False):
    import numpy as np
    rng = np.random.default_rng(seed)
    if ties:   # 8 score levels, with both zeros present
        levels = np.array([-1.5, -0.0, 0.0, 0.25, 0.5, 1.0, 2.0, 3.0],
                          np.float32)
        scores = levels[rng.integers(0, 8, n)]
    else:
        scores = rng.normal(size=n).astype(np.float32)
    if sentinel:   # available clients at the unavailable value and below
        scores[rng.random(n) < 0.1] = np.float32(-1e30)
        scores[rng.random(n) < 0.05] = -np.inf
    avail = rng.random(n) < q
    r = rng.random(n).astype(np.float32)
    p = (rng.random(n) / n).astype(np.float32)
    rw = (rng.random(n) * 0.9 + 0.05).astype(np.float32)
    return scores, avail, r, p, rw


def check_fed_select(torch, dev, beta: float = 1e-3):
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_select import fed_select, fed_select_mask

    from repro_torch.kernels import _build
    lib = _build.load("fed_select")
    small_max, small_cap = lib.fed_select_small_max(), lib.fed_select_small_cap()
    # with half the clients available, k = 0.7 |avail| of the tie levels
    # puts the cut among the zeros (-0.0 and +0.0 must tie)
    cases = [("n100_main", 100, 0, dict(q=0.2), 10),
             ("n2^20", 1 << 20, 1, {}, 1000),
             ("n1000003", 1_000_003, 2, {}, 12345),
             ("ties_n2^20", 1 << 20, 3, dict(ties=True), 100_000),
             ("k0", 4096, 4, {}, 0),
             ("k_ge_avail", 4096, 5, {}, 4096),
             ("none_avail", 4096, 6, dict(q=0.0), 17),
             ("crossover-1_ties", small_max - 1, 8, dict(ties=True),
              7 * small_max // 20),
             ("crossover_k1", small_max, 9, {}, 1),
             ("crossover+1_ties", small_max + 1, 10, dict(ties=True),
              7 * small_max // 20),
             ("all_avail_k_n", 5000, 11, dict(q=1.0), 5000),
             ("small_cap_ties", small_cap, 12, dict(ties=True), 5734),
             ("k1_n2^20", 1 << 20, 13, {}, 1),
             ("n2^22", 1 << 22, 14, {}, 50_000),
             # the cut on -1e30, the unavailable clients' value: available
             # clients there tie with them, and the reference leaves the
             # available -inf ones out even at k = N
             ("sentinel_n100", 100, 15, dict(sentinel=True), 100),
             ("sentinel_n2^20", 1 << 20, 16, dict(sentinel=True), 1 << 20),
             ("sentinel_cut_n2^20", 1 << 20, 17, dict(sentinel=True),
              500_000)]
    results = []
    addcmul_fuses = True
    for name, n, seed, kw, k in cases:
        scores, avail, r, p, rw = select_case(n, seed, **kw)
        cpu = [torch.from_numpy(x) for x in (scores, avail, r, p, rw)]
        gpu = [x.to(dev) for x in cpu]
        k_dev = torch.full((), k, dtype=torch.int32, device=dev)
        # by N, and where one block can hold N, through each path forced
        paths = (None, "small", "large") if n <= small_cap else (None,)
        row = dict(case=name, n=n, k=k, n_avail=int(avail.sum()),
                   paths=["by_n" if x is None else x for x in paths])
        m_cpu = ref.topk_threshold_mask(cpu[0], cpu[1],
                                        torch.tensor(k, dtype=torch.int32))
        row["mask_only_mismatch"] = 0
        # |S| = min(k, |avail|), but for the available clients that rank
        # below the unavailable ones' -1e30
        n_sel = (int(m_cpu.sum()) if kw.get("sentinel")
                 else min(k, int(avail.sum())))
        for path in paths:
            m_k = fed_select_mask(gpu[0], gpu[1], k_dev, path=path)
            row["mask_only_mismatch"] += int((m_k.cpu() != m_cpu).sum())
            if int(m_k.sum()) != n_sel:
                raise AssertionError(f"{name}: |S| = {int(m_k.sum())}, "
                                     f"want {n_sel}")
        for mode, path in ((m, x) for m in ref.SELECT_WEIGHT_MODES
                           for x in paths):
            rwt = gpu[4] if mode == "unbiased_frozen" else None
            got = fed_select(gpu[0], gpu[1], k_dev, gpu[2], gpu[3], beta,
                             weight_mode=mode, r_weight=rwt, path=path)
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
                row.get("max_abs_err", {}).get(mode, 0.0),
                float((g[1] - want[1]).abs().max()),
                float((g[2] - want[2]).abs().max()))
            # mismatching lanes over the paths: [mask, new_r, w]
            prev = row.setdefault("mismatch", {}).get(mode, [0, 0, 0])
            row["mismatch"][mode] = [prev[0] + mm["mask"],
                                     prev[1] + mm["new_r"],
                                     prev[2] + mm["w"]]
            row["plain_on_card_new_r_mismatch"] = (
                row.get("plain_on_card_new_r_mismatch", 0) + plain_newr)
            bitwise = ["mask", "new_r"] + (["w"] if mode != "fedavg" else [])
            if any(mm[f] for f in bitwise) or row["mask_only_mismatch"]:
                raise AssertionError(f"fed_select {name} {mode} {path}: {mm}")
            if mode == "fedavg":
                rel = float(((g[2] - want[2]).abs()
                             / want[2].abs().clamp_min(1e-30)).max())
                row["fedavg_max_rel_err"] = max(
                    row.get("fedavg_max_rel_err", 0.0), rel)
                if rel > 1e-5:
                    raise AssertionError(f"fedavg rel err {rel}")
        results.append(row)
        del cpu, gpu
    emit(dict(phase="fed_select", small_max=small_max, small_cap=small_cap,
              cases=results, cuda_addcmul_matches_fma=addcmul_fuses,
              device_kernels_per_call=kernels_per_call(torch, dev, beta)))
    # the kernels line names the timed case: N = 2^20, unbiased weights;
    # the mask-only mode's error is over every case (a bool: 0 or 1)
    return (next(row["max_abs_err"]["unbiased"] for row in results
                 if row["case"] == "n2^20"),
            float(any(row["mask_only_mismatch"] for row in results)))


def kernels_per_call(torch, dev, beta: float, calls: int = 10):
    """Device kernels a call runs, and their device time, from a
    torch.profiler trace of ``calls`` calls (after a warm-up call): fed_select_mask and fed_select (unbiased
    and fedavg) at N = 100 (the one-block path) and N = 2^20 (the
    cooperative one).  Each call must be exactly one kernel, the
    fed_select kernel: no memset, no copy, no second launch.  A trace that
    recorded no device event at all is the profiler's loss, not the
    kernel's (the outputs are checked above): it is taken again, up to
    three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.fed_select import fed_select, fed_select_mask

    out = {}
    for n in (100, 1 << 20):
        scores, avail, r, p, _ = (torch.from_numpy(x).to(dev)
                                  for x in select_case(n, 21))
        k = torch.full((), max(n // 10, 1), dtype=torch.int32, device=dev)
        calls_by_name = {
            "fed_select_mask": lambda: fed_select_mask(scores, avail, k),
            "fed_select_unbiased": lambda: fed_select(scores, avail, k, r, p,
                                                      beta),
            "fed_select_fedavg": lambda: fed_select(
                scores, avail, k, r, p, beta, weight_mode="fedavg")}
        for name, call in calls_by_name.items():
            call()
            torch.cuda.synchronize()
            for attempt in range(3):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(calls):
                        call()
                    torch.cuda.synchronize()
                events = [e for e in prof.events()
                          if e.device_type == DeviceType.CUDA]
                names = [e.name for e in events]
                if names:
                    break
            out[f"{name}_n{n}"] = dict(
                kernels_per_call=len(names) / calls,
                names=sorted(set(names)), traces_taken=attempt + 1,
                device_us_per_call=sum(e.time_range.elapsed_us()
                                       for e in events) / calls)
            if len(names) != calls or any("fed_select_kernel" not in x
                                          for x in names):
                raise AssertionError(f"{name} at N = {n}: device work "
                                     f"{names} over {calls} calls, want one "
                                     f"fed_select kernel a call")
    return out


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
    from repro_torch.kernels.fed_select import fed_select, fed_select_mask

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
        # the mask-only mode (fed_select_mask, the TPU's _mask_pallas):
        # scores 4 + avail 1 read, mask 1 written, per client
        nbytes = 6 * n + 4
        b, by = bound_ms(nbytes)
        out[f"fed_select_mask_n{n}"] = dict(
            ms=cuda_ms(lambda: fed_select_mask(scores, avail, k)),
            plain_ms=cuda_ms(lambda: ref.topk_threshold_mask(scores, avail,
                                                             k)),
            bound_ms=b, bound_by=by, bytes=nbytes, library_ms=None)
        for key in (f"fed_select_n{n}", f"fed_select_mask_n{n}"):
            out[key]["bound_share"] = out[key]["bound_ms"] / out[key]["ms"]
    # context only, not the same function (no stable tie order, no EMA or
    # weights): torch.topk of k = 1000 over the masked scores at N = 2^20,
    # which order the clients as the kernel's keys do
    masked = torch.where(avail, scores, torch.full_like(scores, -1e30))
    out["topk_context_n1048576_k1000_ms"] = cuda_ms(
        lambda: torch.topk(masked, 1000))
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


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

ATTN_MODES = {"causal": dict(causal=True, window=0, softcap=0.0),
              "window128": dict(causal=True, window=128, softcap=0.0),
              "full": dict(causal=False, window=0, softcap=0.0),
              "softcap30": dict(causal=True, window=0, softcap=30.0)}
# (B, S, H, KV, hd): tests/test_kernels.py's _ATTN_SHAPES
TEST_ATTN_SHAPES = [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64),
                    (1, 256, 8, 1, 32), (1, 512, 4, 2, 128)]
LLAMA_ATTN = (1, 8192, 32, 8, 64)   # llama3.2-1b prefill, B = 1, S = 8192
RAGGED_ATTN = (2, 1000, 32, 8, 64)
HD128_ATTN = (1, 4096, 32, 8, 128)  # the largest head dim, two KV tiles a row
# a window smaller than the kernel's 64-key tile: every visited tile is an
# edge tile, and a row's first visited tile can hide all its keys
WINDOW32 = dict(causal=True, window=32, softcap=0.0)


def attn_inputs(torch, dev, shape, dtype, seed):
    B, S, H, KV, hd = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, S, n, hd, generator=gen, device=dev).to(dtype)
            for n in (H, KV, KV)]


def attn_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs: the work these inputs need."""
    import numpy as np
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.maximum(hi - lo + 1, 0).sum())


def check_flash_attention(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    cases = [(shape, dtype, mode) for shape in TEST_ATTN_SHAPES
             for dtype in (torch.float32, torch.bfloat16)
             for mode in ATTN_MODES]
    cases += [(LLAMA_ATTN, dtype, "causal")
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [(RAGGED_ATTN, dtype, mode)
              for dtype in (torch.float32, torch.bfloat16)
              for mode in ATTN_MODES]
    cases += [(HD128_ATTN, torch.bfloat16, "causal"),
              (HD128_ATTN, torch.bfloat16, "window32"),
              (LLAMA_ATTN, torch.bfloat16, "window32")]
    modes = dict(ATTN_MODES, window32=WINDOW32)
    rows, max_err, llama = [], {}, {}
    for i, (shape, dtype, mode) in enumerate(cases):
        q, k, v = attn_inputs(torch, dev, shape, dtype, i)
        got = flash_attention(q, k, v, **modes[mode])
        want = ref.sdpa(q, k, v, **modes[mode])
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        tol = ATTN_TOL[dname]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        rms = float(want.float().square().mean().sqrt())
        ok = (got.dtype == dtype and tuple(got.shape) == tuple(q.shape)
              and bool(torch.isfinite(got).all())
              and bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                      atol=tol)))
        if dtype == torch.bfloat16:
            # the tight check: within one bf16 step of the plain output
            over = diff - BF16_STEP * want.float().abs() - BF16_STEP_ATOL
            ok = ok and float(over.max()) <= 0.0
        rows.append(dict(shape=list(shape), dtype=dname, mode=mode,
                         max_abs_err=err, ref_rms=rms, tol=tol, ok=ok))
        max_err[dname] = max(max_err.get(dname, 0.0), err)
        if shape == LLAMA_ATTN and mode == "causal":
            llama[dname] = dict(max_abs_err=err, ref_rms=rms,
                                err_over_rms=err / rms)
        if not ok:
            raise AssertionError(
                f"flash_attention {shape} {dtype} {mode}: max |err| {err} "
                f"(reference rms {rms}) over {tol}, or a bf16 lane more "
                f"than one step ({BF16_STEP} relative + {BF16_STEP_ATOL}) "
                f"from the plain output")
        del q, k, v, got, want, diff
    emit(dict(phase="flash_attention", checks=rows,
              max_abs_err_by_dtype=max_err, llama_shape=llama))
    return llama["bfloat16"]["max_abs_err"]


def time_flash_attention(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    B, S, H, KV, hd = LLAMA_ATTN
    q, k, v = attn_inputs(torch, dev, LLAMA_ATTN, torch.bfloat16, 100)
    # the library yardstick takes (B, heads, S, hd); its copies are made
    # here, outside the timed calls
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = attn_pairs(S, S, True, 0)
    flops = 4.0 * B * H * hd * pairs          # QK^T and PV, 2 flops a MAC
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)  # q, o, k, v
    b, by = bound_ms(nbytes, flops, peak=BF16_FLOPS)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    row = dict(shape=list(LLAMA_ATTN), dtype="bfloat16", mode="causal",
               ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True),
                          warmup=2, runs=15),
               f32_ms=cuda_ms(lambda: flash_attention(q32, k32, v32,
                                                      causal=True),
                              warmup=1, runs=9),
               plain_ms=cuda_ms(lambda: ref.sdpa(q, k, v, causal=True),
                                warmup=2, runs=9),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
                   warmup=3, runs=15),
               bound_ms=b, bound_by=by, flops=flops, bytes=nbytes)
    row["tflops_per_s"] = flops / row["ms"] / 1e9
    row["bound_share"] = b / row["ms"]
    emit(dict(phase="flash_timing", kernel=row))
    return row


# ---------------------------------------------------------------------------
# init: the model zoo's parameters, card against CPU
# ---------------------------------------------------------------------------

def check_init(torch, dev):
    """The card's ``init_params`` is bitwise the CPU's (which the CPU tests
    hold bitwise to JAX's) for the llama and mamba2 smoke configs, in
    float32 and bfloat16, at two seeds; A_log (not drawn: torch's linspace
    and log) within an ulp.  Plus ``random.normal`` over 2^20 lanes, with
    the count of lanes in erf_inv's second branch (|z| > ~2.75)."""
    import numpy as np
    from repro_torch import random as jr
    from repro_torch import xla_math
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_to_numpy
    from repro_torch.models import transformer

    rows = []
    for arch in ("llama3.2-1b", "mamba2-2.7b"):
        smoke = get_arch(arch).smoke_model
        for cfg in (smoke.replace(dtype=d) for d in ("float32", "bfloat16")):
            for seed in (0, 3):
                card = params_to_numpy(transformer.init_params(
                    cfg, jr.PRNGKey(seed, device=dev), dev))
                cpu = params_to_numpy(transformer.init_params(
                    cfg, jr.PRNGKey(seed, device="cpu"), "cpu"))
                leaves = dict(tree_items(card))
                differ, a_log_ulps = [], 0
                for path, want in tree_items(cpu):
                    got = leaves[path]
                    if path.endswith("A_log"):
                        a_log_ulps = int(np.abs(
                            got.view(np.int32).astype(np.int64)
                            - want.view(np.int32).astype(np.int64)).max())
                    elif got.tobytes() != want.tobytes():
                        differ.append(path)
                rows.append(dict(arch=arch, dtype=cfg.dtype, seed=seed,
                                 leaves=len(leaves), leaves_not_bitwise=differ,
                                 a_log_max_ulps=a_log_ulps))
                if differ or a_log_ulps > 1:
                    raise AssertionError(f"init_params {arch} {cfg.dtype} "
                                         f"seed {seed}: card differs from the "
                                         f"CPU in {differ}, A_log "
                                         f"{a_log_ulps} ulps")
    key = jr.PRNGKey(5, device=dev)
    z = jr.normal(key, 1 << 20)
    z_cpu = jr.normal(jr.PRNGKey(5, device="cpu"), 1 << 20)
    u = jr.uniform(key, 1 << 20, -1.0 + 2.0 ** -24, 1.0)
    tail = int((-xla_math.log1p(u * -u) >= 5.0).sum())
    normal_ok = bool(torch.equal(z.cpu(), z_cpu))
    emit(dict(phase="init", checks=rows, normal_2to20_bitwise=normal_ok,
              normal_tail_lanes=tail))
    if not normal_ok or tail == 0:
        raise AssertionError(f"normal on the card: bitwise {normal_ok}, "
                             f"{tail} tail lanes")


def tree_items(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def timed_init(torch, transformer, cfg, seed, dev):
    """Full-width ``init_params`` on the card and its seconds."""
    from repro_torch import random as jr
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, jr.PRNGKey(seed, device=dev), dev)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# serve path: llama3.2-1b at full width
# ---------------------------------------------------------------------------

def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def profiled_prefill(torch, transformer, cfg, params, batch, kernel_name):
    """One prefill under torch.profiler: wall, device busy and idle share,
    the named kernel's device time and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        transformer.prefill(cfg, params, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_kernel = {}
    for e in dev_events:
        n, us = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_kernel.values()) / 1e3
    kernel_ms = sum(us for name, (_, us) in by_kernel.items()
                    if kernel_name in name) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                kernel_device_ms=kernel_ms,
                kernel_names=sorted(n for n in by_kernel if kernel_name in n),
                kernel_share_of_wall=kernel_ms / wall_ms,
                device_idle_share=1 - busy_ms / wall_ms,
                device_launches=len(dev_events),
                top_kernels=[dict(name=n[:90], launches=c, ms=us / 1e3)
                             for n, (c, us) in top])


def serve_path(torch, dev, flash_ms: float):
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer

    arch = get_arch("llama3.2-1b")
    cfg = arch.model
    params, init_s = timed_init(torch, transformer, cfg, 0, dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (1, 8192), generator=gen,
                           device=dev, dtype=torch.int32)
    batch = {"tokens": tokens}

    # (a) prefill, B = 1, S = 8192: the slice's main path
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = transformer.prefill(cfg, params, batch)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    launches = flash_attention.launches
    finite = bool(torch.isfinite(logits).all())
    if launches != cfg.n_layers or not finite:
        raise AssertionError(f"prefill: {launches} flash launches (want "
                             f"{cfg.n_layers}), finite logits {finite}")
    if tuple(logits.shape) != (1, 1, cfg.vocab):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        transformer.prefill(cfg, params, batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    prefill_ms = sorted(walls)[1]
    prefill = dict(batch=1, seq_len=8192, layers=cfg.n_layers,
                   dtype=cfg.dtype, n_params=n_params, init_params_s=init_s,
                   flash_launches=launches, logits_finite=finite,
                   first_call_ms=first_ms, wall_ms_median_of_3=prefill_ms,
                   wall_ms_runs=walls,
                   kernel_share_from_timing=cfg.n_layers * flash_ms
                   / prefill_ms,
                   profiled=profiled_prefill(torch, transformer, cfg, params,
                                             batch, "flash_kernel"))
    del params, logits

    # (b) serve at full width: decode only, no flash kernel
    flash_attention.launches = 0
    res = serve("llama3.2-1b", smoke=False, device=dev, log_fn=lambda *a: None)
    if flash_attention.launches != 0:
        raise AssertionError(f"serve launched {flash_attention.launches} "
                             "flash kernels")
    if res.tokens.shape != (4, 32):
        raise AssertionError(f"serve tokens {res.tokens.shape}")
    served = dict(batch=4, prompt_len=16, steps=32, max_len=128,
                  tokens_per_s=res.tokens_per_s, decode_s=res.decode_s,
                  first_tokens=res.tokens[0, :8].tolist())

    # (c) full width at depth 2 in float32: card (kernel) vs CPU (plain)
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    p2 = transformer.init_params(cfg2, jr.PRNGKey(1, device=dev), dev)
    toks = torch.randint(0, cfg.vocab, (1, 512), generator=gen, device=dev,
                         dtype=torch.int32)
    before = flash_attention.launches
    card = transformer.prefill(cfg2, p2, {"tokens": toks})
    torch.cuda.synchronize()
    card_launches = flash_attention.launches - before
    cpu = transformer.prefill(cfg2, _tree_to(p2, "cpu"),
                              {"tokens": toks.cpu()})
    card_vs_cpu = float((card.cpu() - cpu).abs().max())
    if card_launches != 2 or not card_vs_cpu <= 1e-4:
        raise AssertionError(f"depth-2 card vs CPU: {card_vs_cpu} "
                             f"({card_launches} launches)")

    # (d) depth 2, float32, S = 128: prefill vs stepping decode_step
    toks = toks[:, :128]
    pre = transformer.prefill(cfg2, p2, {"tokens": toks})
    state = transformer.init_decode_state(cfg2, 1, 128, dev)
    for i in range(128):
        step_logits, state = transformer.decode_step(cfg2, p2, state,
                                                     toks[:, i:i + 1])
    pre_vs_decode = float((pre - step_logits).abs().max())
    if not pre_vs_decode <= 2e-3:
        raise AssertionError(f"prefill vs decode: {pre_vs_decode}")
    emit(dict(phase="serve_path", prefill=prefill, serve=served,
              depth2_f32_card_vs_cpu_max_abs_err=card_vs_cpu,
              depth2_f32_prefill_vs_decode_max_abs_err=pre_vs_decode,
              logit_scale=float(cpu.abs().max())))
    return launches


# ---------------------------------------------------------------------------
# ssd_chunk
# ---------------------------------------------------------------------------

# (B, nc, Q, H, P, N)
TEST_SSD_SHAPES = [(1, 4, 16, 2, 16, 8), (2, 4, 32, 4, 32, 16),
                   (1, 2, 128, 2, 64, 128)]   # tests/test_kernels.py
SMOKE_SSD = (1, 8, 8, 8, 32, 16)       # mamba2 smoke config, S = 64
CONSISTENCY_SSD = (2, 2, 8, 8, 16, 16)  # ssm case, test_models_consistency
MAMBA_SSD = (1, 64, 128, 80, 64, 128)   # mamba2-2.7b layer, B = 1, S = 8192
BATCH2_SSD = (2, 16, 128, 80, 64, 128)


def ssd_inputs(torch, dev, shape, dtype, seed, strided: bool = False):
    """The JAX kernel test's recipe: x, B, C ~ N(0, 1), dt = softplus(N(0,
    1)), A = -exp(0.3 N(0, 1)).  ``strided``: x, B and C are views of one
    (B, S, H P + 2 N) row, as the model passes them."""
    B, nc, Q, H, P, N = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    if strided:
        xbc = torch.randn(B, nc * Q, H * P + 2 * N, generator=gen,
                          device=dev).to(dtype)
        x = xbc[..., :H * P].reshape(B, nc, Q, H, P)
        Bm = xbc[..., H * P:H * P + N].reshape(B, nc, Q, N)
        Cm = xbc[..., H * P + N:].reshape(B, nc, Q, N)
    else:
        x = torch.randn(B, nc, Q, H, P, generator=gen, device=dev).to(dtype)
        Bm = torch.randn(B, nc, Q, N, generator=gen, device=dev).to(dtype)
        Cm = torch.randn(B, nc, Q, N, generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, nc, Q, H, generator=gen, device=dev))
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device=dev))
    return x, dt, A, Bm, Cm


def check_ssd_chunk(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd, ssd_chunk

    cases = [(shape, dtype, False)
             for shape in TEST_SSD_SHAPES + [SMOKE_SSD, CONSISTENCY_SSD,
                                             MAMBA_SSD, BATCH2_SSD]
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(MAMBA_SSD, dtype, True)
              for dtype in (torch.float32, torch.bfloat16)]
    rows, mamba = [], {}
    for i, (shape, dtype, strided) in enumerate(cases):
        ins = ssd_inputs(torch, dev, shape, dtype, 200 + i, strided)
        got = ssd_chunk(*ins)
        torch.cuda.synchronize()
        want = ref.ssd_chunk_ref(*ins)
        dname = str(dtype).split(".")[-1]
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        rms = [float(w.square().mean().sqrt()) for w in want]
        # the worst lane's error as a share of its limit (1 = at the limit)
        share = [float(((g - w).abs() / (at + rt * w.abs())).max())
                 for g, w, (rt, at) in zip(got, want, SSD_TOL)]
        ok = all(g.dtype == torch.float32 and g.shape == w.shape
                 and bool(torch.isfinite(g).all())
                 and bool(torch.allclose(g, w, rtol=rt, atol=at))
                 for g, w, (rt, at) in zip(got, want, SSD_TOL))
        rows.append(dict(shape=list(shape), dtype=dname, strided_x=strided,
                         max_abs_err=dict(zip(("y", "states", "decays"),
                                              errs)),
                         ref_rms=dict(zip(("y", "states", "decays"), rms)),
                         worst_share_of_limit=dict(
                             zip(("y", "states", "decays"), share)),
                         ok=ok))
        if shape == MAMBA_SSD and not strided:
            mamba[dname] = max(errs[:2])
        if not ok:
            raise AssertionError(f"ssd_chunk {shape} {dtype} strided "
                                 f"{strided}: max |err| {errs} (reference "
                                 f"rms {rms}) over {SSD_TOL}")
        del ins, got, want
    # the composed ssd (kernel + torch recurrence) against the model's
    # chunked reference, at the layer shape in float32
    B, nc, Q, H, P, N = MAMBA_SSD
    x, dt, A, Bm, Cm = ssd_inputs(torch, dev, MAMBA_SSD, torch.float32, 300)
    cum_left_to_right = cumsum_is_left_to_right(torch, dt, A)
    args = (x.reshape(B, nc * Q, H, P), dt.reshape(B, nc * Q, H), A,
            Bm.reshape(B, nc * Q, N), Cm.reshape(B, nc * Q, N))
    y, y_ref = ssd(*args, Q), ref.ssd_ref(*args, Q)
    ssd_err = float((y - y_ref).abs().max())
    composed = dict(shape=[B, nc * Q, H, P, N], chunk=Q,
                    max_abs_err=ssd_err,
                    ref_rms=float(y_ref.square().mean().sqrt()))
    if not torch.allclose(y, y_ref, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"ssd vs ssd_ref: {composed}")
    emit(dict(phase="ssd_chunk", checks=rows, composed_ssd=composed,
              mamba_shape_max_abs_err=mamba,
              cumsum_left_to_right=cum_left_to_right))
    return mamba["bfloat16"]


def cumsum_is_left_to_right(torch, dt, A) -> bool:
    """Whether ``torch.cumsum`` along the chunk axis, as the plain version
    takes cum, is bitwise one left-to-right float32 sum, as the kernel
    takes it."""
    a = dt * A
    seq, run = torch.empty_like(a), torch.zeros_like(a[:, :, 0])
    for j in range(a.shape[2]):
        run = run + a[:, :, j]
        seq[:, :, j] = run
    return bool(torch.equal(seq, torch.cumsum(a, dim=2)))


def ssd_work(shape, in_bytes: int):
    """(bytes, flops) the function needs: each input read once and each
    output written once; C B^T once per chunk (its heads share B and C)
    and the y product on their lower triangles, the states in full."""
    B, nc, Q, H, P, N = shape
    nbytes = (in_bytes * (B * nc * Q * H * P + 2 * B * nc * Q * N)
              + 4 * (B * nc * Q * H + H)                       # dt, A
              + 4 * (B * nc * Q * H * P + B * nc * H * N * P + B * nc * H))
    tri = Q * (Q + 1) // 2
    flops = 2.0 * B * nc * (tri * N + H * (tri * P + Q * N * P))
    return nbytes, flops


def time_ssd(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    ins = ssd_inputs(torch, dev, MAMBA_SSD, torch.bfloat16, 400)
    ins32 = [t.float() for t in ins]
    nbytes, flops = ssd_work(MAMBA_SSD, 2)
    b, by = bound_ms(nbytes, flops, peak=BF16_FLOPS)
    row = dict(shape=list(MAMBA_SSD), dtype="bfloat16",
               ms=cuda_ms(lambda: ssd_chunk(*ins), warmup=3, runs=20),
               f32_ms=cuda_ms(lambda: ssd_chunk(*ins32), warmup=2, runs=9),
               plain_ms=cuda_ms(lambda: ref.ssd_chunk_ref(*ins), warmup=2,
                                runs=9),
               library_ms=None, bound_ms=b, bound_by=by, flops=flops,
               bytes=nbytes)
    row["tflops_per_s"] = flops / row["ms"] / 1e9
    row["bound_share"] = b / row["ms"]
    row["gb_per_s"] = nbytes / row["ms"] / 1e6
    emit(dict(phase="ssd_timing", kernel=row))
    return row


# ---------------------------------------------------------------------------
# mamba path: mamba2-2.7b at full width
# ---------------------------------------------------------------------------

def mamba_path(torch, dev, ssd_ms: float):
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer

    torch.cuda.empty_cache()                 # llama's weights are gone
    cfg = get_arch("mamba2-2.7b").model
    params, init_s = timed_init(torch, transformer, cfg, 0, dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(1)

    def prompt(seq_len):
        return {"tokens": torch.randint(0, cfg.vocab, (1, seq_len),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)}

    def run(batch):
        ssd_chunk.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = transformer.prefill(cfg, params, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches, finite = ssd_chunk.launches, bool(torch.isfinite(logits)
                                                    .all())
        if (launches != cfg.n_layers or not finite
                or tuple(logits.shape) != (1, 1, cfg.vocab)):
            raise AssertionError(
                f"prefill S = {batch['tokens'].shape[1]}: {launches} "
                f"ssd_chunk launches (want {cfg.n_layers}), finite logits "
                f"{finite}, shape {tuple(logits.shape)}")
        return ms, launches

    # (a) prefill, B = 1, S = 8192: the slice's main path
    batch = prompt(8192)
    first_ms, launches = run(batch)
    walls = [run(batch)[0] for _ in range(3)]
    prefill_ms = sorted(walls)[1]
    torch.cuda.reset_peak_memory_stats()
    prof = profiled_prefill(torch, transformer, cfg, params, batch,
                            "ssd_chunk_kernel")
    # bf16 x, B and C reach the tensor-core route and nothing else
    if not prof["kernel_names"] or any(
            "ssd_chunk_kernel_mma" not in n for n in prof["kernel_names"]):
        raise AssertionError(f"profiled ssd kernels {prof['kernel_names']}")
    prefill = dict(batch=1, seq_len=8192, layers=cfg.n_layers,
                   dtype=cfg.dtype, n_params=n_params, init_params_s=init_s,
                   ssd_chunk_launches=launches, logits_finite=True,
                   first_call_ms=first_ms, wall_ms_median_of_3=prefill_ms,
                   wall_ms_runs=walls,
                   kernel_share_from_timing=cfg.n_layers * ssd_ms
                   / prefill_ms,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   profiled=prof)

    # (b) prefill_32k's length, batch cut to 1
    long_ms, long_launches = run(prompt(32_768))
    del params, batch
    torch.cuda.empty_cache()

    # (c) serve at full width: decode only, no ssd_chunk kernel
    ssd_chunk.launches = 0
    res = serve("mamba2-2.7b", smoke=False, device=dev,
                log_fn=lambda *a: None)
    if ssd_chunk.launches != 0:
        raise AssertionError(f"serve launched {ssd_chunk.launches} "
                             "ssd_chunk kernels")
    if res.tokens.shape != (4, 32):
        raise AssertionError(f"serve tokens {res.tokens.shape}")
    served = dict(batch=4, prompt_len=16, steps=32,
                  tokens_per_s=res.tokens_per_s, decode_s=res.decode_s,
                  first_tokens=res.tokens[0, :8].tolist())
    torch.cuda.empty_cache()

    # (d) full width at depth 2 in float32: card (kernel) vs CPU (plain)
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    p2 = transformer.init_params(cfg2, jr.PRNGKey(1, device=dev), dev)
    toks = prompt(512)["tokens"]
    ssd_chunk.launches = 0
    card = transformer.prefill(cfg2, p2, {"tokens": toks})
    torch.cuda.synchronize()
    card_launches = ssd_chunk.launches
    cpu = transformer.prefill(cfg2, _tree_to(p2, "cpu"),
                              {"tokens": toks.cpu()})
    card_vs_cpu = float((card.cpu() - cpu).abs().max())
    if card_launches != 2 or not card_vs_cpu <= 1e-4:
        raise AssertionError(f"depth-2 card vs CPU: {card_vs_cpu} "
                             f"({card_launches} launches)")

    # (e) depth 2, float32, S = 128: prefill vs stepping decode_step
    toks = toks[:, :128]
    pre = transformer.prefill(cfg2, p2, {"tokens": toks})
    state = transformer.init_decode_state(cfg2, 1, 128, dev)
    for i in range(128):
        step_logits, state = transformer.decode_step(cfg2, p2, state,
                                                     toks[:, i:i + 1])
    pre_vs_decode = float((pre - step_logits).abs().max())
    if not pre_vs_decode <= 2e-3:
        raise AssertionError(f"prefill vs decode: {pre_vs_decode}")
    emit(dict(phase="mamba_path", prefill=prefill,
              prefill_32k_b1=dict(seq_len=32_768, wall_ms=long_ms,
                                  ssd_chunk_launches=long_launches,
                                  logits_finite=True),
              serve=served,
              depth2_f32_card_vs_cpu_max_abs_err=card_vs_cpu,
              depth2_f32_prefill_vs_decode_max_abs_err=pre_vs_decode,
              logit_scale=float(cpu.abs().max())))
    return launches


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


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
                         if "entry function" in ln or "registers" in ln
                         or "spill" in ln]
                     for n in _build.SOURCES}))

    if argv[1:] == ["--profile"]:
        profile_main_path(torch, dev)
        return 0
    sel_err, mask_err = check_fed_select(torch, dev)
    agg_err = check_fed_aggregate(torch, dev)
    timing = time_kernels(torch, dev)
    launches = main_path(torch, dev)
    check_init(torch, dev)
    attn_err = check_flash_attention(torch, dev)
    t_attn = time_flash_attention(torch, dev)
    flash_launches = serve_path(torch, dev, t_attn["ms"])
    ssd_err = check_ssd_chunk(torch, dev)
    t_ssd = time_ssd(torch, dev)
    ssd_launches = mamba_path(torch, dev, t_ssd["ms"])

    src = "src/repro_torch/kernels/csrc/"
    t_sel, t_mask, t_agg = (timing["fed_select_n1048576"],
                            timing["fed_select_mask_n1048576"],
                            timing["fed_aggregate_10x16777216"])
    kernels = [
        dict(name="fed_select", route="cuda", source=src + "fed_select.cu",
             replaces="src/repro/kernels/fed_select.py:168",
             launches=launches["fed_select"], max_abs_err=sel_err,
             shape=[1 << 20], **{k: t_sel[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="fed_select_mask", route="cuda",
             source=src + "fed_select.cu",
             replaces="src/repro/kernels/fed_select.py:152",
             launches=launches["fed_select_mask"], max_abs_err=mask_err,
             shape=[1 << 20], **{k: t_mask[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="fed_aggregate", route="cuda",
             source=src + "fed_aggregate.cu",
             replaces="src/repro/kernels/fed_aggregate.py:75",
             launches=launches["fed_aggregate"], max_abs_err=agg_err,
             shape=[10, 1 << 24], **{k: t_agg[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:77",
             launches=flash_launches, max_abs_err=attn_err,
             routes={"bfloat16": "tensor cores (mma.sync m16n8k16, P split "
                                 "into bf16 hi + lo); ms",
                     "float32": "CUDA cores; f32_ms"},
             shape=list(LLAMA_ATTN), **{k: t_attn[k] for k in (
                 "ms", "f32_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
        dict(name="ssd_chunk", route="cuda", source=src + "ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_chunk.py:52",
             launches=ssd_launches, max_abs_err=ssd_err,
             routes={"bfloat16": "tensor cores (mma.sync m16n8k16, M' split "
                                 "into bf16 hi + mid + lo, the states' "
                                 "weights into hi + lo); ms",
                     "float32": "CUDA cores; f32_ms"},
             shape=list(MAMBA_SSD), **{k: t_ssd[k] for k in (
                 "ms", "f32_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
    ]
    print(gpu_line(), flush=True)
    emit(dict(kernels=kernels))
    emit(dict(ok=True, device=dict(platform="gpu",
                                   kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
