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
                 version at the paths' D in float32 (10, 610), (10,
                 820,522) and (10, 310,116), the buffered server's (5, 610)
                 and (5, 820,522), at (10, 2^24) float32 and
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
5a. ``scenarios`` the paper's grid on the card: scenarios always, scarce,
                 homedevices, smartphones and uneven × strategies f3ast,
                 fedavg and fedadam at GRID_ROUNDS (100), every other
                 scenario under f3ast and uniform, fedavg_weighted and
                 fixed_f3ast (with an r_target) on homedevices and dropout
                 at SHORT_ROUNDS (40); each cell held to the port's CPU run
                 of the same spec (run meanwhile in spawned worker
                 processes) as main_path holds its run, and its launches
                 counted:
                 fed_select_mask once a round on dropout and straggler
                 (their completion hook splits the cut from the EMA and
                 weights), fed_select once a round elsewhere,
                 fed_aggregate once a round everywhere; one line per cell
                 with its steady round ms and wall, card and CPU;
5b. ``paper_tasks`` the paper's Shakespeare and CIFAR tasks at their task
                 configs (the LSTM, 820,522 parameters; the reduced ResNet,
                 310,116) in the cell ``launch.train --task X`` builds
                 (homedevices), under f3ast and fedadam, 10 rounds each on
                 the card, each held to its CPU run (spawned workers, two
                 threads each): masks, K_t, |avail| and final r_k bitwise,
                 train loss and delta norm within PAPER_TASK_LOSS_TOL
                 and PAPER_TASK_DNORM_TOL, fed_select and
                 fed_aggregate once a round; the CIFAR f3ast cell again on
                 the card, and once more with TF32 on (both reported, not
                 held); ResNet-18 at full width (11,220,132 parameters) on
                 32×32 stand-in images through ``make_fed_round``, K = 10,
                 E = 5, B = 20, 3 rounds in each cohort mode (fed_aggregate
                 once a round in parallel mode, never in sequential),
                 forward and grad on 2 images card vs CPU within 1e-4 of
                 the largest magnitude, the round's deltas through
                 fed_aggregate against its plain version at
                 (10, 11,220,132) and timed beside ``w @ v``; ``python -m
                 repro_torch.launch.train --task cifar --rounds 3`` on the
                 card; and a profiled round of each task;
5c. ``host_async`` the ninth slice's paths on the card, each cell's
                 launches counted alone and held to its round's, each
                 cell held to the port's CPU run of the same spec
                 (spawned workers, started first): the host loop
                 (``RunSpec(engine="host")``) under f3ast, 300 rounds,
                 bitwise the CPU and the main_path device run (masks, K_t,
                 |avail|, r_k), with checkpoints every 100 rounds whose
                 last one, restored onto the CPU, is bitwise the run's
                 final r_k and parameters; under poc, 150 rounds
                 (fed_select_mask twice a round), the fresh losses within
                 1e-5 relative and the masks bitwise in every round whose
                 cut margin clears the card-vs-CPU loss gap (the rounds
                 compared and any round under its margin reported; one
                 pass of fresh losses timed); on dropout, 60 rounds,
                 bitwise the card's device run too; the buffered server
                 on straggler, device and host executors, 150 rounds,
                 masks, every async_history field and r_k bitwise the CPU
                 and each other; the Shakespeare (820,522) and CIFAR
                 (310,116) task cells on the host loop and Shakespeare on
                 the buffered server with deadline latencies, 10 rounds
                 each (losses at the paper_tasks tolerances);
                 ``run_cells_vmapped`` over seeds 0-3 with caps 3, 5, 10,
                 10, 60 rounds, bitwise the CPU and each cell's single run
                 on the card; and ``python -m repro_torch.launch.train
                 --scenario straggler --aggregation buffered --engine host
                 --ckpt-dir D --rounds 3`` (exit 0, 3 records); one line a
                 cell with the steady ms a round on the card and the CPU;
5d. ``clients``  the million-client path (the JAX package's N-scaling
                 cell: SynthTask dim 32, bernoulli q = 0.3, K = 10, f3ast,
                 E = 5, B = 20; clients synthesized on demand, masks
                 streamed packed): the device engine at N = 10^6, 100
                 rounds (``fed_select`` on its cooperative path and
                 ``fed_aggregate`` once a round; its first 20 rounds
                 bitwise the CPU's: masks, K_t, |avail|, r_k; peak
                 memory), a profiled window of 3 of its rounds, N = 10^7
                 for 5 rounds (|S_t| = min(K_t, |avail_t|), its first 2
                 rounds against the CPU where that takes under 60 s), the
                 client-sharded engine over 2 gloo ranks on the one card
                 at N = 10^6 under both ``topk_impl``s (30 rounds, bitwise
                 the device run; NCCL too with 2 cards), and
                 ``run_spec(RunSpec(mesh_shape=(2,)))`` in the same group,
                 bitwise main_path's device run; one line a cell;
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
                 with that window; at gemma's head dim 256 (where the bf16
                 route reads Q from shared memory each k-step) a
                 (1, 512, 4, 2, 256) case in both dtypes and every mode and
                 window 32, gemma-7b's prefill layer (1, 8192, 16, 16, 256)
                 and qwen3-14b's group of 5, (1, 2048, 40, 8, 128), causal
                 in both dtypes; it reports each reference's RMS;
8. ``flash_timing`` median CUDA-event times of the kernel (its bf16 route,
                 on the tensor cores, and its float32 route, on the CUDA
                 cores), its plain version and
                 ``scaled_dot_product_attention`` at llama's and gemma's
                 prefill shapes,
                 beside the bound (the larger of bytes over 3.35 TB/s and
                 the unmasked QK^T + PV flops over 989 TFLOP/s bf16), the
                 bf16 route's TFLOP/s and its share of the bound;
8a. ``flash_backward`` holds the backward kernel (``flash_attention_bwd``)
                 against its plain version (``ref.sdpa_bwd``) on the same
                 q, k, v, do and the plain forward's o and lse: float32 and
                 bf16, head dims 32, 64, 128 and 256, groups of 1, 4 and 5
                 query heads a KV head, causal, window 64 and soft-cap 30,
                 Sq = Skv = 128 (B = 2) and 1000 (ragged), plus head dim
                 16, a non-causal case and the training layers of
                 llama3.2-1b (1, 4096, 32, 8, 64), qwen3-8b (1, 4096, 32,
                 8, 128) and gemma-7b (1, 4096, 16, 16, 256), causal, in
                 both dtypes (bf16 is the tensor-core route, float32 the
                 CUDA-core one): float32 gradients
                 within 1e-5 of their largest magnitude, bf16 lanes within
                 one bf16 step plus 1e-5 of it, and every case run twice
                 bit for bit (the kernel has no atomics); at zoo_train's
                 folded layer (2, 4096, 32, 8, 64), causal, in both dtypes
                 the forward kernel's o and lse (``flash_attention_lse``)
                 are held against the plain forward's (lse within 1e-5)
                 and fed to both backwards, and ``vmap(grad)`` through
                 ``flash_attention`` must equal the kernel's gradient bit
                 for bit with one backward launch;
8b. ``flash_bwd_timing`` median CUDA-event times of the backward kernel
                 (bf16 inputs: the tensor-core route; float32 inputs: the
                 CUDA-core route), its plain version, and SDPA's backward
                 (``torch.autograd.grad`` of one recorded forward, the
                 graph retained) at llama's training layer, zoo_train's
                 folded layer (2, 4096, 32, 8, 64) and the qwen3-8b and
                 gemma-7b training layers, causal, beside the bound (the
                 five products of the backward over 989 TFLOP/s bf16);
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
9a. ``dense_path`` drives qwen3-8b, qwen3-14b and gemma-7b at full width,
                 one after another, each freed before the next: (a) the
                 weights ``launch.serve`` draws (``serve_params``, timed on
                 the card), one ``prefill`` of B = 1, S = 8192 with the
                 launch count set to 0 just before, which must launch the
                 kernel once a layer (36, 40, 28) and give finite logits,
                 the median of 3 and a profiled run whose flash kernels
                 must all be the tensor-core route's; (b) 8 decode steps
                 through ``serve`` on those weights (batch 4), with no
                 flash launch; (c) at depth 2 of the full widths, the
                 card's ``init_params`` against the CPU's at seed 0 in
                 bfloat16 and seed 3 in float32 (the CPU walks the same key
                 tree and re-draws windows of every drawn row, the norms
                 whole: ``sampled_init_check``), then the card's float32
                 prefill (S = 512, 2 launches) within 1e-4 of the CPU's on
                 the same weights;
9b. ``zoo_train`` trains llama3.2-1b at full width (16 layers, d 2048,
                 the tied 128,256-token vocabulary, bf16, random weights)
                 through ``launch.steps.build_train_step(arch, "train_4k")``
                 (the arch's FedExec: the parallel round, per-layer remat,
                 Adam) and ``launch.train.federated_rounds`` (the loop of
                 ``run_arch_smoke``: f3ast over 16 ``scarce`` clients),
                 K = 2, E = 2, B = 1, S = 4096 (cut from K = 32, B = 8):
                 one warm-up round and 3 timed, each launching fed_select
                 and fed_aggregate once, the flash forward 2 x 16 x E and
                 its backward 16 x E times, with finite losses; the peak
                 memory and a profiled round, whose backward kernels must
                 all be the tensor-core route's; then one round at the full
                 widths, depth 2, float32, K = 2, E = 1, B = 1, S = 512 on
                 the card and in a spawned CPU worker from the card's
                 parameters: masks bitwise, loss and delta norm within
                 ZOO_TOL relative, and the delta leaf by leaf (Adam's
                 first moment, (1 - b1) delta; each stacked block leaf per
                 layer) within ZOO_LEAF_NORM_TOL in norm and
                 ZOO_LEAF_MAX_TOL of its largest lane;
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

Each phase prints one JSON line (``seconds_by_phase`` their wall times);
any failure raises (exit status != 0).
The last three lines are the card's name and power limit as nvidia-smi
reports them, the kernels summary, and ``{"ok": true, "device": ...}``.
``--profile`` runs only the build and a profiled window of the main path
(no checks, no ``ok`` line).
TF32 is off for matmuls and cuDNN throughout.
"""
from __future__ import annotations

import contextlib
import json
import math
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
    recorded fewer device events than calls (none, or a part: CUPTI lost
    them) is the profiler's loss, not the kernel's (the outputs are
    checked above): it is taken again, up to three times, and the trace
    kept must hold exactly one fed_select kernel a call."""
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
                if len(names) >= calls:
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

    # the paths' D: softmax regression, the Shakespeare LSTM (820,522, not
    # a multiple of 4: the masked scalar path over the whole buffer), the
    # CIFAR task's ResNet (310,116), the million-client cell's softmax
    # regression (330); the buffered server's K = 5 at the first two, and
    # a shard's kb = 5 slots of the sharded engine at 330; then the timed
    # shape, and bf16
    shapes = [(10, 610, torch.float32), (10, 820_522, torch.float32),
              (10, 310_116, torch.float32), (10, 330, torch.float32),
              (5, 610, torch.float32), (5, 820_522, torch.float32),
              (5, 330, torch.float32), (10, 1 << 24, torch.float32),
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
    from repro_torch.kernels.fed_select import (fed_select, fed_select_mask,
                                                reset_launches)
    from repro_torch.sim import RunSpec, run_spec

    spec = RunSpec()
    reset_launches()
    fed_aggregate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_spec(spec, device=dev, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fed_select=fed_select.launches,
                    fed_select_mask=fed_select_mask.launches,
                    fed_aggregate=fed_aggregate.launches,
                    fed_select_by_mode=dict(fed_select.launches_by_mode))
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
    return launches, res


def profile_main_path(torch, dev, rounds: int = 20):
    """Where the main path's time goes (``--profile``): one
    :func:`device_profile` window over ``rounds`` steady rounds of the
    default cell, after 10 warm-up rounds, with the round/* spans and the
    host's top aten ops of the same trace.  The round time of an
    unprofiled window of as many rounds is printed beside it, for the
    profiler's own cost."""
    from torch.autograd import DeviceType
    from repro_torch import random as jr
    from repro_torch.sim.engine import build_engine

    engine, _ = build_engine("scarce", "f3ast", device=dev)
    box = [engine.init_carry(jr.PRNGKey(0, device=dev))]

    def chunk(t0):
        box[0], _ = engine.chunk(box[0], range(t0, t0 + rounds))
    box[0], _ = engine.chunk(box[0], range(10))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk(10)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    stats, prof = device_profile(torch, lambda: chunk(10 + rounds),
                                 steps=rounds)
    spans = {}
    for e in prof.events():
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
              round_ms_unprofiled=1e3 * plain_wall / rounds, **stats,
              spans=spans,
              top_host_ops=[dict(op=k, calls_per_round=c / rounds,
                                 self_ms_per_round=us / 1e3 / rounds)
                            for k, c, us in host_ops]))


# ---------------------------------------------------------------------------
# scenarios: the paper's grid and every other cell of the scenario engine
# ---------------------------------------------------------------------------

PAPER_SCENARIOS = ("always", "scarce", "homedevices", "smartphones",
                   "uneven")
PAPER_ALGORITHMS = ("f3ast", "fedavg", "fedadam")
OTHER_SCENARIOS = ("bernoulli", "markov", "gilbert_elliott", "diurnal",
                   "drift", "trace", "bandwidth", "stepk", "dropout",
                   "straggler")
BASELINE_SCENARIOS = ("homedevices", "dropout")
BASELINE_ALGORITHMS = ("uniform", "fedavg_weighted", "fixed_f3ast")
# The paper grid's rounds: RunSpec()'s 300 cut to 100, so that the script,
# with the dense archs and the zoo's training round, stays well inside its
# 1,200 s limit.
GRID_ROUNDS = 100
SHORT_ROUNDS = 40
CPU_WORKERS = 4
# completion processes that split the cut from the EMA and weights, so the
# round takes fed_select_mask instead of the fused fed_select
HOOKED_SCENARIOS = ("dropout", "straggler")


def scenario_cells():
    """(scenario, strategy, rounds, spec JSON) of the phase: the paper's
    grid at GRID_ROUNDS, every other scenario under f3ast and the other
    baselines at SHORT_ROUNDS."""
    from repro_torch.sim import RunSpec

    # fixed_f3ast's frozen target: the feasible rate K/N spread over the
    # fleet (a ramp around 0.1), so it differs from the tracked r
    r_target = [0.05 + 0.1 * k / 99 for k in range(100)]
    cells = [(sc, algo, GRID_ROUNDS) for sc in PAPER_SCENARIOS
             for algo in PAPER_ALGORITHMS]
    cells += [(sc, "f3ast", SHORT_ROUNDS) for sc in OTHER_SCENARIOS]
    cells += [(sc, algo, SHORT_ROUNDS) for sc in BASELINE_SCENARIOS
              for algo in BASELINE_ALGORITHMS]
    out = []
    for sc, algo, rounds in cells:
        kw = {"r_target": r_target} if algo == "fixed_f3ast" else {}
        spec = RunSpec(scenario=sc, strategy=algo, rounds=rounds,
                       strategy_kwargs=kw)
        out.append((sc, algo, rounds, spec.to_json()))
    return out


def cpu_cell(src: str, spec_json: str, threads: int = 1) -> dict:
    """One cell on the CPU, in a worker process (spawned: no CUDA)."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    from repro_torch.sim import RunSpec, run_spec

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    res = run_spec(RunSpec.from_json(spec_json), device="cpu",
                   log_fn=lambda *a: None)
    return dict(sel=res.sel_history, comp=res.comp_history, k_t=res.k_t,
                n_available=res.n_available, rates=res.rates,
                train_loss=res.train_loss, delta_norm=res.delta_norm,
                final=res.final_metrics, wall_s=time.perf_counter() - t0)


def scenarios(torch, dev):
    """Every cell of :func:`scenario_cells` on the card, each held to the
    port's CPU run of the same spec (run meanwhile in CPU_WORKERS spawned
    processes): masks, K_t, |avail| and final r_k bitwise, losses and
    delta norm within LOSS_TOL; and each kernel launched as the cell's
    round says (fed_select or, under a completion hook, fed_select_mask
    once a round; fed_aggregate once a round)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    cells = scenario_cells()
    totals = dict(fed_select=0, fed_select_mask=0, fed_aggregate=0)
    by_mode = {}
    t_phase = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(CPU_WORKERS, mp_context=ctx) as pool:
        cpu = [pool.submit(cpu_cell, str(ROOT / "src"), spec_json)
               for _, _, _, spec_json in cells]
        try:
            rows = [check_cell(torch, cell, card_cell(torch, dev, cell,
                                                      totals, by_mode),
                               fut.result(), "scenarios", LOSS_TOL,
                               LOSS_TOL)
                    for cell, fut in zip(cells, cpu)]
        finally:
            for fut in cpu:            # a failed cell fails the phase now
                fut.cancel()
    emit(dict(phase="scenarios_summary", cells=len(rows),
              wall_s=time.perf_counter() - t_phase, cpu_workers=CPU_WORKERS,
              launches=totals, fed_select_launches_by_mode=by_mode))
    return totals


def card_cell(torch, dev, cell, totals, by_mode):
    """One cell (scenario, strategy, rounds, spec JSON) on the card with
    the launch counts set to 0 just before and read just after; adds them
    to ``totals`` and ``by_mode``.  Returns (result, launches, wall)."""
    from repro_torch.kernels.fed_aggregate import fed_aggregate
    from repro_torch.kernels.fed_select import (fed_select, fed_select_mask,
                                                reset_launches)
    from repro_torch.sim import RunSpec, run_spec

    spec = RunSpec.from_json(cell[3])
    reset_launches()
    fed_aggregate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_spec(spec, device=dev, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fed_select=fed_select.launches,
                    fed_select_mask=fed_select_mask.launches,
                    fed_aggregate=fed_aggregate.launches)
    for k, v in launches.items():
        totals[k] += v
    for k, v in fed_select.launches_by_mode.items():
        by_mode[k] = by_mode.get(k, 0) + v
    return res, launches, wall


def check_cell(torch, cell, card, ref, phase: str, loss_tol: float,
               dnorm_tol: float):
    """A cell's card run (:func:`card_cell`) held to its CPU run ``ref``
    (:func:`cpu_cell`): masks, K_t, |avail| and final r_k bitwise, train
    loss within ``loss_tol`` and delta norm within ``dnorm_tol``, each
    kernel launched as the round says."""
    import numpy as np

    sc, algo, rounds, _ = cell
    res, launches, wall = card
    hooked = sc in HOOKED_SCENARIOS
    want = dict(fed_select=0 if hooked else rounds,
                fed_select_mask=rounds if hooked else 0,
                fed_aggregate=rounds)
    bitwise = {
        "sel_mask": res.sel_history.tobytes() == ref["sel"].tobytes(),
        "completed": res.comp_history.tobytes() == ref["comp"].tobytes(),
        "k_t": res.k_t.tobytes() == ref["k_t"].tobytes(),
        "n_available": (res.n_available.tobytes()
                        == ref["n_available"].tobytes()),
        "final_r": res.rates.tobytes() == ref["rates"].tobytes(),
    }
    loss_err = float(np.abs(res.train_loss - ref["train_loss"]).max())
    dnorm_err = float(np.abs(res.delta_norm - ref["delta_norm"]).max())
    fm, cfm = res.final_metrics, ref["final"]
    row = dict(phase=phase, scenario=sc, strategy=algo, rounds=rounds,
               launches=launches, bitwise_vs_cpu=bitwise,
               train_loss_max_abs_err=loss_err, loss_tol=loss_tol,
               delta_norm_max_abs_err=dnorm_err, delta_norm_tol=dnorm_tol,
               steady_round_ms=1e3 / fm["steady_rounds_per_s"], wall_s=wall,
               cpu_steady_round_ms=1e3 / cfm["steady_rounds_per_s"],
               cpu_wall_s=ref["wall_s"], k_t_mean=float(res.k_t.mean()),
               test_acc=fm["test_acc"], cpu_test_acc=cfm["test_acc"])
    emit(row)
    if (not all(bitwise.values()) or launches != want
            or loss_err > loss_tol or dnorm_err > dnorm_tol
            or not np.isfinite(res.train_loss).all()):
        raise AssertionError(f"{phase} cell {sc}/{algo} fails "
                             f"(launches wanted {want}): {row}")
    return row


# ---------------------------------------------------------------------------
# paper_tasks: Shakespeare and CIFAR through run_spec; ResNet-18; the CLI
# ---------------------------------------------------------------------------

PAPER_TASKS = ("shakespeare", "cifar")
# cut from 20 when the dense archs joined the script: the phase waits
# for the CPU's Shakespeare runs (~5.6 s a round); evaluated every
# PAPER_TASK_EVAL rounds, so the runs after the first chunk give the
# steady round
PAPER_TASK_ROUNDS = 10
PAPER_TASK_EVAL = 5
PAPER_TASK_CPU_THREADS = 2
PAPER_TASK_STRATEGIES = ("f3ast", "fedadam")
# card vs the CPU, train loss each round.  The LSTM's rounds stay within
# float32 reordering (measured 1.4e-6 over 20 rounds).  The CIFAR
# ResNet's training amplifies it: on the CPU alone, the port's parallel
# and sequential modes (the same arithmetic, summed in other orders) part
# by up to 1.9e-2 in a round's loss over 20 rounds of the f3ast cell and
# 5.7e-3 of the fedadam cell, though within 2.4e-7 over 3 rounds at 8×8
PAPER_TASK_LOSS_TOL = {"shakespeare": 1e-4, "cifar": 5e-2}
# and the delta norm each round: the LSTM's within 1.2e-5 over 20 rounds,
# the CIFAR ResNet's within 1.8e-3 to 2.5e-3 in every earlier card run
# (H100 80GB HBM3, 700 W), about 1% of its norm
PAPER_TASK_DNORM_TOL = {"shakespeare": 1e-4, "cifar": 1e-2}
RESNET18_K, RESNET18_E, RESNET18_B, RESNET18_IMG = 10, 5, 20, 32
RESNET18_ROUNDS = 3
# ResNet-18 on 2 images, card vs CPU: logits and grads, each relative to
# its largest magnitude (float32 convolutions in other orders, TF32 off)
RESNET18_REL_TOL = 1e-4


def paper_task_cells():
    """(task, strategy, rounds, spec JSON): the cell ``python -m
    repro_torch.launch.train --task <task>`` builds (availability
    homedevices, the task's own data and config) under f3ast and fedadam."""
    from repro_torch.sim import RunSpec, Scenario

    out = []
    for task in PAPER_TASKS:
        sc = Scenario(name="homedevices", availability="homedevices",
                      task=task)
        for algo in PAPER_TASK_STRATEGIES:
            spec = RunSpec(scenario=sc, strategy=algo,
                           rounds=PAPER_TASK_ROUNDS,
                           eval_every=PAPER_TASK_EVAL)
            out.append((task, algo, PAPER_TASK_ROUNDS, spec.to_json()))
    return out


def device_profile(torch, fn, steps: int = 1, kernel_name=None):
    """``fn()`` under torch.profiler, the script's one reading of a trace:
    wall ms, device launches, kernel ms (summed), busy ms (the union of
    the kernels' intervals: cuDNN runs some kernels side by side), idle
    share (1 - busy / wall) and the top kernels, each a step (``fn`` runs
    ``steps`` steps); with ``kernel_name``, the device ms and names of the
    kernels whose name holds it.  The profiler mirrors
    ``record_function`` spans onto the GPU timeline; those (``round/*``)
    are not kernels.  Returns (stats, the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("round/")]
    by_kernel = {}
    for e in kernels:
        n, us = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    stats = dict(wall_ms_per_step=wall_ms / steps,
                 device_launches_per_step=len(kernels) / steps,
                 kernel_ms_per_step=sum(
                     us for _, us in by_kernel.values()) / 1e3 / steps,
                 device_busy_ms_per_step=busy_us / 1e3 / steps,
                 device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
                 top_kernels=[dict(name=k[:90], launches_per_step=n / steps,
                                   ms_per_step=us / 1e3 / steps)
                              for k, (n, us) in top])
    if kernel_name is not None:
        named = {k: v for k, v in by_kernel.items() if kernel_name in k}
        stats["kernel_names"] = sorted(named)
        stats["kernel_device_ms_per_step"] = sum(
            us for _, us in named.values()) / 1e3 / steps
    return stats, prof


def profile_task_round(torch, dev, task: str):
    """One steady round of the task's f3ast cell under the profiler,
    after one warm-up round."""
    from repro_torch import random as jr
    from repro_torch.sim import Scenario
    from repro_torch.sim.engine import build_engine

    sc = Scenario(name="homedevices", availability="homedevices", task=task)
    engine, _ = build_engine(sc, "f3ast", device=dev)
    carry = engine.init_carry(jr.PRNGKey(0, device=dev))
    carry, _ = engine.chunk(carry, range(1))
    box = [carry]

    def step():
        box[0], _ = engine.chunk(box[0], range(1, 2))
    return device_profile(torch, step)[0]


def resnet18_macs(cfg, img: int) -> int:
    """Multiply-accumulates of one forward pass of ``cfg`` on an img×img
    image, from the convolution and fc shapes (SAME padding: a stride-s
    layer's output is ceil(in / s))."""
    from repro_torch.models import resnet

    macs, size, cin = img * img * 9 * 3 * cfg.width, img, cfg.width
    strides = resnet.block_strides(cfg)
    bi = 0
    for si, n in enumerate(cfg.stages):
        cout = cfg.width * 2 ** si
        for _ in range(n):
            s = strides[bi]
            out = -(-size // s)
            macs += out * out * 9 * (cin * cout + cout * cout)
            if s != 1 or cin != cout:
                macs += out * out * cin * cout
            size, cin, bi = out, cout, bi + 1
    return macs + cin * cfg.n_classes


def resnet18(torch, dev):
    """ResNet-18 at full width (ResNetConfig(): width 64, stages (2, 2, 2,
    2), 100 classes, GroupNorm 8) on 32×32×3 stand-in images through
    ``make_fed_round``: K = 10, E = 5, B = 20, RESNET18_ROUNDS rounds in
    each mode; forward and grad on 2 images card vs CPU; one round's
    deltas through the ``fed_aggregate`` kernel against its plain version
    at (10, 11,220,132), timed beside ``w @ v``."""
    import numpy as np
    from torch.func import grad, vmap

    from repro_torch import random as jr
    from repro_torch.core.fedstep import _local_sgd, make_fed_round
    from repro_torch.data import (CohortSampler, FederatedData,
                                  make_vision_federated, staged_cohort_batch)
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_aggregate import fed_aggregate
    from repro_torch.models import resnet
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves, tree_map

    K, E, B = RESNET18_K, RESNET18_E, RESNET18_B
    cfg = resnet.ResNetConfig()
    params, strides = resnet.init_params(cfg, jr.PRNGKey(0, device=dev), dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    loss_fn = resnet.make_loss_fn(cfg, strides)
    fed = FederatedData(make_vision_federated(
        n_clients=K, n_classes=cfg.n_classes, img=RESNET18_IMG, per_class=20,
        seed=0))
    staged = CohortSampler(fed).stage_device(dev)
    ids = torch.arange(K, device=dev)
    weights = torch.from_numpy(fed.p).to(dev)
    batches = [staged_cohort_batch(staged, key, ids, E, B)
               for key in jr.split(jr.PRNGKey(1, device=dev),
                                   RESNET18_ROUNDS)]

    # forward and grad on 2 images, card vs CPU, same weights
    two = {k: v[0, 0, :2] for k, v in batches[0].items()}
    cpu_params = tree_map(lambda x: x.cpu(), params)
    cpu_two = {k: v.cpu() for k, v in two.items()}
    rel = {}
    for name, f in (("logits", lambda p, b: resnet.forward(
            cfg, p, strides, b["x"])), ("grad", grad(loss_fn))):
        got = [x.cpu() for x in tree_leaves(f(params, two))]
        want = tree_leaves(f(cpu_params, cpu_two))
        scale = max(float(w.abs().max()) for w in want)
        rel[name] = max(float((g - w).abs().max())
                        for g, w in zip(got, want)) / scale
    del cpu_params

    # one round's deltas: the kernel against its plain version
    lr = 0.05
    deltas, _, _ = vmap(lambda b: _local_sgd(loss_fn, params, b, lr))(
        batches[0])
    flat = torch.cat([x.reshape(K, -1) for x in tree_leaves(deltas)], 1)
    del deltas
    d = flat.shape[1]
    got, want = fed_aggregate(flat, weights), ref.fed_aggregate_ref(flat,
                                                                    weights)
    over = int(((got - want).abs()
                > ref.fed_aggregate_err_bound(flat, weights, got,
                                              want)).sum())
    agg_err = float((got - want).abs().max())
    nbytes = 4 * (K * d + K + d)
    b_ms, b_by = bound_ms(nbytes, flops=2.0 * K * d)
    agg = dict(shape=[K, d], max_abs_err=agg_err, lanes_over_bound=over,
               ms=cuda_ms(lambda: fed_aggregate(flat, weights)),
               plain_ms=cuda_ms(lambda: ref.fed_aggregate_ref(flat, weights)),
               library_ms=cuda_ms(lambda: weights @ flat),
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
    agg["bound_share"] = agg["bound_ms"] / agg["ms"]
    del flat, got, want

    # the rounds, in each mode, from the same weights and batches
    flops = 6.0 * K * E * B * resnet18_macs(cfg, RESNET18_IMG)
    modes = {}
    for mode in ("parallel", "sequential"):
        opt = make_optimizer("sgd", lr=1.0)
        fed_round = make_fed_round(loss_fn, opt, mode=mode)
        p, state = params, opt.init(params)
        fed_aggregate.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        ms, losses, dnorms = [], [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, state, m = fed_round(p, state, batch, weights, lr)
            losses.append(float(m.loss))
            dnorms.append(float(m.delta_norm))
            ms.append(1e3 * (time.perf_counter() - t0))
        launches = fed_aggregate.launches
        steady_ms = float(np.median(ms[1:]))
        modes[mode] = dict(
            round_ms=ms, steady_round_ms=steady_ms,
            fed_aggregate_launches=launches, train_loss=losses,
            delta_norm=dnorms,
            peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            share_of_f32_peak=flops / (steady_ms / 1e3) / FP32_FLOPS)
        if mode == "parallel":
            modes[mode]["profile"] = device_profile(
                torch, lambda: fed_round(params, opt.init(params),
                                         batches[0], weights, lr))[0]
        if not (np.isfinite(losses).all() and np.isfinite(dnorms).all()):
            raise AssertionError(f"resnet18 {mode}: non-finite round")
        if launches != (RESNET18_ROUNDS if mode == "parallel" else 0):
            raise AssertionError(f"resnet18 {mode}: {launches} "
                                 f"fed_aggregate launches")
    mode_gap = float(np.abs(np.subtract(modes["parallel"]["train_loss"],
                                        modes["sequential"]["train_loss"])
                            ).max())
    row = dict(phase="paper_tasks", part="resnet18", params=n_params,
               k=K, e=E, b=B, img=RESNET18_IMG,
               forward_gmac_per_image=resnet18_macs(cfg, RESNET18_IMG) / 1e9,
               round_tflop=flops / 1e12, card_vs_cpu_rel_err=rel,
               rel_tol=RESNET18_REL_TOL, fed_aggregate=agg, modes=modes,
               parallel_vs_sequential_loss_max_abs_diff=mode_gap)
    emit(row)
    if over or max(rel.values()) > RESNET18_REL_TOL:
        raise AssertionError(f"resnet18 fails: {row}")
    return agg, modes["parallel"]["fed_aggregate_launches"]


def train_cli(torch):
    """``python -m repro_torch.launch.train --task cifar --rounds 3`` on
    the card, in its own process; it must exit with 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--task", "cifar", "--rounds", "3"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"train CLI exit {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    final = json.loads(out.stdout[out.stdout.index("{"):])
    row = dict(phase="paper_tasks", part="train_cli", rc=out.returncode,
               wall_s=wall, device=final["device"],
               test_acc=final["test_acc"], train_loss=final["train_loss"])
    emit(row)
    if not final["device"].startswith("cuda"):
        raise AssertionError(f"train CLI ran on {final['device']}")


def paper_tasks(torch, dev):
    """The Shakespeare and CIFAR cells of :func:`paper_task_cells` on the
    card, each held to the port's CPU run of the same spec (spawned
    workers, started first): masks, K_t, |avail| and final r_k bitwise,
    train loss and delta norm within PAPER_TASK_LOSS_TOL and
    PAPER_TASK_DNORM_TOL, ``fed_select`` and ``fed_aggregate`` once a
    round; the first CIFAR cell run twice on the
    card (whether the card repeats its own losses); then, while the CPU
    runs finish, ResNet-18 at full width (:func:`resnet18`), the training
    CLI and a profiled round of each task."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    cells = paper_task_cells()
    totals = dict(fed_select=0, fed_select_mask=0, fed_aggregate=0)
    by_mode = {}
    t_phase = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(cells), mp_context=ctx) as pool:
        cpu = [pool.submit(cpu_cell, str(ROOT / "src"), spec_json,
                           PAPER_TASK_CPU_THREADS)
               for _, _, _, spec_json in cells]
        try:
            card = [card_cell(torch, dev, cell, totals, by_mode)
                    for cell in cells]
            cifar = [c[0] for c in cells].index("cifar")
            again = card_cell(torch, dev, cells[cifar], totals, by_mode)[0]
            # and once with TF32 on, as cuDNN and cuBLAS would default
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                tf32 = card_cell(torch, dev, cells[cifar], totals,
                                 by_mode)[0]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            agg, resnet_launches = resnet18(torch, dev)
            train_cli(torch)
            for task in PAPER_TASKS:
                emit(dict(phase="paper_tasks", part="profile", task=task,
                          strategy="f3ast",
                          **profile_task_round(torch, dev, task)))
            refs = [fut.result() for fut in cpu]
            for cell, run, ref in zip(cells, card, refs):
                check_cell(torch, cell, run, ref, "paper_tasks",
                           PAPER_TASK_LOSS_TOL[cell[0]],
                           PAPER_TASK_DNORM_TOL[cell[0]])
        finally:
            for fut in cpu:
                fut.cancel()
    totals["fed_aggregate"] += resnet_launches
    emit(dict(phase="paper_tasks_summary", cells=len(cells),
              wall_s=time.perf_counter() - t_phase,
              cifar_f3ast_card_rerun_loss_max_abs_diff=float(np.abs(
                  again.train_loss - card[cifar][0].train_loss).max()),
              cifar_f3ast_tf32_vs_cpu_loss_max_abs_diff=float(np.abs(
                  tf32.train_loss - refs[cifar]["train_loss"]).max()),
              cifar_f3ast_tf32_bitwise_selection=(
                  tf32.sel_history.tobytes() == refs[cifar]["sel"].tobytes()),
              cpu_workers=len(cells), cpu_threads=PAPER_TASK_CPU_THREADS,
              launches=totals, fed_select_launches_by_mode=by_mode))
    return totals, agg


# ---------------------------------------------------------------------------
# host_async: the host loop, Power-of-Choice, checkpoints, the buffered
# server and the batched cells
# ---------------------------------------------------------------------------

HOST_ROUNDS = 300
HOST_POC_BUFFERED_ROUNDS = 150
HOST_SHORT_ROUNDS = 60
HOST_TASK_ROUNDS = 10
HOST_CELLS_SEEDS, HOST_CELLS_CAPS = [0, 1, 2, 3], [3, 5, 10, 10]
# PoC's fresh losses, card vs CPU, each round (relative)
POC_LOSS_RTOL = 1e-5
POC_D = 30          # the poc strategy's candidate count


def host_async_cells():
    """(name, spec JSON, CPU threads, wanted launches a round) of the
    phase's run_spec cells."""
    from repro_torch.sim import RunSpec, Scenario

    shakespeare = Scenario(name="homedevices", availability="homedevices",
                           task="shakespeare")
    cifar = Scenario(name="homedevices", availability="homedevices",
                     task="cifar")
    sync = dict(fed_select=1, fed_select_mask=0, fed_aggregate=1)
    cells = [
        ("host/shakespeare", RunSpec(scenario=shakespeare, engine="host",
                                     rounds=HOST_TASK_ROUNDS, eval_every=5),
         2, sync),
        ("buffered/shakespeare", RunSpec(
            scenario=shakespeare, aggregation="buffered",
            completion="deadline", rounds=HOST_TASK_ROUNDS, eval_every=5),
         2, sync),
        ("host/cifar", RunSpec(scenario=cifar, engine="host",
                               rounds=HOST_TASK_ROUNDS, eval_every=5), 2,
         sync),
        ("host/poc", RunSpec(strategy="poc", engine="host",
                             rounds=HOST_POC_BUFFERED_ROUNDS), 1,
         dict(fed_select=0, fed_select_mask=2, fed_aggregate=1)),
        ("host/f3ast", RunSpec(engine="host", rounds=HOST_ROUNDS), 1, sync),
        ("host/dropout", RunSpec(scenario="dropout", engine="host",
                                 rounds=HOST_SHORT_ROUNDS), 1,
         dict(fed_select=0, fed_select_mask=1, fed_aggregate=1)),
        ("buffered/device", RunSpec(scenario="straggler",
                                    aggregation="buffered",
                                    rounds=HOST_POC_BUFFERED_ROUNDS), 1,
         sync),
        ("buffered/host", RunSpec(scenario="straggler",
                                  aggregation="buffered", engine="host",
                                  rounds=HOST_POC_BUFFERED_ROUNDS), 1, sync),
    ]
    return [(name, spec.to_json(), threads, want)
            for name, spec, threads, want in cells]


@contextlib.contextmanager
def recording_select(log):
    """While active, each strategy ``repro_torch.sim.runner`` builds logs
    what the loop passes its ``select``: (key, avail, K_t, losses) as
    numpy.  A wrapper of ``make_strategy``, not a result field."""
    import numpy as np
    import torch
    from repro_torch.sim import runner

    real = runner.make_strategy

    def make(*args, **kwargs):
        s = real(*args, **kwargs)

        def select(state, key, avail, k_t, ctx=None):
            log.append(tuple(np.asarray(x.cpu() if torch.is_tensor(x) else x)
                             for x in (key, avail, k_t, ctx.losses)))
            return s.select(state, key, avail, k_t, ctx)
        return s._replace(select=select)
    runner.make_strategy = make
    try:
        yield
    finally:
        runner.make_strategy = real


@contextlib.contextmanager
def recording_params(box):
    """While active, the last parameters a round of the host loop returned
    are in ``box[0]`` (a wrapper of ``make_fed_round``)."""
    from repro_torch.sim import runner

    real = runner.make_fed_round

    def make(*args, **kwargs):
        fed_round = real(*args, **kwargs)

        def wrapped(*a, **k):
            out = fed_round(*a, **k)
            box[:] = [out[0]]
            return out
        return wrapped
    runner.make_fed_round = make
    try:
        yield
    finally:
        runner.make_fed_round = real


def run_fields(res) -> dict:
    """What the phase compares of a run (numpy, picklable)."""
    return dict(sel=res.sel_history, comp=res.comp_history, k_t=res.k_t,
                n_available=res.n_available, rates=res.rates,
                train_loss=res.train_loss, delta_norm=res.delta_norm,
                async_history=res.async_history, final=res.final_metrics)


def cpu_host_async(src: str, spec_json: str, threads: int) -> dict:
    """One host_async cell on the CPU, in a worker process (spawned: no
    CUDA); poc's select inputs recorded."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import warnings
    import torch
    from repro_torch.sim import RunSpec, run_spec

    torch.set_num_threads(threads)
    log = []
    t0 = time.perf_counter()
    with recording_select(log), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = run_spec(RunSpec.from_json(spec_json), device="cpu",
                       log_fn=lambda *a: None)
    return dict(run_fields(res), poc_inputs=log,
                wall_s=time.perf_counter() - t0)


def cpu_cells(src: str) -> dict:
    """The phase's batch of cells on the CPU, in a worker process."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    from repro_torch.sim import run_cells_vmapped

    torch.set_num_threads(1)
    return run_cells_vmapped("scarce", "f3ast", seeds=HOST_CELLS_SEEDS,
                             k_caps=HOST_CELLS_CAPS,
                             rounds=HOST_SHORT_ROUNDS, device="cpu")


def counted(torch, fn, extra=()):
    """``fn()`` with the three simulation kernels' launch counts, and those
    of the wrappers in ``extra``, set to 0 just before and read just after;
    returns (result, launches by wrapper name, wall)."""
    from repro_torch.kernels.fed_aggregate import fed_aggregate
    from repro_torch.kernels.fed_select import (fed_select, fed_select_mask,
                                                reset_launches)

    reset_launches()
    fed_aggregate.launches = 0
    for f in extra:
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fed_select=fed_select.launches,
                    fed_select_mask=fed_select_mask.launches,
                    fed_aggregate=fed_aggregate.launches)
    launches.update((f.__name__, f.launches) for f in extra)
    return out, launches, wall


def same_bits(a, b, fields) -> dict:
    """{field: bitwise equal} over run_fields dicts (async_history's
    fields too, where both have them)."""
    out = {f: a[f].tobytes() == b[f].tobytes() for f in fields}
    if a["async_history"] is not None:
        for f, v in a["async_history"].items():
            out[f] = v.tobytes() == b["async_history"][f].tobytes()
    return out


SELECTION = ("sel", "comp", "k_t", "n_available", "rates")


def poc_margin_rule(card_log, cpu_log, card, cpu, p):
    """Trouble spot 3's rule, card against CPU: each round's fresh losses
    within POC_LOSS_RTOL relative, and the masks bitwise in every round
    whose cut margin (the K_t-th minus the (K_t+1)-th candidate loss)
    exceeds the two runs' largest candidate-loss difference, or where both
    rank the same candidates above the K_t-th loss and tie the same ones
    with it.  Comparison stops at the first round under its margin.
    Returns (rounds compared, [round, margin, gap] or None, max rel
    diff)."""
    import numpy as np
    import torch
    from repro_torch.core.selection import fedavg_select

    def cut_sets(losses, ids, k):
        kth = np.sort(losses[ids])[::-1][min(k, len(ids)) - 1]
        return (set(ids[losses[ids] > kth].tolist()),
                set(ids[losses[ids] == kth].tolist()))

    compared, under, worst = 0, None, 0.0
    for t, (c, r) in enumerate(zip(card_log, cpu_log)):
        if c[0].tolist() != r[0].tolist() or c[1].tobytes() != \
                r[1].tobytes() or int(c[2]) != int(r[2]):
            raise AssertionError(f"host/poc round {t}: select inputs part")
        rel = float(np.max(np.abs(c[3] - r[3]) / np.abs(r[3])))
        worst = max(worst, rel)
        if rel > POC_LOSS_RTOL:
            raise AssertionError(f"host/poc round {t}: fresh losses part "
                                 f"by {rel} relative")
        cand = np.flatnonzero(fedavg_select(
            torch.from_numpy(r[0]), torch.from_numpy(r[1]), POC_D,
            p).numpy())
        k = int(r[2])
        cl = np.sort(r[3][cand])[::-1]
        margin = float(cl[k - 1] - cl[k]) if len(cl) > k else float("inf")
        gap = float(np.max(np.abs(c[3][cand] - r[3][cand])))
        if margin <= gap and cut_sets(c[3], cand, k) != cut_sets(r[3], cand,
                                                                 k):
            under = [t, margin, gap]
            break
        if card["sel"][t].tobytes() != cpu["sel"][t].tobytes():
            raise AssertionError(f"host/poc round {t}: masks part with "
                                 f"margin {margin} > gap {gap}")
        compared += 1
    return compared, under, worst


def fresh_losses_ms(torch, dev, reps: int = 5) -> float:
    """One pass of the host loop's fresh losses (100 evaluations of the
    synthetic task's loss on 64 samples, a host sync each) on ``dev``,
    the median of ``reps`` passes."""
    from repro_torch import random as jr
    from repro_torch.sim import build_task

    _, fed, init, loss, _ = build_task("synthetic11", 0, device=dev)
    params = init(jr.PRNGKey(0, device=dev))
    sets = [{k: torch.from_numpy(v[:64]).to(dev)
             for k, v in c.train.items()} for c in fed.clients]
    times = []
    with torch.no_grad():
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            for s in sets:
                float(loss(params, s))
            times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times[1:])[reps // 2]


def host_async_cli(dev, ckpt_dir):
    """``python -m repro_torch.launch.train --scenario straggler
    --aggregation buffered --engine host --ckpt-dir D --rounds 3`` on
    ``dev``, in its own process: exit 0, 3 JSONL records."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    metrics = Path(ckpt_dir) / "cli.jsonl"
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--scenario", "straggler", "--aggregation",
                          "buffered", "--engine", "host", "--ckpt-dir",
                          str(ckpt_dir), "--rounds", "3", "--metrics-jsonl",
                          str(metrics), "--device", str(dev)],
                         capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"train CLI exit {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    final = json.loads(out.stdout[out.stdout.index("{"):])
    records = metrics.read_text().splitlines()
    row = dict(phase="host_async", cell="cli", rc=out.returncode,
               records=len(records), wall_s=wall, device=final["device"],
               engine=final["engine"], aggregation=final["aggregation"])
    emit(row)
    if (len(records) != 3 or final["device"] != str(dev)
            or final["engine"] != "host"):
        raise AssertionError(f"train CLI: {row}")


def host_async(torch, dev, main_run):
    """The ninth slice's paths on the card, each held to the port's CPU
    run of the same spec (spawned workers, started first): the host loop
    under f3ast (against the card's main_path device run too), poc (the
    margin rule) and dropout (against the card's device run too); the
    buffered server on both executors (against each other too); the
    Shakespeare and CIFAR task cells on the host loop and Shakespeare on
    the buffered server; ``run_cells_vmapped`` (against each cell's
    single run on the card); the host/f3ast run's checkpoints; the CLI.
    Each cell's launches are counted alone and must be its round's."""
    import multiprocessing
    import tempfile
    import warnings
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    from repro_torch import random as jr
    from repro_torch.sim import RunSpec, build_task, run_cells_vmapped, \
        run_spec
    from repro_torch.sim.engine import _to_host, build_engine

    cells = host_async_cells()
    totals = dict(fed_select=0, fed_select_mask=0, fed_aggregate=0)
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="host_async_"))
    ctx = multiprocessing.get_context("spawn")
    src = str(ROOT / "src")
    with ProcessPoolExecutor(CPU_WORKERS, mp_context=ctx) as pool:
        cpu = {name: pool.submit(cpu_host_async, src, spec_json, threads)
               for name, spec_json, threads, _ in cells}
        cpu_batch = pool.submit(cpu_cells, src)
        try:
            card, logs, params_box = {}, {}, []
            for name, spec_json, _, want in cells:
                spec = RunSpec.from_json(spec_json)
                if name == "host/f3ast":
                    spec = spec.replace(ckpt_dir=str(tmp / "ckpt"))
                logs[name] = []
                with recording_select(logs[name]), \
                        recording_params(params_box), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    res, launches, wall = counted(torch, lambda: run_spec(
                        spec, device=dev, log_fn=lambda *a: None))
                rounds = spec.rounds
                wanted = {k: v * rounds for k, v in want.items()}
                if launches != wanted:
                    raise AssertionError(f"host_async {name}: launches "
                                         f"{launches}, wanted {wanted}")
                for k, v in launches.items():
                    totals[k] += v
                card[name] = (run_fields(res), launches, wall)
                if name == "host/f3ast":
                    final_params = params_box[0]
            # the card's device-engine runs the host loop is held to
            dropout_dev = run_fields(run_spec(
                RunSpec(scenario="dropout", rounds=HOST_SHORT_ROUNDS),
                device=dev, log_fn=lambda *a: None))
            batch, batch_launches, batch_wall = counted(
                torch, lambda: run_cells_vmapped(
                    "scarce", "f3ast", seeds=HOST_CELLS_SEEDS,
                    k_caps=HOST_CELLS_CAPS, rounds=HOST_SHORT_ROUNDS,
                    device=dev))
            n_batch = len(HOST_CELLS_SEEDS) * HOST_SHORT_ROUNDS
            if batch_launches != dict(fed_select=n_batch, fed_select_mask=0,
                                      fed_aggregate=n_batch):
                raise AssertionError(f"cells launches {batch_launches}")
            for k, v in batch_launches.items():
                totals[k] += v
            singles = []
            for seed, cap in zip(HOST_CELLS_SEEDS, HOST_CELLS_CAPS):
                engine, _ = build_engine("scarce", "f3ast", device=dev,
                                         seed=HOST_CELLS_SEEDS[0])
                carry = engine.init_carry(jr.PRNGKey(seed, device=dev))
                carry, out = engine.chunk(carry, range(HOST_SHORT_ROUNDS),
                                          k_cap=cap)
                singles.append((_to_host(out, engine.n_clients).sel_mask,
                                carry.algo_state.rates.r.cpu().numpy()))
            poc_ms = fresh_losses_ms(torch, dev)
            host_async_cli(dev, tmp / "cli")

            refs = {name: fut.result() for name, fut in cpu.items()}
            ref_batch = cpu_batch.result()
        finally:
            for fut in list(cpu.values()) + [cpu_batch]:
                fut.cancel()

    main_fields = run_fields(main_run)
    rows = []
    for name, _, _, _ in cells:
        got, launches, wall = card[name]
        ref = refs[name]
        tol = (PAPER_TASK_LOSS_TOL["cifar"] if name == "host/cifar"
               else LOSS_TOL)
        dtol = (PAPER_TASK_DNORM_TOL["cifar"] if name == "host/cifar"
                else LOSS_TOL)
        row = dict(phase="host_async", cell=name, rounds=len(got["k_t"]),
                   launches=launches,
                   steady_round_ms=steady_ms(got["final"]),
                   cpu_steady_round_ms=steady_ms(ref["final"]),
                   wall_s=wall, cpu_wall_s=ref["wall_s"],
                   engine=got["final"]["engine"],
                   test_acc=got["final"]["test_acc"],
                   cpu_test_acc=ref["final"]["test_acc"])
        loss_err = float(np.abs(got["train_loss"] - ref["train_loss"]).max())
        dnorm_err = float(np.abs(got["delta_norm"]
                                 - ref["delta_norm"]).max())
        row.update(train_loss_max_abs_err=loss_err, loss_tol=tol,
                   delta_norm_max_abs_err=dnorm_err, delta_norm_tol=dtol)
        ok = (loss_err <= tol and dnorm_err <= dtol
              and np.isfinite(got["train_loss"]).all())
        if name == "host/poc":
            p = torch.from_numpy(build_task("synthetic11", 0,
                                            device="cpu")[1].p)
            compared, under, worst = poc_margin_rule(
                logs[name], ref["poc_inputs"], got, ref, p)
            row.update(rounds_compared=compared, under_margin=under,
                       fresh_loss_max_rel_diff=worst,
                       fresh_losses_ms=poc_ms)
            ok = ok and compared + (under is not None) >= 1
        else:
            row["bitwise_vs_cpu"] = same_bits(got, ref, SELECTION)
            ok = ok and all(row["bitwise_vs_cpu"].values())
        if name == "host/f3ast":
            row["bitwise_vs_device_main_path"] = same_bits(
                dict(got, async_history=None), main_fields, SELECTION)
            ok = ok and all(row["bitwise_vs_device_main_path"].values())
            row["ckpt"] = ckpt = check_ckpt(tmp / "ckpt", got, final_params)
            ok = ok and ckpt["ok"]
        if name == "host/dropout":
            row["bitwise_vs_device"] = same_bits(
                dict(got, async_history=None), dropout_dev, SELECTION)
            ok = ok and all(row["bitwise_vs_device"].values())
        if name == "buffered/host":
            row["bitwise_vs_device_executor"] = same_bits(
                got, card["buffered/device"][0], SELECTION)
            ok = ok and all(row["bitwise_vs_device_executor"].values())
        emit(row)
        rows.append(row)
        if not ok:
            raise AssertionError(f"host_async cell {name} fails: {row}")
    row = dict(phase="host_async", cell="cells", rounds=HOST_SHORT_ROUNDS,
               seeds=HOST_CELLS_SEEDS, k_caps=HOST_CELLS_CAPS,
               launches=batch_launches, wall_s=batch_wall,
               steady_cell_round_ms=steady_ms(batch),
               cpu_steady_cell_round_ms=steady_ms(ref_batch),
               cpu_wall_s=ref_batch["wall_s"],
               bitwise_vs_cpu={f: batch[f].tobytes() == ref_batch[f].tobytes()
                               for f in ("sel_history", "comp_history",
                                         "rates")},
               bitwise_vs_single=[
                   s.tobytes() == batch["sel_history"][i].tobytes()
                   and r.tobytes() == batch["rates"][i].tobytes()
                   for i, (s, r) in enumerate(singles)],
               train_loss_max_abs_err=float(np.abs(
                   batch["train_loss"] - ref_batch["train_loss"]).max()))
    emit(row)
    if (not all(row["bitwise_vs_cpu"].values())
            or not all(row["bitwise_vs_single"])
            or row["train_loss_max_abs_err"] > LOSS_TOL):
        raise AssertionError(f"host_async cells fail: {row}")
    emit(dict(phase="host_async_summary", cells=len(rows) + 2,
              wall_s=time.perf_counter() - t_phase, cpu_workers=CPU_WORKERS,
              launches=totals))
    return totals


def steady_ms(final: dict):
    """ms a steady round (step) of a run's final metrics (None where the
    run had no steady rounds)."""
    rate = final.get("steady_rounds_per_s")
    return 1e3 / rate if rate else None


def check_ckpt(ckpt_dir, got, final_params) -> dict:
    """host/f3ast's checkpoints: state_00000100, 200 and 300 written; the
    last one, restored onto the CPU, bitwise the run's final r_k and
    parameters."""
    import numpy as np
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.tree import tree_leaves, tree_map

    files = sorted(p.name for p in Path(ckpt_dir).iterdir())
    like = {"params": tree_map(lambda x: x.detach().cpu(), final_params),
            "rates": np.zeros_like(got["rates"])}
    back = restore_checkpoint(str(Path(ckpt_dir) / "state_00000300.npz"),
                              like)
    params_ok = all(a.device.type == "cpu" and a.numpy().tobytes()
                    == b.numpy().tobytes()
                    for a, b in zip(tree_leaves(back["params"]),
                                    tree_leaves(like["params"])))
    out = dict(files=files, latest_step=latest_step(str(ckpt_dir)),
               rates_bitwise=back["rates"].tobytes()
               == got["rates"].tobytes(), params_bitwise=params_ok)
    out["ok"] = (files == ["state_00000100.npz", "state_00000200.npz",
                           "state_00000300.npz"]
                 and out["latest_step"] == 300 and out["rates_bitwise"]
                 and params_ok)
    return out


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
HD128_ATTN = (1, 4096, 32, 8, 128)  # two KV tiles a row at head dim 128
HD256_ATTN = (1, 512, 4, 2, 256)    # gemma's head dim, GQA
GEMMA_ATTN = (1, 8192, 16, 16, 256)  # gemma-7b prefill layer, B = 1
QWEN14_ATTN = (1, 2048, 40, 8, 128)  # qwen3-14b's group of 5 heads a KV head
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
    cases += [(HD256_ATTN, dtype, mode)
              for dtype in (torch.bfloat16, torch.float32)
              for mode in (*ATTN_MODES, "window32")]
    cases += [(shape, dtype, "causal") for shape in (GEMMA_ATTN, QWEN14_ATTN)
              for dtype in (torch.bfloat16, torch.float32)]
    modes = dict(ATTN_MODES, window32=WINDOW32)
    rows, max_err, llama, gemma = [], {}, {}, {}
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
        if shape in (LLAMA_ATTN, GEMMA_ATTN) and mode == "causal":
            (llama if shape == LLAMA_ATTN else gemma)[dname] = dict(
                max_abs_err=err, ref_rms=rms, err_over_rms=err / rms)
        if not ok:
            raise AssertionError(
                f"flash_attention {shape} {dtype} {mode}: max |err| {err} "
                f"(reference rms {rms}) over {tol}, or a bf16 lane more "
                f"than one step ({BF16_STEP} relative + {BF16_STEP_ATOL}) "
                f"from the plain output")
        del q, k, v, got, want, diff
    emit(dict(phase="flash_attention", checks=rows,
              max_abs_err_by_dtype=max_err, llama_shape=llama,
              gemma_shape=gemma))
    return llama["bfloat16"]["max_abs_err"]


def time_flash_attention(torch, dev):
    """The llama and gemma prefill layers' rows; returns llama's with
    gemma's under ``at_gemma``."""
    llama = time_flash_shape(torch, dev, LLAMA_ATTN)
    llama["at_gemma"] = time_flash_shape(torch, dev, GEMMA_ATTN)
    return llama


def time_flash_shape(torch, dev, shape):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    B, S, H, KV, hd = shape
    q, k, v = attn_inputs(torch, dev, shape, torch.bfloat16, 100)
    # the library yardstick takes (B, heads, S, hd); its copies are made
    # here, outside the timed calls
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = attn_pairs(S, S, True, 0)
    flops = 4.0 * B * H * hd * pairs          # QK^T and PV, 2 flops a MAC
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)  # q, o, k, v
    b, by = bound_ms(nbytes, flops, peak=BF16_FLOPS)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    row = dict(shape=list(shape), dtype="bfloat16", mode="causal",
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
# flash_attention's backward
# ---------------------------------------------------------------------------

BWD_MODES = {"causal": dict(causal=True, window=0, softcap=0.0),
             "window64": dict(causal=True, window=64, softcap=0.0),
             "softcap30": dict(causal=True, window=0, softcap=30.0)}
BWD_HEAD_DIMS = (32, 64, 128, 256)
BWD_GROUPS = (1, 4, 5)                # query heads a KV head
BWD_LENGTHS = ((2, 128), (1, 1000))   # (B, Sq = Skv); 1000 is ragged
LLAMA_TRAIN_ATTN = (1, 4096, 32, 8, 64)   # llama3.2-1b's training layer
QWEN8_TRAIN_ATTN = (1, 4096, 32, 8, 128)  # qwen3-8b's, B = 1
GEMMA_TRAIN_ATTN = (1, 4096, 16, 16, 256)  # gemma-7b's, B = 1
# zoo_train's layer as the kernels take it: vmap folds the K = 2 clients'
# B = 1 into the batch
ZOO_TRAIN_ATTN = (2, 4096, 32, 8, 64)
# the forward's lse against the plain forward's: both sum the same float32
# exponentials of scores formed in other orders (values near 9 at S = 4096,
# where a float32 step is 9.5e-7)
LSE_ATOL = 1e-5
# Kernel and plain backward both form every product and sum in float32, in
# other orders.  float32: each gradient within BWD_F32_TOL of its largest
# reference magnitude.  bf16: both round one float32 result once, so a
# lane may differ by one bf16 step of its magnitude, plus what the float32
# summation order moves a lane that cancels to near zero (BWD_BF16_ATOL of
# the largest magnitude).
BWD_F32_TOL = 1e-5
BWD_BF16_ATOL = 1e-5


def bwd_inputs(torch, dev, shape, dtype, mode, seed):
    """q, k, v and do of ``shape`` (B, S, H, KV, hd), and the plain
    forward's o and lse on them."""
    from repro_torch.kernels import ref
    q, k, v = attn_inputs(torch, dev, shape, dtype, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    o, lse = ref.sdpa_lse(q, k, v, **mode)
    return q, k, v, o, lse, do


def bwd_cases(torch):
    cases = [((B, S, 2 * G, 2, hd), dtype, mode)
             for dtype in (torch.float32, torch.bfloat16)
             for hd in BWD_HEAD_DIMS for G in BWD_GROUPS
             for B, S in BWD_LENGTHS for mode in BWD_MODES]
    cases += [((2, 256, 4, 2, 16), torch.bfloat16, "causal"),
              ((1, 1000, 8, 8, 64), torch.float32, "full")]
    cases += [(shape, dtype, "causal")
              for shape in (LLAMA_TRAIN_ATTN, QWEN8_TRAIN_ATTN,
                            GEMMA_TRAIN_ATTN)
              for dtype in (torch.bfloat16, torch.float32)]
    return [(*c, False) for c in cases] + [
        (ZOO_TRAIN_ATTN, dtype, "causal", True)
        for dtype in (torch.bfloat16, torch.float32)]


def check_forward_lse(torch, q, k, v, o, lse, mode):
    """The forward kernel's (o, lse), as the gradient's forward makes them,
    against the plain forward's ``o`` and ``lse``: o within ATTN_TOL (bf16:
    one step of the plain output, as ``check_flash_attention``), lse within
    LSE_ATOL.  Returns the kernel's (o, lse) and the errors."""
    from repro_torch.kernels.flash_attention import flash_attention_lse

    got_o, got_lse = flash_attention_lse(q, k, v, **mode)
    torch.cuda.synchronize()
    diff = (got_o.float() - o.float()).abs()
    o_err = float(diff.max())
    lse_err = float((got_lse - lse).abs().max())
    tol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    ok = (got_o.dtype == q.dtype and got_lse.shape == lse.shape
          and bool(torch.isfinite(got_lse).all()) and lse_err <= LSE_ATOL
          and bool(torch.allclose(got_o.float(), o.float(), rtol=tol,
                                  atol=tol)))
    if q.dtype == torch.bfloat16:
        over = diff - BF16_STEP * o.float().abs() - BF16_STEP_ATOL
        ok = ok and float(over.max()) <= 0.0
    if not ok:
        raise AssertionError(
            f"flash_attention_lse {tuple(q.shape)} {q.dtype}: o max |err| "
            f"{o_err} (limit {tol}, bf16 one step), lse max |err| {lse_err} "
            f"(limit {LSE_ATOL})")
    return got_o, got_lse, dict(o_max_abs_err=o_err, lse_max_abs_err=lse_err)


def grad_through_op(torch, q, k, v, do, mode):
    """(dq, dk, dv) of sum(flash_attention(q, k, v) * do) through the
    autograd Functions as the parallel round takes them: ``torch.func.vmap``
    of ``grad`` over the batch, one row a client, which the vmap rules fold
    back into one forward and one backward launch."""
    from torch.func import grad, vmap
    from repro_torch.kernels.flash_attention import flash_attention

    def loss(q, k, v, do):
        o = flash_attention(q[None], k[None], v[None], **mode)[0]
        return (o.float() * do.float()).sum()

    return vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v, do)


def check_flash_backward(torch, dev):
    """The backward kernel against ``ref.sdpa_bwd`` on the same q, k, v,
    o, lse and do; each case run twice, bitwise.  At zoo_train's layer
    both are given the forward kernel's o and lse (held first against the
    plain forward's), and the gradient through the autograd Functions
    under vmap must equal the kernel's bit for bit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    modes = dict(BWD_MODES, full=dict(causal=False, window=0, softcap=0.0))
    rows, max_err = [], {}
    for i, (shape, dtype, mode, own) in enumerate(bwd_cases(torch)):
        q, k, v, o, lse, do = bwd_inputs(torch, dev, shape, dtype,
                                         modes[mode], 300 + i)
        fwd = {}
        if own:
            o, lse, fwd = check_forward_lse(torch, q, k, v, o, lse,
                                            modes[mode])
        got = flash_attention_bwd(q, k, v, o, lse, do, **modes[mode])
        again = flash_attention_bwd(q, k, v, o, lse, do, **modes[mode])
        want = ref.sdpa_bwd(q, k, v, o, lse, do, **modes[mode])
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        ok, errs = bitwise, {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            gf, wf = g.float(), w.float()
            diff = (gf - wf).abs()
            scale = float(wf.abs().max())
            err = float(diff.max())
            if dtype == torch.bfloat16:
                over = diff - BF16_STEP * wf.abs() - BWD_BF16_ATOL * scale
                worst = float(over.max())
                ok = ok and worst <= 0.0
            else:
                worst = err - BWD_F32_TOL * scale
                ok = ok and worst <= 0.0
            ok = (ok and g.dtype == dtype and g.shape == w.shape
                  and bool(torch.isfinite(gf).all()))
            errs[name] = [err, scale]
            max_err[dname] = max(max_err.get(dname, 0.0), err)
        if own:
            before = flash_attention_bwd.launches
            chain = grad_through_op(torch, q, k, v, do, modes[mode])
            fwd["autograd_launches"] = flash_attention_bwd.launches - before
            fwd["autograd_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(chain, got))
            ok = (ok and fwd["autograd_bitwise"]
                  and fwd["autograd_launches"] == 1)
        rows.append(dict(shape=list(shape), dtype=dname, mode=mode,
                         o_lse="kernel" if own else "plain",
                         max_abs_err_and_ref_max=errs, bitwise_rerun=bitwise,
                         ok=ok, **fwd))
        if not ok:
            raise AssertionError(
                f"flash_attention_bwd {shape} {dtype} {mode}: errors "
                f"{errs} (max |err|, reference max), bitwise rerun "
                f"{bitwise}, {fwd}; limits: float32 {BWD_F32_TOL} of the "
                f"reference max, bf16 one step + {BWD_BF16_ATOL} of it; the "
                f"autograd chain one launch, bitwise")
        del q, k, v, o, lse, do, got, again, want
    emit(dict(phase="flash_backward", cases=len(rows),
              all_bitwise_rerun=all(r["bitwise_rerun"] for r in rows),
              max_abs_err_by_dtype=max_err, checks=rows))
    return max(max_err.values())


def time_flash_backward(torch, dev):
    """The backward at llama's training layer, zoo_train's folded layer
    and the qwen3-8b and gemma-7b training layers, causal: one row each;
    returns llama's with the others under ``at``."""
    rows = [time_bwd_shape(torch, dev, shape) for shape in (
        LLAMA_TRAIN_ATTN, ZOO_TRAIN_ATTN, QWEN8_TRAIN_ATTN, GEMMA_TRAIN_ATTN)]
    rows[0]["at"] = rows[1:]
    return rows[0]


def time_bwd_shape(torch, dev, shape):
    """The kernel on bf16 inputs (the tensor-core route, ``ms``) and on
    float32 inputs (the CUDA-core route, ``f32_ms``), its plain version,
    and SDPA's backward alone (``torch.autograd.grad`` of one recorded
    forward, the graph retained), beside the bound: the five products of
    the backward over 989 TFLOP/s bf16, or its bytes, the larger."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    B, S, H, KV, hd = shape
    mode = BWD_MODES["causal"]
    q, k, v, o, lse, do = bwd_inputs(torch, dev, shape, torch.bfloat16,
                                     mode, 200)
    pairs = attn_pairs(S, S, True, 0)
    flops = 10.0 * B * H * hd * pairs        # S, dP, dV, dK, dQ
    # q, o, do, dq and k, v, dk, dv in bf16, lse in float32
    nbytes = 2 * 4 * (B * S * H * hd + B * S * KV * hd) + 4 * B * H * S
    b, by = bound_ms(nbytes, flops, peak=BF16_FLOPS)
    f32 = [x.float() for x in (q, k, v, o)] + [lse, do.float()]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    row = dict(shape=list(shape), dtype="bfloat16", mode="causal",
               ms=cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                      **mode),
                          warmup=2, runs=9),
               f32_ms=cuda_ms(lambda: flash_attention_bwd(*f32, **mode),
                              warmup=1, runs=5),
               plain_ms=cuda_ms(lambda: ref.sdpa_bwd(q, k, v, o, lse, do,
                                                     **mode),
                                warmup=1, runs=5),
               library_ms=cuda_ms(lambda: torch.autograd.grad(
                   out, (qt, kt, vt), dot, retain_graph=True),
                   warmup=3, runs=15),
               bound_ms=b, bound_by=by, flops=flops, bytes=nbytes)
    row["tflops_per_s"] = flops / row["ms"] / 1e9
    row["bound_share"] = b / row["ms"]
    row["f32_over_bf16"] = row["f32_ms"] / row["ms"]
    emit(dict(phase="flash_bwd_timing", kernel=row))
    del q, k, v, o, lse, do, f32, qt, kt, vt, dot, out
    return row


# ---------------------------------------------------------------------------
# clients: the million-client path and the client-sharded engine
# ---------------------------------------------------------------------------

CLIENTS_N = 1_000_000
CLIENTS_N_BIG = 10_000_000
# chunks of at most 25 rounds (as the JAX benchmark's _time_engine drives
# engine.chunk), with boundaries at the comparison points, rounds 20 and 30
CLIENTS_SPANS = ((0, 20), (20, 30), (30, 50), (50, 75), (75, 100))
CLIENTS_CPU_ROUNDS = 20
CLIENTS_BIG_SPANS = ((0, 2), (2, 5))
CLIENTS_BIG_CPU_S = 60.0
CLIENTS_SHARDED_ROUNDS = 30
CLIENTS_CPU_THREADS = 3
STREAM_FIELDS = ("sel_mask", "completed", "k_t", "n_available",
                 "train_loss", "delta_norm")


def nscale_engine(n: int, dev, mesh=None, topk_impl: str = "stream"):
    """The JAX package's N-scaling cell
    (``benchmarks/bench_engine.py::_build_nscale_engine``) on the port,
    clients synthesized on demand: SynthTask dim 32, 10 classes, 64
    samples a client; bernoulli q = 0.3; constant K = 10; f3ast (p = 1/N);
    server sgd lr 1.0, client lr 0.05, E = 5, B = 20.  With a client
    ``mesh``, this process's shard of the sharded engine."""
    import functools

    import numpy as np
    from repro_torch.core.fedstep import make_fed_round
    from repro_torch.core.strategies import make_strategy
    from repro_torch.data import SynthTask
    from repro_torch.models import softmax_reg
    from repro_torch.optim import make_optimizer
    from repro_torch.sim import DeviceEngine, ShardedEngine
    from repro_torch.sim.budgets import make_budget
    from repro_torch.sim.processes import make_process

    k = 10
    cfg = softmax_reg.SoftmaxRegConfig(dim=32, n_classes=10)
    loss = functools.partial(softmax_reg.loss_fn, cfg)
    opt = make_optimizer("sgd", lr=1.0)
    common = dict(
        avail_model=make_process("bernoulli", n, q=0.3, device=dev),
        budget=make_budget("constant", k=k, device=dev),
        strategy=make_strategy("f3ast", n, np.full(n, 1.0 / n, np.float32),
                               clients_per_round=k, device=dev),
        init_params=functools.partial(softmax_reg.init_params, cfg,
                                      device=dev),
        opt=opt, client_lr=0.05, local_steps=5, local_batch=20, device=dev)
    task = SynthTask(n_clients=n, dim=32, n_classes=10,
                     samples_per_client=64, seed=0)
    if mesh is None:
        return DeviceEngine(staged=task, fed_round=make_fed_round(loss, opt),
                            **common)
    return ShardedEngine(mesh=mesh, staged=task, n_clients=n,
                         topk_impl=topk_impl,
                         fed_round=make_fed_round(loss, opt, cohort_axis=mesh,
                                                  cohort_slots=k), **common)


def drive_engine(engine, dev, spans, keep=()):
    """``engine.chunk`` over ``spans`` with one host sync a chunk (the
    stream pulled and unpacked); returns (the streams concatenated, r_k
    after each round in ``keep``, (rounds, wall s) a chunk, the carry)."""
    import numpy as np
    from repro_torch import random as jr
    from repro_torch.sim.engine import _to_host

    carry = engine.init_carry(jr.PRNGKey(0, device=dev))
    outs, rates, walls = [], {}, []
    for t0, t1 in spans:
        w0 = time.perf_counter()
        carry, out = engine.chunk(carry, range(t0, t1))
        outs.append(_to_host(out, engine.n_clients))
        walls.append((t1 - t0, time.perf_counter() - w0))
        if t1 in keep:
            rates[t1] = carry.algo_state.rates.r.cpu().numpy()
    streams = {f: np.concatenate([getattr(o, f) for o in outs])
               for f in STREAM_FIELDS}
    return streams, rates, walls, carry


def steady_chunk_ms(walls):
    """ms a round over every chunk but the first."""
    rounds = sum(r for r, _ in walls[1:])
    return 1e3 * sum(w for _, w in walls[1:]) / rounds if rounds else None


def clients_cpu(src: str, n: int, spans, threads: int, results) -> None:
    """The cell on the CPU, in a spawned worker (no CUDA): its streams, r_k
    after the last span and the wall a round."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    torch.set_num_threads(threads)
    engine = nscale_engine(n, torch.device("cpu"))
    t0 = time.perf_counter()
    streams, rates, walls, _ = drive_engine(engine, "cpu", spans,
                                            keep=(spans[-1][1],))
    results.put(dict(streams=streams, rates=rates,
                     wall_s=time.perf_counter() - t0,
                     ms=1e3 * sum(w for _, w in walls)
                     / sum(r for r, _ in walls)))


def start_cpu(ctx, *args):
    """A spawned :func:`clients_cpu` worker and its result queue."""
    results = ctx.Queue()
    proc = ctx.Process(target=clients_cpu, args=(str(ROOT / "src"),) + args
                       + (results,), daemon=True)
    proc.start()
    return proc, results


def finish_cpu(proc, results, timeout):
    """The worker's result, or None (the worker stopped) after
    ``timeout`` s."""
    import queue
    try:
        out = results.get(timeout=timeout)
    except queue.Empty:
        out = None
    if out is None:
        proc.terminate()
    proc.join()
    if out is None and proc.exitcode not in (None, 0, -15):
        raise AssertionError(f"clients CPU worker exited {proc.exitcode}")
    return out


def same_streams(a: dict, b: dict, rounds: int) -> dict:
    """{field: bitwise} over the first ``rounds`` of two runs' streams."""
    return {f: a[f][:rounds].tobytes() == b[f][:rounds].tobytes()
            for f in ("sel_mask", "completed", "k_t", "n_available")}


def stream_errs(a: dict, b: dict, rounds: int) -> dict:
    """{train_loss, delta_norm: max abs difference} over the first
    ``rounds`` of two runs' streams (each held within LOSS_TOL)."""
    import numpy as np
    return {f + "_max_abs_err": float(np.abs(
        a[f][:rounds] - b[f][:rounds]).max())
        for f in ("train_loss", "delta_norm")}


def clients_mesh_rank(mesh, device: str, n: int, rounds: int,
                      with_run_spec: bool):
    """One rank of cells 4 and 5 of :func:`clients`, in one spawn: the
    sharded engine driven ``rounds`` rounds under each ``topk_impl``,
    then (``with_run_spec``) ``run_spec(RunSpec(mesh_shape=(2,)))``
    inside this initialized group, as under torchrun.  Each cell's
    launches on this rank, and from rank 0 its streams, r_k, steady ms
    and comm bytes (the run_spec cell: its result)."""
    import torch
    from repro_torch.sim import RunSpec, run_spec
    dev = torch.device(device)
    if mesh.backend == "nccl":
        dev = torch.device("cuda", mesh.rank)
    torch.cuda.set_device(dev)
    lead = mesh.rank == 0
    out = {}
    for impl in ("stream", "allgather"):
        engine = nscale_engine(n, dev, mesh=mesh, topk_impl=impl)
        spans = ((0, 10), (10, 20), (20, rounds))
        (streams, rates, walls, _), launches, _ = counted(
            torch, lambda: drive_engine(engine, dev, spans, keep=(rounds,)))
        out[impl] = dict(launches=launches,
                         streams=streams if lead else None,
                         rates=rates[rounds] if lead else None,
                         steady_round_ms=steady_chunk_ms(walls),
                         comm=engine.selection_comm_bytes_per_round,
                         staged=engine.n_staged_bytes)
        del engine
    if with_run_spec:
        res, launches, wall = counted(torch, lambda: run_spec(
            RunSpec(mesh_shape=(mesh.size,)), device=dev,
            log_fn=lambda *a: None))
        out["run_spec"] = dict(
            launches=launches, wall_s=wall,
            res=None if not lead else dict(
                sel=res.sel_history, comp=res.comp_history, k_t=res.k_t,
                n_available=res.n_available, rates=res.rates,
                train_loss=res.train_loss, delta_norm=res.delta_norm,
                final=res.final_metrics))
    return out


def add_launches(totals, launches):
    for k, v in launches.items():
        totals[k] += v


def clients(torch, dev, main_run):
    """The million-client path on the card (the JAX package's N-scaling
    cell, clients synthesized on demand, masks streamed packed):

    1. ``device`` at N = 10^6, 100 rounds: its first 20 rounds bitwise
       the same cell on the CPU (masks, K_t, |avail|, r_k after round 20;
       losses and delta norms within LOSS_TOL); ``fed_select`` (its cooperative path) and
       ``fed_aggregate`` once a round; peak memory; 0 staged bytes;
    2. a profiled window of 3 steady rounds of it;
    3. ``device`` at N = 10^7, 5 rounds: |S_t| = min(K_t, |avail_t|), the
       launches, peak memory; its first 2 rounds against the CPU where
       that finishes within CLIENTS_BIG_CPU_S (losses and delta norms
       too);
    4. ``sharded`` at N = 10^6 over 2 ranks on the one card (gloo), 30
       rounds under each ``topk_impl``: masks, K_t, |avail| and r_k
       bitwise cell 1's card run, losses and delta norms within LOSS_TOL; ``fed_select_mask`` (each shard's
       candidate cut) and ``fed_aggregate`` once a round a shard (NCCL
       across cards is ``chip_mesh_nccl.py``'s);
    5. ``run_spec(RunSpec(mesh_shape=(2,)))`` (gloo), 300 rounds, inside
       the same group of 2 spawned ranks: bitwise ``main_path``'s device
       run, losses and delta norms within LOSS_TOL.
    The CPU runs go first, in spawned workers of CLIENTS_CPU_THREADS
    threads, while the card runs."""
    import multiprocessing

    import numpy as np
    from repro_torch.launch.mesh import spawn_ranks

    t_phase = time.perf_counter()
    totals = dict(fed_select=0, fed_select_mask=0, fed_aggregate=0)
    ctx = multiprocessing.get_context("spawn")
    cpu1 = start_cpu(ctx, CLIENTS_N, ((0, CLIENTS_CPU_ROUNDS),),
                     CLIENTS_CPU_THREADS)
    cpu_big = start_cpu(ctx, CLIENTS_N_BIG, (CLIENTS_BIG_SPANS[0],),
                        CLIENTS_CPU_THREADS)
    t_big_cpu = time.perf_counter()
    try:
        # 1. device, N = 10^6
        engine = nscale_engine(CLIENTS_N, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        (card, rates, walls, carry), launches1, _ = counted(
            torch, lambda: drive_engine(
                engine, dev, CLIENTS_SPANS,
                keep=(CLIENTS_CPU_ROUNDS, CLIENTS_SHARDED_ROUNDS)))
        peak1 = torch.cuda.max_memory_allocated(dev)
        add_launches(totals, launches1)
        rounds1 = CLIENTS_SPANS[-1][1]
        if launches1 != dict(fed_select=rounds1, fed_select_mask=0,
                             fed_aggregate=rounds1):
            raise AssertionError(f"clients device launches {launches1}")
        # 2. profiled window of 3 steady rounds
        box = [carry]

        def window():
            box[0], _ = engine.chunk(box[0], range(rounds1, rounds1 + 3))
        (prof, _), launches, _ = counted(torch, lambda: device_profile(
            torch, window, steps=3, kernel_name="fed_select"))
        add_launches(totals, launches)
        emit(dict(phase="clients", cell="profile", n=CLIENTS_N, rounds=3,
                  **prof))
        del engine, carry, box

        # 3. device, N = 10^7
        engine = nscale_engine(CLIENTS_N_BIG, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        (big, big_rates, big_walls, _), launches3, _ = counted(
            torch, lambda: drive_engine(engine, dev, CLIENTS_BIG_SPANS,
                                        keep=(CLIENTS_BIG_SPANS[0][1],)))
        peak3 = torch.cuda.max_memory_allocated(dev)
        add_launches(totals, launches3)
        del engine
        torch.cuda.empty_cache()
        rounds3 = CLIENTS_BIG_SPANS[-1][1]
        sizes_ok = bool((big["sel_mask"].sum(1) == np.minimum(
            big["k_t"], big["n_available"])).all())
        if not sizes_ok or launches3 != dict(
                fed_select=rounds3, fed_select_mask=0,
                fed_aggregate=rounds3):
            raise AssertionError(f"clients 1e7: |S_t| ok {sizes_ok}, "
                                 f"launches {launches3}")

        # 4. sharded, d = 2 on the one card (gloo), and 5. run_spec with
        # mesh_shape=(2,) in the same group
        t0 = time.perf_counter()
        ranks = spawn_ranks(clients_mesh_rank, 2, str(dev), CLIENTS_N,
                            CLIENTS_SHARDED_ROUNDS, True, backend="gloo",
                            threads=2)
        spawn_wall = time.perf_counter() - t0
        for r in ranks:
            for cell in r.values():
                add_launches(totals, cell["launches"])

        ref1 = finish_cpu(*cpu1, timeout=600)
        left = CLIENTS_BIG_CPU_S - (time.perf_counter() - t_big_cpu)
        ref_big = finish_cpu(*cpu_big, timeout=max(left, 0.1))
    finally:
        for proc, _ in (cpu1, cpu_big):
            if proc.is_alive():
                proc.terminate()
                proc.join()

    rows = []
    # cell 1 against its CPU run
    bit1 = same_streams(card, ref1["streams"], CLIENTS_CPU_ROUNDS)
    bit1["r_after_20"] = (rates[CLIENTS_CPU_ROUNDS].tobytes()
                          == ref1["rates"][CLIENTS_CPU_ROUNDS].tobytes())
    errs1 = stream_errs(card, ref1["streams"], CLIENTS_CPU_ROUNDS)
    rows.append(dict(
        phase="clients", cell="device", n=CLIENTS_N, rounds=rounds1,
        steady_round_ms=steady_chunk_ms(walls), wall_s=sum(
            w for _, w in walls), cpu_round_ms=ref1["ms"],
        cpu_rounds=CLIENTS_CPU_ROUNDS, cpu_threads=CLIENTS_CPU_THREADS,
        launches=launches1, peak_mem_gib=peak1 / 2 ** 30,
        n_staged_bytes=0, bitwise_vs_cpu=bit1, **errs1, tol=LOSS_TOL,
        mean_available=float(card["n_available"].mean())))
    ok = all(bit1.values()) and max(errs1.values()) <= LOSS_TOL
    # cell 3
    row3 = dict(phase="clients", cell="device", n=CLIENTS_N_BIG,
                rounds=rounds3, steady_round_ms=steady_chunk_ms(big_walls),
                round_ms=[1e3 * w / r for r, w in big_walls],
                launches=launches3, peak_mem_gib=peak3 / 2 ** 30,
                sizes_min_k_avail=sizes_ok)
    if ref_big is None:
        row3["cpu_compare"] = (f"did not finish within "
                               f"{CLIENTS_BIG_CPU_S:.0f} s")
    else:
        n_cmp = CLIENTS_BIG_SPANS[0][1]
        bit3 = same_streams(big, ref_big["streams"], n_cmp)
        bit3["r_after_2"] = (big_rates[n_cmp].tobytes()
                             == ref_big["rates"][n_cmp].tobytes())
        errs3 = stream_errs(big, ref_big["streams"], n_cmp)
        row3.update(cpu_rounds=n_cmp, cpu_round_ms=ref_big["ms"],
                    bitwise_vs_cpu=bit3, **errs3, tol=LOSS_TOL)
        ok &= all(bit3.values()) and max(errs3.values()) <= LOSS_TOL
    rows.append(row3)
    # cell 4 against cell 1's card run
    for impl in ("stream", "allgather"):
        r0 = ranks[0][impl]
        bit = same_streams(card, r0["streams"], CLIENTS_SHARDED_ROUNDS)
        bit["r_after_30"] = (r0["rates"].tobytes() == rates[
            CLIENTS_SHARDED_ROUNDS].tobytes())
        errs = stream_errs(card, r0["streams"], CLIENTS_SHARDED_ROUNDS)
        launches = {k: sum(r[impl]["launches"][k] for r in ranks)
                    for k in totals}
        rows.append(dict(
            phase="clients", cell="sharded", backend="gloo", shards=2,
            n=CLIENTS_N, rounds=CLIENTS_SHARDED_ROUNDS, topk_impl=impl,
            steady_round_ms=r0["steady_round_ms"],
            rank_steady_round_ms=[r[impl]["steady_round_ms"] for r in ranks],
            selection_comm_bytes_per_round=r0["comm"],
            n_staged_bytes=r0["staged"], launches=launches,
            bitwise_vs_device=bit, **errs, tol=LOSS_TOL,
            spawn_wall_s=spawn_wall))
        ok &= (all(bit.values()) and max(errs.values()) <= LOSS_TOL
               and launches["fed_select_mask"] == 2 * CLIENTS_SHARDED_ROUNDS
               and launches["fed_aggregate"] == 2 * CLIENTS_SHARDED_ROUNDS)
    # cell 5 against main_path's device run
    rs_ranks = [r["run_spec"] for r in ranks]
    res5 = rs_ranks[0]["res"]
    bit5 = {
        "sel_mask": res5["sel"].tobytes() == main_run.sel_history.tobytes(),
        "completed": (res5["comp"].tobytes()
                      == main_run.comp_history.tobytes()),
        "k_t": res5["k_t"].tobytes() == main_run.k_t.tobytes(),
        "n_available": (res5["n_available"].tobytes()
                        == main_run.n_available.tobytes()),
        "final_r": res5["rates"].tobytes() == main_run.rates.tobytes()}
    errs5 = {"train_loss_max_abs_err": float(np.abs(
        res5["train_loss"] - main_run.train_loss).max()),
        "delta_norm_max_abs_err": float(np.abs(
            res5["delta_norm"] - main_run.delta_norm).max())}
    launches5 = {k: sum(r["launches"][k] for r in rs_ranks) for k in totals}
    rounds5 = int(res5["sel"].shape[0])
    rows.append(dict(
        phase="clients", cell="run_spec_mesh", mesh_shape=[2],
        backend="gloo", rounds=rounds5, engine=res5["final"]["engine"],
        steady_round_ms=steady_ms(res5["final"]),
        main_path_steady_round_ms=steady_ms(main_run.final_metrics),
        selection_comm_bytes_per_round=res5["final"][
            "selection_comm_bytes_per_round"],
        launches=launches5, bitwise_vs_main_path=bit5, **errs5,
        tol=LOSS_TOL, wall_s=rs_ranks[0]["wall_s"]))
    ok &= (all(bit5.values()) and max(errs5.values()) <= LOSS_TOL
           and res5["final"]["engine"] == "sharded"
           and launches5["fed_select_mask"] == 2 * rounds5
           and launches5["fed_aggregate"] == 2 * rounds5)
    for row in rows:
        emit(row)
    emit(dict(phase="clients_summary", cells=len(rows), launches=totals,
              wall_s=time.perf_counter() - t_phase))
    if not ok:
        raise AssertionError("clients: a cell departs from its reference")
    return totals


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
                   profiled=device_profile(
                       torch, lambda: transformer.prefill(cfg, params, batch),
                       kernel_name="flash_kernel")[0])
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
# dense path: qwen3-8b, qwen3-14b and gemma-7b at full width
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("qwen3-8b", "qwen3-14b", "gemma-7b")
INIT_WINDOW = 4096          # lanes of each drawn row re-drawn on the CPU


class DrawWindows:
    """Windows of one drawn leaf re-drawn on the CPU: ``parts`` maps
    (layer row, first lane) to the lanes' values."""

    def __init__(self, parts):
        self.parts = parts


def sampled_init_check(torch, cfg, seed, dev):
    """The card's ``init_params`` of ``cfg`` against the CPU's, without
    drawing the full widths on the CPU: the CPU walks the same key tree
    (``init_params`` with ``layers._normal`` replaced) and re-draws, for
    each drawn leaf and each layer's row of it, the first and the last
    INIT_WINDOW lanes and the window that straddles the draw's first
    2^24-lane chunk boundary, with the same ``random.normal(start=)``;
    every undrawn leaf (the norms) is compared whole.  Returns (the card's
    parameters, the windows and leaves compared, the paths that differ)."""
    import math

    from repro_torch import random as jr
    from repro_torch.models import layers, transformer

    card = transformer.init_params(cfg, jr.PRNGKey(seed, device=dev), dev)
    chunk = layers._DRAW_CHUNK

    def windows(keys, shape, scale, dtype, *, divide=False):
        n = math.prod(shape)
        starts = sorted({0, max(0, n - INIT_WINDOW)}
                        | ({chunk - INIT_WINDOW // 2} if n > chunk else set()))
        out = {}
        for i, key in enumerate(keys.reshape(-1, 2)):
            for s in starts:
                m = min(INIT_WINDOW, n - s)
                x = jr.normal(key, m, start=s)
                out[(i, s)] = (x / scale if divide else x * scale).to(dtype)
        return DrawWindows(out)

    saved = (layers._normal, transformer._normal)
    layers._normal = transformer._normal = windows
    try:
        cpu = transformer.init_params(cfg, jr.PRNGKey(seed, device="cpu"),
                                      "cpu")
    finally:
        layers._normal, transformer._normal = saved
    compared, differ = 0, []
    leaves = dict(tree_items(card))
    for path, want in tree_items(cpu):
        got = leaves[path]
        if isinstance(want, DrawWindows):   # windows of each layer's row
            rows = got.reshape(len({i for i, _ in want.parts}), -1)
            for (i, s), w in want.parts.items():
                compared += 1
                if not same_tensor_bits(torch, rows[i, s:s + w.numel()].cpu(),
                                        w):
                    differ.append(f"{path}[{i}, {s}:]")
        else:
            compared += 1
            if not same_tensor_bits(torch, got.cpu(), want):
                differ.append(path)
    return card, compared, differ


def same_tensor_bits(torch, a, b) -> bool:
    """Equal dtypes, shapes and bits (NaNs and signed zeros included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(as_int),
                       b.contiguous().view(as_int))


def dense_path(torch, dev):
    """Each dense arch at full width through ``launch.serve``'s entry
    points; returns the flash launches of their prefills."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve, serve_params
    from repro_torch.models import transformer

    total = 0
    for name in DENSE_ARCHS:
        torch.cuda.empty_cache()
        cfg = get_arch(name).model
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = serve_params(name, 0, smoke=False, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in tree_leaves(params))
        gen = torch.Generator(device=dev).manual_seed(2)
        batch = {"tokens": torch.randint(0, cfg.vocab, (1, 8192),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)}

        # (a) prefill, B = 1, S = 8192, one flash launch a layer
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = transformer.prefill(cfg, params, batch)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        launches = flash_attention.launches
        finite = bool(torch.isfinite(logits).all())
        if (launches != cfg.n_layers or not finite
                or tuple(logits.shape) != (1, 1, cfg.vocab)):
            raise AssertionError(
                f"{name} prefill: {launches} flash launches (want "
                f"{cfg.n_layers}), finite {finite}, shape "
                f"{tuple(logits.shape)}")
        total += launches
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            transformer.prefill(cfg, params, batch)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.reset_peak_memory_stats()
        prof = device_profile(
            torch, lambda: transformer.prefill(cfg, params, batch),
            kernel_name="flash_kernel")[0]
        # bf16 q, k, v reach the tensor-core route and nothing else
        if not prof["kernel_names"] or any(
                "flash_kernel_mma" not in n for n in prof["kernel_names"]):
            raise AssertionError(f"{name}: profiled flash kernels "
                                 f"{prof['kernel_names']}")
        prefill = dict(batch=1, seq_len=8192, layers=cfg.n_layers,
                       head_dim=cfg.head_dim, dtype=cfg.dtype,
                       n_params=n_params, init_params_s=init_s,
                       flash_launches=launches, logits_finite=finite,
                       first_call_ms=first_ms,
                       wall_ms_median_of_3=sorted(walls)[1],
                       wall_ms_runs=walls,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       profiled=prof)
        del logits

        # (b) a few decode tokens through serve, on the same weights
        flash_attention.launches = 0
        res = serve(name, steps=8, smoke=False, device=dev, params=params,
                    log_fn=lambda *a: None)
        if flash_attention.launches != 0 or res.tokens.shape != (4, 8):
            raise AssertionError(f"{name} serve: {flash_attention.launches} "
                                 f"flash launches, tokens "
                                 f"{res.tokens.shape}")
        served = dict(batch=4, prompt_len=16, steps=8,
                      tokens_per_s=res.tokens_per_s, decode_s=res.decode_s,
                      first_tokens=res.tokens[0].tolist())
        del params
        torch.cuda.empty_cache()

        # (c) the full widths at depth 2: the card's draws against the
        # CPU's at two seeds, then the card's float32 logits (kernel)
        # against the CPU's (plain) on the same weights
        cfg2 = cfg.replace(n_layers=2)
        init_rows = []
        for seed, dtype in ((0, "bfloat16"), (3, "float32")):
            p2, compared, differ = sampled_init_check(
                torch, cfg2.replace(dtype=dtype), seed, dev)
            init_rows.append(dict(seed=seed, dtype=dtype, compared=compared,
                                  not_bitwise=differ))
            if differ:
                raise AssertionError(f"{name} depth-2 init seed {seed} "
                                     f"{dtype}: card differs in {differ}")
        cfg2 = cfg2.replace(dtype="float32")
        toks = torch.randint(0, cfg.vocab, (1, 512), generator=gen,
                             device=dev, dtype=torch.int32)
        flash_attention.launches = 0
        card = transformer.prefill(cfg2, p2, {"tokens": toks})
        torch.cuda.synchronize()
        card_launches = flash_attention.launches
        cpu = transformer.prefill(cfg2, _tree_to(p2, "cpu"),
                                  {"tokens": toks.cpu()})
        card_vs_cpu = float((card.cpu() - cpu).abs().max())
        if card_launches != 2 or not card_vs_cpu <= 1e-4:
            raise AssertionError(f"{name} depth-2 card vs CPU: "
                                 f"{card_vs_cpu} ({card_launches} launches)")
        del p2, card, cpu
        emit(dict(phase="dense_path", arch=name, prefill=prefill,
                  serve=served, depth2_init=init_rows,
                  depth2_f32_card_vs_cpu_max_abs_err=card_vs_cpu))
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# zoo_train: llama3.2-1b's federated round at full width
# ---------------------------------------------------------------------------

ZOO_ARCH = "llama3.2-1b"
ZOO_SHAPE = (2, 2, 1, 4096)         # K, E, B, S; FedExec's K = 32, B = 8
ZOO_ROUNDS = 4                      # the first is the warm-up
ZOO_DEPTH2_SHAPE = (2, 1, 1, 512)   # the card-vs-CPU round, float32
ZOO_CPU_THREADS = 5
# The depth-2 round, card against CPU.  The loss and the delta norm,
# relative: measured equal in every bit (NVIDIA H100 80GB HBM3, 700 W).
# Each leaf of the delta, a stacked block leaf per layer: its norm,
# relative (measured at most 3.2e-7), and its largest lane gap over its
# largest lane (measured at most 5.0e-4, in wq of the last layer, where
# dS = P (dP - D) cancels).  chip_grad_sensitivity.py shows what they fail.
ZOO_TOL = 1e-6
ZOO_LEAF_NORM_TOL = 1e-6
ZOO_LEAF_MAX_TOL = 2e-3


def zoo_depth2_arch():
    """llama3.2-1b at its full widths, 2 layers, float32, E = 1."""
    import dataclasses
    from repro_torch.configs import get_arch
    arch = get_arch(ZOO_ARCH)
    return dataclasses.replace(
        arch, model=arch.model.replace(n_layers=2, dtype="float32"),
        fed=dataclasses.replace(arch.fed, local_steps=ZOO_DEPTH2_SHAPE[1]))


def zoo_round_cpu(src: str, path: str, threads: int, results) -> None:
    """The depth-2 round on the CPU (a spawned worker), from the card's
    parameters saved at ``path``; Adam's first moment after it, (1 - b1)
    times the round's delta, is saved at ``path`` with ``.m`` added."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    from repro_torch import random as jr
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import federated_rounds

    torch.set_num_threads(threads)
    arch = zoo_depth2_arch()
    fed_round, opt, _ = build_train_step(arch, "train_4k", device="cpu")
    params = torch.load(path)
    t0 = time.perf_counter()
    (_, sel, m, state), = federated_rounds(
        fed_round, params, opt.init(params), jr.PRNGKey(1, device="cpu"),
        vocab=arch.model.vocab, shape=ZOO_DEPTH2_SHAPE, rounds=1)
    wall = time.perf_counter() - t0
    torch.save(state.m, path + ".m")
    results.put(dict(mask=sel.numpy(), loss=float(m.loss),
                     delta_norm=float(m.delta_norm), wall_s=wall))


def delta_leaf_gaps(torch, card, cpu):
    """{leaf (a stacked block leaf per layer): [relative error of its norm,
    max |card - cpu| over max |cpu|]} of two trees of one shape."""
    gaps = {}
    for (name, a), (_, b) in zip(tree_items(card), tree_items(cpu)):
        a = a.cpu()
        layers = ([(f"{name}[{i}]", a[i], b[i]) for i in range(a.shape[0])]
                  if name.startswith("blocks/") else [(name, a, b)])
        for n, x, y in layers:
            ny, my = float(y.norm()), float(y.abs().max())
            gaps[n] = [abs(float(x.norm()) - ny) / ny,
                       float((x - y).abs().max()) / my]
    return gaps


def zoo_train(torch, dev):
    """llama3.2-1b trained through ``launch.steps.build_train_step`` and the
    loop of ``launch.train.run_arch_smoke`` (``federated_rounds``) at full
    width, then the depth-2 float32 round against the CPU's.  Returns the
    launches of the full-width rounds."""
    import multiprocessing
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import federated_rounds
    from repro_torch.models import transformer

    flash = (flash_attention, flash_attention_bwd)
    # the depth-2 parameters first, so the CPU's round runs meanwhile
    arch2 = zoo_depth2_arch()
    key2 = jr.PRNGKey(1, device=dev)
    p2 = transformer.init_params(arch2.model, key2, dev)
    path = ROOT / "build" / "zoo_depth2_params.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_tree_to(p2, "cpu"), path)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=zoo_round_cpu, args=(
        str(ROOT / "src"), str(path), ZOO_CPU_THREADS, results), daemon=True)
    proc.start()

    try:
        arch = get_arch(ZOO_ARCH)
        cfg = arch.model
        fed_round, opt, spec_shapes = build_train_step(arch, "train_4k")
        K, E, B, S = ZOO_SHAPE
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, init_s = timed_init(torch, transformer, cfg, 0, dev)
        n_params = sum(x.numel() for x in tree_leaves(params))
        rounds = federated_rounds(fed_round, params, opt.init(params),
                                  jr.PRNGKey(0, device=dev),
                                  vocab=cfg.vocab, shape=ZOO_SHAPE,
                                  rounds=ZOO_ROUNDS + 1)
        del params                  # the loop holds them
        L = cfg.n_layers
        want = dict(fed_select=1, fed_select_mask=0, fed_aggregate=1,
                    flash_attention=2 * L * E, flash_attention_bwd=L * E)
        per_round, total = [], dict.fromkeys(want, 0)
        for _ in range(ZOO_ROUNDS):
            (t, sel, m, _), got, wall = counted(torch, lambda: next(rounds),
                                                flash)
            loss, dnorm = float(m.loss), float(m.delta_norm)
            per_round.append(dict(round=t, wall_ms=1e3 * wall, loss=loss,
                                  delta_norm=dnorm,
                                  selected=sel.nonzero().flatten().tolist(),
                                  launches=got))
            total = {n: total[n] + got[n] for n in want}
            if got != want or not all(map(math.isfinite, (loss, dnorm))):
                raise AssertionError(f"zoo_train round {t}: launches {got} "
                                     f"(want {want}), loss {loss}, delta "
                                     f"norm {dnorm}")
        peak = torch.cuda.max_memory_allocated()
        profiled = device_profile(torch, lambda: next(rounds),
                                  kernel_name="flash")[0]
        # bf16: the backward runs D, then the tensor-core dK/dV and dQ
        bwd_names = [n for n in profiled["kernel_names"] if "flash_bwd" in n]
        if not (any("flash_bwd_dkdv_mma" in n for n in bwd_names)
                and any("flash_bwd_dq_mma" in n for n in bwd_names)
                and all("_mma" in n or "flash_bwd_delta" in n
                        for n in bwd_names)):
            raise AssertionError(f"zoo_train: the profiled round's backward "
                                 f"kernels are {bwd_names}, not the "
                                 f"tensor-core route's")
        del rounds
        torch.cuda.empty_cache()
        tokens = K * E * B * S
        pairs = attn_pairs(S, S, True, 0)
        attn_flops = L * K * B * E * cfg.n_heads * cfg.head_dim * pairs \
            * (2 * 4 + 10)          # the forward twice (remat), backward
        flops = 8.0 * n_params * tokens + attn_flops
        steady = sum(r["wall_ms"] for r in per_round[1:]) \
            / (len(per_round) - 1)
        full = dict(arch=ZOO_ARCH, layers=L, dtype=cfg.dtype,
                    n_params=n_params, init_params_s=init_s,
                    spec_batch=[list(x.shape) for x in spec_shapes.values()],
                    cohort_K_E_B_S=list(ZOO_SHAPE), tokens_per_round=tokens,
                    remat=arch.fed.remat, mode=arch.fed.cohort_mode,
                    server_opt=arch.fed.server_opt,
                    launches_per_round=want, rounds=per_round,
                    steady_round_ms=steady, peak_memory_gb=peak / 1e9,
                    flops_per_round=flops,
                    tflops_per_s=flops / steady / 1e9, profiled=profiled)

        # depth 2, float32: the card's round against the CPU's
        fed2, opt2, _ = build_train_step(arch2, "train_4k")
        (_, sel2, m2, st2), got2, _ = counted(torch, lambda: next(
            federated_rounds(fed2, p2, opt2.init(p2), key2, vocab=cfg.vocab,
                             shape=ZOO_DEPTH2_SHAPE, rounds=1)), flash)
        card = dict(mask=sel2.cpu().numpy(), loss=float(m2.loss),
                    delta_norm=float(m2.delta_norm))
        del p2
        cpu = finish_cpu(proc, results, timeout=900)
        if cpu is None:
            raise AssertionError("zoo_train: the CPU's depth-2 round gave "
                                 "no result")
        gaps = delta_leaf_gaps(torch, st2.m, torch.load(str(path) + ".m"))
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join()
        path.unlink(missing_ok=True)
        Path(str(path) + ".m").unlink(missing_ok=True)
    rel = {f: abs(card[f] - cpu[f]) / abs(cpu[f])
           for f in ("loss", "delta_norm")}
    worst = [max(g[i] for g in gaps.values()) for i in (0, 1)]
    want2 = dict(want, flash_attention=4, flash_attention_bwd=2)
    bitwise = card["mask"].tobytes() == cpu["mask"].tobytes()
    if not (bitwise and got2 == want2 and max(rel.values()) <= ZOO_TOL
            and worst[0] <= ZOO_LEAF_NORM_TOL
            and worst[1] <= ZOO_LEAF_MAX_TOL):
        raise AssertionError(
            f"zoo_train depth 2: masks bitwise {bitwise}, launches {got2} "
            f"(want {want2}), relative errors {rel} (limit {ZOO_TOL}), the "
            f"delta's leaves {gaps} (limits {ZOO_LEAF_NORM_TOL} on the "
            f"norm, {ZOO_LEAF_MAX_TOL} of the leaf's largest lane)")
    emit(dict(phase="zoo_train", full_width=full, depth2=dict(
        shape=list(ZOO_DEPTH2_SHAPE), dtype="float32", launches=got2,
        mask_bitwise_vs_cpu=bitwise, card_loss=card["loss"],
        cpu_loss=cpu["loss"], card_delta_norm=card["delta_norm"],
        cpu_delta_norm=cpu["delta_norm"], relative_errors=rel, tol=ZOO_TOL,
        delta_leaf_gaps=gaps, worst_leaf_norm_gap=worst[0],
        worst_leaf_max_gap=worst[1], leaf_norm_tol=ZOO_LEAF_NORM_TOL,
        leaf_max_tol=ZOO_LEAF_MAX_TOL, cpu_wall_s=cpu["wall_s"],
        cpu_threads=ZOO_CPU_THREADS)))
    return total


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
    prof = device_profile(torch,
                          lambda: transformer.prefill(cfg, params, batch),
                          kernel_name="ssd_chunk_kernel")[0]
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
    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    sel_err, mask_err = phase("fed_select", check_fed_select, torch, dev)
    agg_err = phase("fed_aggregate", check_fed_aggregate, torch, dev)
    timing = phase("timing", time_kernels, torch, dev)
    launches, main_run = phase("main_path", main_path, torch, dev)
    grid_launches = phase("scenarios", scenarios, torch, dev)
    task_launches, agg_resnet18 = phase("paper_tasks", paper_tasks, torch,
                                        dev)
    host_launches = phase("host_async", host_async, torch, dev, main_run)
    client_launches = phase("clients", clients, torch, dev, main_run)
    phase("init", check_init, torch, dev)
    attn_err = phase("flash_attention", check_flash_attention, torch, dev)
    t_attn = phase("flash_timing", time_flash_attention, torch, dev)
    bwd_err = phase("flash_backward", check_flash_backward, torch, dev)
    t_bwd = phase("flash_bwd_timing", time_flash_backward, torch, dev)
    flash_launches = phase("serve_path", serve_path, torch, dev,
                           t_attn["ms"])
    flash_launches += phase("dense_path", dense_path, torch, dev)
    zoo = phase("zoo_train", zoo_train, torch, dev)
    flash_launches += zoo["flash_attention"]
    ssd_err = phase("ssd_chunk", check_ssd_chunk, torch, dev)
    t_ssd = phase("ssd_timing", time_ssd, torch, dev)
    ssd_launches = phase("mamba_path", mamba_path, torch, dev, t_ssd["ms"])
    emit(dict(phase="seconds_by_phase", **phase_s))

    src = "src/repro_torch/kernels/csrc/"
    t_sel, t_mask, t_agg = (timing["fed_select_n1048576"],
                            timing["fed_select_mask_n1048576"],
                            timing["fed_aggregate_10x16777216"])
    kernels = [
        dict(name="fed_select", route="cuda", source=src + "fed_select.cu",
             replaces="src/repro/kernels/fed_select.py:168",
             launches=(launches["fed_select"] + grid_launches["fed_select"]
                       + task_launches["fed_select"]
                       + host_launches["fed_select"]
                       + client_launches["fed_select"] + zoo["fed_select"]),
             max_abs_err=sel_err,
             shape=[1 << 20], **{k: t_sel[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="fed_select_mask", route="cuda",
             source=src + "fed_select.cu",
             replaces="src/repro/kernels/fed_select.py:152",
             launches=(launches["fed_select_mask"]
                       + grid_launches["fed_select_mask"]
                       + host_launches["fed_select_mask"]
                       + client_launches["fed_select_mask"]),
             max_abs_err=mask_err,
             shape=[1 << 20], **{k: t_mask[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="fed_aggregate", route="cuda",
             source=src + "fed_aggregate.cu",
             replaces="src/repro/kernels/fed_aggregate.py:75",
             launches=(launches["fed_aggregate"]
                       + grid_launches["fed_aggregate"]
                       + task_launches["fed_aggregate"]
                       + host_launches["fed_aggregate"]
                       + client_launches["fed_aggregate"]
                       + zoo["fed_aggregate"]),
             max_abs_err=agg_err,
             shape=[10, 1 << 24], **{k: t_agg[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             at_resnet18={k: agg_resnet18[k] for k in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "max_abs_err")}),
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:77",
             launches=flash_launches, max_abs_err=attn_err,
             routes={"bfloat16": "tensor cores (mma.sync m16n8k16, P split "
                                 "into bf16 hi + lo); ms",
                     "float32": "CUDA cores; f32_ms"},
             shape=list(LLAMA_ATTN), **{k: t_attn[k] for k in (
                 "ms", "f32_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")},
             at_gemma={k: t_attn["at_gemma"][k] for k in (
                 "shape", "ms", "f32_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
        dict(name="flash_attention_bwd", route="cuda",
             source=src + "flash_attention_bwd.cu",
             replaces="src/repro/models/layers.py:157",
             replaces_note="no Pallas backward exists: JAX trains by "
                           "jax.grad of the plain sdpa",
             launches=zoo["flash_attention_bwd"], max_abs_err=bwd_err,
             routes={"bfloat16": "tensor cores (mma.sync m16n8k16, P and "
                                 "dS split into bf16 hi + lo, two "
                                 "deterministic passes: dK/dV, then dQ); "
                                 "ms",
                     "float32": "CUDA cores; f32_ms"},
             shape=list(LLAMA_TRAIN_ATTN), **{k: t_bwd[k] for k in (
                 "ms", "f32_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")},
             at=[{k: r[k] for k in (
                 "shape", "ms", "f32_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")} for r in t_bwd["at"]]),
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
