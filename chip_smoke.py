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
                 fedavg and fedadam at GRID_ROUNDS (30), every other
                 scenario under f3ast and uniform, fedavg_weighted and
                 fixed_f3ast (with an r_target) on homedevices and dropout
                 at SHORT_ROUNDS (20); each cell held to the port's CPU run
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
                 (homedevices), under f3ast and fedadam, 4 rounds each on
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
                 final r_k and parameters; under poc, 75 rounds
                 (fed_select_mask twice a round), the fresh losses within
                 1e-5 relative and the masks bitwise in every round whose
                 cut margin clears the card-vs-CPU loss gap (the rounds
                 compared and any round under its margin reported; one
                 pass of fresh losses timed); on dropout, 30 rounds,
                 bitwise the card's device run too; the buffered server
                 on straggler, device and host executors, 75 rounds,
                 masks, every async_history field and r_k bitwise the CPU
                 and each other; the Shakespeare (820,522) and CIFAR
                 (310,116) task cells on the host loop and Shakespeare on
                 the buffered server with deadline latencies, 4 rounds
                 each (losses at the paper_tasks tolerances);
                 ``run_cells_vmapped`` over seeds 0-3 with caps 3, 5, 10,
                 10, 30 rounds, bitwise the CPU and each cell's single run
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
                 bitwise main_path's device run, and the same for the
                 specs of model_axis' other (2, 2) cells; one line a cell;
5e. ``model_axis`` the (clients, model) mesh: ``RunSpec(mesh_shape=(2,
                 2))`` and ``(1, 4)`` over 4 gloo ranks on the one card
                 (one spawn), each rank's parameters and server-optimizer
                 state its blocks over the model axis: the main path at
                 (2, 2) (300 rounds), scarce under f3ast at (1, 4) and
                 under fedadam at both (GRID_ROUNDS), Shakespeare under
                 fedadam at (2, 2) (PAPER_TASK_ROUNDS), each through
                 ``run_spec`` inside the group (the (1, 4) f3ast cell on
                 axes named ``data`` and ``tp``); masks, K_t,
                 |avail| and r_k bitwise the card's device run of the
                 same spec (main_path's, scenarios', paper_tasks'), losses
                 within LOSS_TOL, the final parameters bitwise the
                 clients phase's (2,) run of the same spec (at (2, 2)) or
                 the device run (at (1, 4)), ``fed_select_mask`` and
                 ``fed_aggregate`` once a round on each rank; one line a
                 cell with its steady ms a round beside the reference's;
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
                 in both dtypes, and the moe archs' prefill layer (1, 8192,
                 48, 8, 128) in bf16 with mixtral's window of 4096 and
                 with grok's soft-cap of 30, and whisper-small's layers in
                 both dtypes: the encoder (1, 1500, 12, 12, 64) non-causal
                 (a ragged edge), the decoder's self-attention (1, 8192,
                 12, 12, 64) causal and its cross-attention, 8,192 and 448
                 queries over 1,500 frames, non-causal; and a rank's heads
                 under a model split (MESH_ATTN), causal in both dtypes:
                 mesh_serve's (1, 2048, 16, 4, 64), llama's (1, 8192, 16,
                 4, 64) and (1, 8192, 8, 2, 64) at m = 2 and 4, qwen3-14b's
                 (1, 8192, 20, 4, 128) and (1, 8192, 10, 2, 128), and
                 gemma-7b's (1, 8192, 4, 4, 256) at m = 4; it reports each
                 reference's RMS;
8. ``flash_timing`` median CUDA-event times of the kernel (its bf16 route,
                 on the tensor cores, and its float32 route, on the CUDA
                 cores), its plain version and
                 ``scaled_dot_product_attention`` at llama's and gemma's
                 prefill shapes (causal), and ``torch.compile`` of
                 ``flex_attention`` (its output held to the kernel's) at
                 mixtral's (a causal block mask with the window of 4096;
                 SDPA with the window as a boolean mask, on the first
                 backend that takes it, named, beside it), grok's (a
                 tanh soft-cap score_mod of 30) and recurrentgemma's
                 (1, 8192, 10, 1, 256) with its window of 2048 (the same
                 two), SDPA (GQA through ``enable_gqa``) at
                 llava's (1, 8192, 56, 8, 128), causal, and SDPA with
                 ``is_causal=False`` at whisper's encoder and
                 cross-attention layers,
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
                 8, 128) and gemma-7b (1, 4096, 16, 16, 256), causal, and
                 whisper-small's at train_4k (the encoder (1, 1500, 12,
                 12, 64) non-causal, the decoder's self-attention at 4,096
                 causal, its cross-attention, 4,096 queries over 1,500
                 frames, non-causal), in
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
9. ``serve_path`` drives llama3.2-1b at full width (the weights
                 ``launch.serve`` draws, ``serve_params``, timed on the
                 card, and kept for 9a): (a) one ``prefill``
                 of B = 1, S = 8192 (16 layers, bf16) with the launch count
                 set to 0 just before, which must launch the kernel exactly
                 16 times and give finite logits, then its wall time
                 (median of 3 after that warm-up) and a profiled run for the
                 kernel's share; (b) ``serve(..., smoke=False)`` at its
                 defaults (batch 4, prompt 16, 32 steps) on those weights,
                 which must launch no flash kernel; (c) at depth 2 in
                 float32, B = 1,
                 S = 512, the card's prefill (kernel) within 1e-4 of the
                 CPU's (plain) on the same weights; (d) at depth 2 in
                 float32, S = 128, the card's prefill within 2e-3 of
                 stepping the same prompt through ``decode_step`` (the
                 limit of ``tests/test_models_consistency.py``);
9a. ``decode_shapes`` steps llama3.2-1b at full width, on serve_path's
                 weights, through ``launch.steps.build_decode_step`` at
                 ``decode_32k`` (its batch cut from 128 to 32: a 34.4 GB
                 KV cache) and ``long_500k`` (batch 1, the swa_variant's
                 ring of 8,192 slots a layer): the state allocated as
                 the step's shapes say (the batch cut), filled at random,
                 and 8 steps from index 32,760, and 16 from 524,280 (the
                 ring wraps), with the flash count at 0: no launch,
                 finite logits, ms a step and tokens/s; then the first 2
                 layers in float32 on one cache (2 rows of decode_32k's,
                 long_500k's whole), the same steps on the card and the
                 CPU: logits and caches within 1e-4;
9c. ``mesh_serve`` the serving programs over a (data, model) mesh: 4 gloo
                 ranks share the card at (2, 2), each building
                 ``build_prefill_step(arch, "prefill_32k", mesh)`` and
                 ``build_decode_step(arch, "decode_32k", mesh)`` for
                 llama3.2-1b at full width and 2 layers, cut to B = 2,
                 S = 2,048, and running on its blocks (carved from the
                 full weights drawn from the seed): a prefill in bfloat16
                 and one in float32, each with the flash count at 0 just
                 before (one launch a layer on every rank, at H/m = 16
                 query and 4 kv heads), then 8 greedy decode steps (the
                 distributed argmax, no flash launch) from a cache filled
                 at random by blocks; held to one process on the card on
                 the same weights and tokens: float32 logits within 1e-5
                 and bfloat16 within 2e-2 of their largest magnitude, the
                 greedy tokens equal (near-ties counted); each rank's
                 parameter bytes and the bytes all-reduced a layer;
9b. ``dense_path`` drives qwen3-8b, qwen3-14b and gemma-7b at full width
                 and about an eighth of their depth (DENSE_DEPTH: 5, 5 and
                 4 layers),
                 one after another, each freed before the next: (a) the
                 weights ``launch.serve`` draws (``serve_params``, timed on
                 the card), one ``prefill`` of B = 1, S = 8192 with the
                 launch count set to 0 just before, which must launch the
                 kernel once a layer and give finite logits,
                 the median of 3 and a profiled run whose flash kernels
                 must all be the tensor-core route's; (b) 8 decode steps
                 through ``serve`` on those weights (batch 4), with no
                 flash launch; (c) the draw against the CPU's (the CPU
                 walks the same key tree and re-draws windows of every
                 drawn row, the norms whole: ``init_windows_check``), then
                 the first 2 layers cast to float32, the card's prefill
                 (S = 512, 2 launches) within 1e-4 of the CPU's on the
                 same weights;
9c. ``moe_path`` drives mixtral-8x22b (1 of its 56 layers) and
                 grok-1-314b (1 of 64) at full width, one after the other:
                 (a) ``serve_params`` at the cut depth (timed), one
                 ``prefill`` of B = 1, S = 8192 (two routing groups of
                 4096, capacity 1,280) with the launch count set to 0 just
                 before, which must launch the kernel once a layer and give
                 finite (1, 1, V) logits, the median of 3, the peak memory,
                 a profiled run whose flash kernels must all be
                 ``flash_kernel_mma``, the share of (token, choice) pairs
                 capacity dropped in each layer and what the router's
                 input shares across positions (its rows' mean cosine);
                 (b) 8 decode steps through ``serve`` on those weights
                 (batch 4), with no flash launch; (c) on the same drawn
                 weights: the draw by ``init_windows_check``'s windows of
                 every row; the first MOE_F32_LAYERS (1 each) layers cast
                 to float32 on the card and, in a spawned CPU worker
                 (from their bf16 copy saved under ``build/``; ATen's
                 and MKL's ISA pinned by MOE_CPU_ENV, its ISA, threads
                 and CPU model printed),
                 prefill at S = 512 within 1e-4 with
                 every layer's chosen experts equal (the smallest gap
                 between the 2nd and 3rd probability reported),
                 ``moe_block`` alone on layer 0 at S = 300 in groups of
                 256 (a padded group) with y within 1e-4 of its largest
                 lane, lb_loss within 1e-6 relative, the experts and slots
                 equal, and ``top_k`` of tied rows bitwise;
9d. ``hybrid_path`` drives recurrentgemma-2b at full width and depth (8
                 groups of (rec, rec, attn) and 2 tail rec blocks, bf16):
                 (a) ``serve_params`` (timed), one ``prefill`` of B = 1,
                 S = 8192 with the launch count set to 0 just before,
                 which must launch the kernel once a group (8) and give
                 finite (1, 1, V) logits, the median of 3, the peak
                 memory, a profiled run whose flash kernels must all be
                 ``flash_kernel_mma``, and the first rec layer's float32
                 gate GEMMs, gates, scan and RG-LRU block (ms and
                 launches each) with the gates' and scan's share of the
                 prefill; (b) 8 decode steps through ``serve`` (batch 4),
                 and again at max_len 2,304, where the attention caches
                 are rings of the window's 2,048 slots, with no flash
                 launch; (c) the draw by ``init_windows_check`` (lam
                 within an ulp), the first group in float32 at S = 3072
                 (the window hides 1,024 keys from the last rows) within
                 1e-4 of the CPU's prefill, and ``rglru_block`` alone on
                 its first layer at S = 8192 within 1e-5 relative;
9e. ``vlm_path`` drives llava-next-34b at full width and 4 of its 60
                 layers (bf16): (a) as 9d's, at 1,024 patch embeddings
                 (drawn from a seed) before 7,168 tokens, one launch a
                 layer; (b) 8 text-only decode steps through ``serve``;
                 (c) the draw by windows, and the first 2 layers and the
                 projector in float32 at 1,024 patches + 512 tokens within
                 1e-4 of the CPU's prefill;
9f. ``audio_path`` drives whisper-small at full width and depth (12
                 encoder and 12 decoder layers, bf16, 0.24 B parameters):
                 (a) ``serve_params`` (timed), one ``prefill`` of B = 1,
                 1,500 stub frames and S = 8192 tokens (past the 4,096
                 decoder positions, which it leaves out) with the launch
                 count set to 0 just before, which must launch the kernel
                 36 times (12 encoder, 12 self, 12 cross) and give finite
                 (1, 1, V) logits, the median of 3, the peak memory and a
                 profiled run whose flash kernels must all be
                 ``flash_kernel_mma``; a second prefill at whisper's target
                 length of 448 (with positions), 36 launches; (b) 8 decode
                 steps through ``serve`` (batch 4), whose frames are
                 encoded once (12 launches, ``encdec.prefill`` of the
                 cross K/V) and whose steps launch none; (c) the draw by
                 windows, and the first 2 encoder and 2 decoder layers in
                 float32 at 1,500 frames + 448 tokens (6 launches) within
                 1e-4 of the CPU's prefill;
9g. ``zoo_train`` trains llama3.2-1b at full width (16 layers, d 2048,
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
                 no single PyTorch call computes it; ``ms`` is one call
                 at a time through the wrapper, whose autograd Function's
                 host work the card waits on at this size, ``queued_ms``
                 ten calls queued back to back (the card's time);
11a. ``ssd_backward`` holds the backward kernel (``ssd_chunk_bwd``: dx, ddt,
                 dA, dBm, dCm from the gradients of y, the states and the
                 decays) against its plain version, the hand-derived
                 ``ref.ssd_chunk_bwd``, in float32 and bf16 at the forward
                 phase's shapes, a ragged one with no states or decays
                 gradient, the strided x of the model, and the training
                 layer as the cohort folds it (2, 32 chunks, 128, 80, 64),
                 N = 128, with one A a row: float32 gradients within 1e-4
                 of the lane plus 1e-4 of the largest magnitude, bf16 ones
                 within one bf16 step plus the same (SSD_BWD_TOL), each
                 case's worst lane reported as a share of its limit; each
                 case run twice, bitwise; at the training layer
                 ``vmap(grad)`` through ``ssd_chunk`` must equal the
                 kernel's gradient bit for bit in one backward launch;
11b. ``ssd_bwd_timing`` median CUDA-event times of the backward at the
                 training layer (bf16 inputs on the tensor cores, float32
                 on the CUDA cores) and of its plain version, beside the
                 bound (its products over the bf16 tensor cores' 989
                 TFLOP/s, or its bytes; the products over the float32 CUDA
                 cores' 67, where the float32 route runs them, beside) and
                 each of the bf16 route's three launches' device ms; no
                 PyTorch call computes it;
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
                 stepping the prompt through ``decode_step``;
12a. ``zoo_train`` again, for mamba2-2.7b: its first ZOO_DEPTH layers of
                 mamba_path's weights at full width (d_model 2,560, 80
                 heads, N = 128, the 50,280-token vocabulary, bf16), K =
                 2, E = 2, B = 1, S = 4096: one warm-up round and 2
                 timed, each launching fed_select and fed_aggregate once,
                 ssd_chunk 2 x depth x E times and ssd_chunk_bwd depth x
                 E times, with finite losses; the peak memory and a
                 profiled round whose ssd kernels must be the forward's
                 and the backward's tensor-core routes (SSD_BWD_PARTS);
                 then the depth-2 float32 round (K = 2, E = 1, S =
                 512) against a spawned CPU worker: masks bitwise, loss
                 and delta norm within ZOO_MAMBA_TOL, the delta's leaves
                 within ZOO_MAMBA_LEAF_NORM_TOL and ZOO_MAMBA_LEAF_MAX_TOL.

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
import os
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
F32_LOGIT_TOL = 1e-4                # float32 prefill logits, card vs CPU


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


def cuda_ms(fn, *, warmup: int = 5, runs: int = 25, calls: int = 1) -> float:
    """Median over ``runs`` of CUDA-event time of one call, after warm-up.
    With ``calls`` > 1, of that many calls queued back to back, over their
    count: the host's work for a call then overlaps the card's for the one
    before, so the time is the card's alone where the kernel outlasts it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
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
# The paper grid's rounds: RunSpec()'s 300 cut to 30 (and the other cells'
# to 20), so that the script, with the zoo's archs and training round,
# stays inside its 1,200 s limit (60 and 30 until the hybrid and vlm
# archs joined it).
GRID_ROUNDS = 30
SHORT_ROUNDS = 20
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
        kept = {}
        try:
            for cell, fut in zip(cells, cpu):
                card = card_cell(torch, dev, cell, totals, by_mode)
                check_cell(torch, cell, card, fut.result(), "scenarios",
                           LOSS_TOL, LOSS_TOL)
                if cell[:2] in MODEL_AXIS_REFS:
                    kept[cell[:2]] = run_fields(card[0])
        finally:
            for fut in cpu:            # a failed cell fails the phase now
                fut.cancel()
    emit(dict(phase="scenarios_summary", cells=len(cells),
              wall_s=time.perf_counter() - t_phase, cpu_workers=CPU_WORKERS,
              launches=totals, fed_select_launches_by_mode=by_mode))
    return totals, kept


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
# cut from 20 when the dense archs joined the script, to 6 when the moe
# archs did and to 4 when the hybrid and vlm archs did: the phase waits
# for the CPU's Shakespeare runs (~10 s a round beside the other workers);
# evaluated every PAPER_TASK_EVAL rounds, so the runs after the first
# chunk give the steady round
PAPER_TASK_ROUNDS = 4
PAPER_TASK_EVAL = 2
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


def device_profile(torch, fn, steps: int = 1, kernel_name=None,
                   cpu: bool = True):
    """``fn()`` under torch.profiler, the script's one reading of a trace:
    wall ms, device launches, kernel ms (summed), busy ms (the union of
    the kernels' intervals: cuDNN runs some kernels side by side), idle
    share (1 - busy / wall) and the top kernels, each a step (``fn`` runs
    ``steps`` steps); with ``kernel_name``, the device ms and names of the
    kernels whose name holds it; the seconds the trace took to read.  The
    profiler mirrors ``record_function`` spans onto the GPU timeline;
    those (``round/*``) are not kernels.  ``cpu=False`` traces the device
    alone: a round of tens of thousands of launches with its host ops
    takes over a minute to read back (mamba2's 44-layer round on an H100
    80GB HBM3's host; Shakespeare's round 31 s), so every profile but the
    main path's (which reads its host spans) traces the device alone.
    Returns (stats, the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]
                 + ([ProfilerActivity.CPU] if cpu else [])) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
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
                              for k, (n, us) in top],
                 trace_read_s=time.perf_counter() - t0)
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
    return device_profile(torch, step, cpu=False)[0]


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
                                         batches[0], weights, lr),
                cpu=False)[0]
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
            kept = {cell[:2]: run_fields(run[0])
                    for cell, run in zip(cells, card)
                    if cell[:2] in MODEL_AXIS_REFS}
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
    return totals, agg, kept


# ---------------------------------------------------------------------------
# host_async: the host loop, Power-of-Choice, checkpoints, the buffered
# server and the batched cells
# ---------------------------------------------------------------------------

HOST_ROUNDS = 300
# 150, 60 and 6 until the hybrid and vlm archs joined the script
HOST_POC_BUFFERED_ROUNDS = 75
HOST_SHORT_ROUNDS = 30
HOST_TASK_ROUNDS = 4         # with PAPER_TASK_EVAL: two chunks
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
                                     rounds=HOST_TASK_ROUNDS,
                                     eval_every=PAPER_TASK_EVAL), 2, sync),
        ("buffered/shakespeare", RunSpec(
            scenario=shakespeare, aggregation="buffered",
            completion="deadline", rounds=HOST_TASK_ROUNDS,
            eval_every=PAPER_TASK_EVAL), 2, sync),
        ("host/cifar", RunSpec(scenario=cifar, engine="host",
                               rounds=HOST_TASK_ROUNDS,
                               eval_every=PAPER_TASK_EVAL), 2, sync),
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
                async_history=res.async_history, final=res.final_metrics,
                params=res.final_params)


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
# a rank's heads over a model axis of m (H/m query, KV/m kv heads), one
# sequence of the batch: mesh_serve's llama at m = 2 and S = 2,048; the
# NCCL cells' llama at m = 2 and 4, qwen3-14b at m = 2 and 4; gemma-7b
# at m = 4
MESH_ATTN = {"mesh_serve_llama_m2": (1, 2048, 16, 4, 64),
             "llama_m2": (1, 8192, 16, 4, 64),
             "llama_m4": (1, 8192, 8, 2, 64),
             "qwen3_14b_m2": (1, 8192, 20, 4, 128),
             "qwen3_14b_m4": (1, 8192, 10, 2, 128),
             "gemma_7b_m4": (1, 8192, 4, 4, 256)}
# mixtral-8x22b's and grok-1-314b's prefill layer, B = 1: mixtral's with
# its sliding window of 4096, grok's with its logit soft-cap of 30
MOE_ATTN = (1, 8192, 48, 8, 128)
# a window smaller than the kernel's 64-key tile: every visited tile is an
# edge tile, and a row's first visited tile can hide all its keys
WINDOW32 = dict(causal=True, window=32, softcap=0.0)
SWA4096 = dict(causal=True, window=4096, softcap=0.0)    # mixtral's
MOE_MODES = {"mixtral-8x22b": "window4096", "grok-1-314b": "softcap30"}
# recurrentgemma-2b's local attention layer, B = 1: one KV head (MQA), a
# query group of 10, head dim 256, its window of 2048; and llava-next-34b's
# layer: a query group of 7
RG_ATTN = (1, 8192, 10, 1, 256)
SWA2048 = dict(causal=True, window=2048, softcap=0.0)    # recurrentgemma's
LLAVA_ATTN = (1, 8192, 56, 8, 128)
FLASH_MODES = dict(ATTN_MODES, window32=WINDOW32, window2048=SWA2048,
                   window4096=SWA4096)
# whisper-small's attention layers at B = 1, (B, Sq, H, KV, hd[, Skv]):
# the encoder over its 1,500 frames (non-causal; a ragged edge for 64-row
# tiles), the decoder's self-attention over audio_path's 8,192 tokens
# (causal) and its cross-attention, the 8,192 queries (and whisper's
# target length of 448) over the 1,500 frames (non-causal, Sq != Skv)
WHISPER_ENC_ATTN = (1, 1500, 12, 12, 64)
WHISPER_SELF_ATTN = (1, 8192, 12, 12, 64)
WHISPER_CROSS_ATTN = (1, 8192, 12, 12, 64, 1500)
WHISPER_CROSS448_ATTN = (1, 448, 12, 12, 64, 1500)
WHISPER_ATTN = {"encoder": (WHISPER_ENC_ATTN, "full"),
                "self": (WHISPER_SELF_ATTN, "causal"),
                "cross": (WHISPER_CROSS_ATTN, "full"),
                "cross448": (WHISPER_CROSS448_ATTN, "full")}


def attn_inputs(torch, dev, shape, dtype, seed):
    """q (B, Sq, H, hd) and k, v (B, Skv, KV, hd) of ``shape`` (B, Sq, H,
    KV, hd[, Skv]); Skv = Sq where it is not given."""
    B, S, H, KV, hd = shape[:5]
    skv = shape[5] if len(shape) > 5 else S
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, n_s, n, hd, generator=gen, device=dev).to(dtype)
            for n_s, n in ((S, H), (skv, KV), (skv, KV))]


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
    cases += [(MOE_ATTN, torch.bfloat16, mode) for mode in MOE_MODES.values()]
    cases += [(shape, dtype, "causal") for shape in MESH_ATTN.values()
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [(shape, dtype, mode)
              for shape, mode in ((RG_ATTN, "window2048"),
                                  (LLAVA_ATTN, "causal"),
                                  *WHISPER_ATTN.values())
              for dtype in (torch.bfloat16, torch.float32)]
    modes = FLASH_MODES
    rows, max_err, llama, gemma, moe = [], {}, {}, {}, {}
    hybrid_vlm, whisper, mesh_heads = {}, {}, {}
    whisper_layer = {shape: layer for layer, (shape, _)
                     in WHISPER_ATTN.items()}
    mesh_layer = {shape: name for name, shape in MESH_ATTN.items()}
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
        if shape == MOE_ATTN:
            moe[mode] = dict(max_abs_err=err, ref_rms=rms,
                             err_over_rms=err / rms)
        if shape in (RG_ATTN, LLAVA_ATTN):
            hybrid_vlm[f"{'recurrentgemma' if shape == RG_ATTN else 'llava'}"
                       f"_{dname}"] = dict(max_abs_err=err, ref_rms=rms,
                                           err_over_rms=err / rms)
        if shape in mesh_layer and mode == "causal":
            mesh_heads[f"{mesh_layer[shape]}_{dname}"] = dict(
                shape=list(shape), max_abs_err=err, ref_rms=rms,
                err_over_rms=err / rms)
        if shape in whisper_layer:
            whisper[f"{whisper_layer[shape]}_{dname}"] = dict(
                shape=list(shape), mode=mode, max_abs_err=err, ref_rms=rms,
                err_over_rms=err / rms)
        if not ok:
            raise AssertionError(
                f"flash_attention {shape} {dtype} {mode}: max |err| {err} "
                f"(reference rms {rms}) over {tol}, or a bf16 lane more "
                f"than one step ({BF16_STEP} relative + {BF16_STEP_ATOL}) "
                f"from the plain output")
        del q, k, v, got, want, diff
    emit(dict(phase="flash_attention", checks=rows,
              max_abs_err_by_dtype=max_err, llama_shape=llama,
              gemma_shape=gemma, moe_shape=moe,
              hybrid_vlm_shapes=hybrid_vlm, whisper_shapes=whisper,
              mesh_rank_shapes=mesh_heads))
    return llama["bfloat16"]["max_abs_err"]


def time_flash_attention(torch, dev):
    """The llama, gemma, mixtral, grok, recurrentgemma, llava and whisper
    (encoder and cross-attention) prefill layers' rows; returns llama's
    with the others' under ``at_gemma``, ``at_mixtral``, ``at_grok``,
    ``at_recurrentgemma``, ``at_llava``, ``at_whisper_encoder`` and
    ``at_whisper_cross``."""
    llama = time_flash_shape(torch, dev, LLAMA_ATTN)
    llama["at_gemma"] = time_flash_shape(torch, dev, GEMMA_ATTN)
    llama["at_mixtral"] = time_flash_shape(torch, dev, MOE_ATTN,
                                           "window4096")
    llama["at_grok"] = time_flash_shape(torch, dev, MOE_ATTN, "softcap30")
    llama["at_recurrentgemma"] = time_flash_shape(torch, dev, RG_ATTN,
                                                  "window2048")
    llama["at_llava"] = time_flash_shape(torch, dev, LLAVA_ATTN)
    for layer in ("encoder", "cross"):
        llama[f"at_whisper_{layer}"] = time_flash_shape(
            torch, dev, *WHISPER_ATTN[layer])
    return llama


def sdpa_library_call(torch, qt, kt, vt, **kw):
    """The first SDPA backend (flash, memory-efficient, cuDNN, math) that
    takes these (B, heads, S, hd) inputs: (its name, the call)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      enable_gqa=True, **kw)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return backend.name, call
    raise AssertionError(f"no SDPA backend takes {kw}")


def flex_library_call(torch, qt, kt, vt, *, causal, window, softcap):
    """``torch.compile(flex_attention)`` of these (B, heads, S, hd)
    inputs: a block mask for causal and the window (its fully masked
    tiles skipped) and a score_mod for the soft-cap, on the scaled score
    as the kernel applies it."""
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    assert causal
    # compile in this process: no pool of workers left behind
    inductor_config.compile_threads = 1
    S = qt.shape[2]

    def mask_mod(b, h, q_idx, kv_idx):
        keep = kv_idx <= q_idx
        return keep & (q_idx - kv_idx < window) if window > 0 else keep

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)
    block_mask = create_block_mask(mask_mod, None, None, S, S,
                                   device=qt.device)
    flex = torch.compile(flex_attention)
    mod = score_mod if softcap > 0 else None
    return lambda: flex(qt, kt, vt, score_mod=mod, block_mask=block_mask,
                        enable_gqa=True)


def time_flash_shape(torch, dev, shape, mode="causal"):
    """bf16 (the tensor cores) and float32 (the CUDA cores) through the
    kernel, the plain version and the library beside the bound.  The
    library: SDPA, causal or not (its default backend); a window or a
    soft-cap,
    which no SDPA call skips tiles for or has, takes the compiled
    ``flex_attention`` (held to the kernel's output), and a window is
    also timed as SDPA with a boolean mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    kw = FLASH_MODES[mode]
    B, S, H, KV, hd = shape[:5]
    skv = shape[5] if len(shape) > 5 else S
    q, k, v = attn_inputs(torch, dev, shape, torch.bfloat16, 100)
    # the library yardstick takes (B, heads, S, hd); its copies are made
    # here, outside the timed calls
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = attn_pairs(S, skv, kw["causal"], kw["window"])
    flops = 4.0 * B * H * hd * pairs          # QK^T and PV, 2 flops a MAC
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * skv * KV * hd)  # q, o, k, v
    b, by = bound_ms(nbytes, flops, peak=BF16_FLOPS)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    extra = {}
    if kw["window"] > 0 or kw["softcap"] > 0:
        call = flex_library_call(torch, qt, kt, vt, **kw)
        library = ("torch.compile(flex_attention), causal block mask"
                   + (f" with the window of {kw['window']}" if kw["window"]
                      else f", tanh soft-cap {kw['softcap']:g} score_mod"))
        want = flash_attention(q, k, v, **kw).transpose(1, 2)
        extra["library_vs_kernel_max_abs"] = float(
            (call().float() - want.float()).abs().max())
        del want
        if kw["window"] > 0:
            # SDPA with the window as a dense boolean mask: it visits every
            # tile, a weaker yardstick kept beside the compiled one
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) \
                & (i[None, :] > i[:, None] - kw["window"])
            name, sdpa = sdpa_library_call(torch, qt, kt, vt, attn_mask=mask)
            extra.update(sdpa_mask_backend=name,
                         sdpa_mask_ms=cuda_ms(sdpa, warmup=3, runs=15))
            del mask, sdpa
    else:
        def call():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw["causal"], enable_gqa=True)
        library = f"SDPA, is_causal={kw['causal']}"
    lib_ms = cuda_ms(call, warmup=3, runs=15)
    row = dict(shape=list(shape), dtype="bfloat16", mode=mode,
               ms=cuda_ms(lambda: flash_attention(q, k, v, **kw),
                          warmup=2, runs=15),
               f32_ms=cuda_ms(lambda: flash_attention(q32, k32, v32, **kw),
                              warmup=1, runs=9),
               plain_ms=cuda_ms(lambda: ref.sdpa(q, k, v, **kw),
                                warmup=2, runs=9),
               library_ms=lib_ms, library=library, **extra,
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
# whisper-small's at train_4k, B = 1: the encoder (non-causal, ragged),
# the decoder's self-attention (causal) and its cross-attention, 4,096
# queries over 1,500 frames (non-causal, Sq != Skv)
WHISPER_TRAIN_ATTN = (((1, 1500, 12, 12, 64), "full"),
                      ((1, 4096, 12, 12, 64), "causal"),
                      ((1, 4096, 12, 12, 64, 1500), "full"))
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
    """q, k, v and do of ``shape`` (B, Sq, H, KV, hd[, Skv]), and the plain
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
    cases += [(shape, dtype, mode) for shape, mode in WHISPER_TRAIN_ATTN
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
        t0 = time.perf_counter()
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
                         ok=ok, wall_s=time.perf_counter() - t0, **fwd))
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
    """The worker's result, or None after ``timeout`` s or as soon as the
    worker has exited without one."""
    import queue
    deadline, out = time.perf_counter() + timeout, None
    while out is None and time.perf_counter() < deadline:
        alive = proc.is_alive()
        try:
            out = results.get(timeout=5)
        except queue.Empty:
            if not alive:
                break
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
                      with_run_spec: bool, more=()):
    """One rank of cells 4 and 5 of :func:`clients`, in one spawn: the
    sharded engine driven ``rounds`` rounds under each ``topk_impl``,
    then (``with_run_spec``) ``run_spec(RunSpec(mesh_shape=(2,)))``
    inside this initialized group, as under torchrun, and the same for
    each (name, spec JSON) of ``more`` (cell ``"more:" + name``).  Each
    cell's launches on this rank, and from rank 0 its streams, r_k,
    steady ms and comm bytes (the run_spec cells: their results)."""
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
        out["run_spec"] = dict(launches=launches, wall_s=wall,
                               res=run_fields(res) if lead else None)
    for name, spec_json in more:
        spec = RunSpec.from_json(spec_json).replace(mesh_shape=(mesh.size,))
        res, launches, wall = counted(torch, lambda: run_spec(
            spec, device=dev, log_fn=lambda *a: None))
        out["more:" + name] = dict(launches=launches, wall_s=wall,
                                   res=run_fields(res) if lead else None)
    return out


def add_launches(totals, launches):
    for k, v in launches.items():
        totals[k] += v


def clients(torch, dev, main_run, more=()):
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
       run, losses and delta norms within LOSS_TOL; then each (name, spec
       JSON) of ``more`` the same way (the (2,) runs that ``model_axis``
       holds its (2, 2) cells' parameters to; ``fed_select_mask`` and
       ``fed_aggregate`` once a round a rank), returned by name.
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
            torch, window, steps=3, kernel_name="fed_select", cpu=False))
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
                            CLIENTS_SHARDED_ROUNDS, True, list(more),
                            backend="gloo", threads=2)
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
    more_res = {}
    for name, _ in more:
        cells = [r["more:" + name] for r in ranks]
        res = more_res[name] = cells[0]["res"]
        launches = {k: sum(c["launches"][k] for c in cells) for k in totals}
        rounds = int(res["sel"].shape[0])
        rows.append(dict(
            phase="clients", cell="run_spec_mesh", run=name, mesh_shape=[2],
            backend="gloo", rounds=rounds, engine=res["final"]["engine"],
            steady_round_ms=steady_ms(res["final"]), launches=launches,
            wall_s=cells[0]["wall_s"]))
        ok &= (res["final"]["engine"] == "sharded"
               and launches["fed_select_mask"] == 2 * rounds
               and launches["fed_aggregate"] == 2 * rounds
               and bool(np.isfinite(res["train_loss"]).all()))
    for row in rows:
        emit(row)
    emit(dict(phase="clients_summary", cells=len(rows), launches=totals,
              wall_s=time.perf_counter() - t_phase))
    if not ok:
        raise AssertionError("clients: a cell departs from its reference")
    return totals, res5, more_res


# ---------------------------------------------------------------------------
# model_axis: the (clients, model) mesh on 4 gloo ranks sharing the card
# ---------------------------------------------------------------------------

# (scenario, strategy) of the earlier phases' card runs the model_axis
# cells are held to: scenarios' scarce cells (GRID_ROUNDS) and
# paper_tasks' Shakespeare fedadam cell (PAPER_TASK_ROUNDS)
MODEL_AXIS_REFS = (("scarce", "f3ast"), ("scarce", "fedadam"),
                   ("shakespeare", "fedadam"))
MODEL_AXIS_RANKS = 4
MODEL_AXIS_THREADS = 2


def model_axis_cells():
    """(cell, mesh shape, spec JSON, reference, parameters' reference) of
    the phase; every cell's final parameters are bitwise their reference.
    A (2, 2) cell's parameters are held to the same spec's (2,) run of the
    ``clients`` phase (``clients_2`` for the main path, ``cell@2`` for the
    others): the all-gather is exact and slicing commutes with a 2-term
    sum.  A (1, 4) cell's are the device run's (one client shard sums
    nothing).  The (1, 4) f3ast cell names its axes ``data`` and ``tp``."""
    from repro_torch.sim import RunSpec
    grid = {(sc, algo): js for sc, algo, _, js in scenario_cells()}
    tasks = {(t, algo): js for t, algo, _, js in paper_task_cells()}
    main = RunSpec().to_json()
    renamed = RunSpec.from_json(grid["scarce", "f3ast"]).replace(
        clients_axis="data", model_axis="tp").to_json()
    return [
        ("main_path", (2, 2), main, "main_path", "clients_2"),
        ("scarce/f3ast", (1, 4), renamed, "scarce/f3ast", "scarce/f3ast"),
        ("scarce/fedadam", (2, 2), grid["scarce", "fedadam"],
         "scarce/fedadam", "scarce/fedadam@2"),
        ("scarce/fedadam", (1, 4), grid["scarce", "fedadam"],
         "scarce/fedadam", "scarce/fedadam"),
        ("shakespeare/fedadam", (2, 2), tasks["shakespeare", "fedadam"],
         "shakespeare/fedadam", "shakespeare/fedadam@2"),
    ]


def model_axis_one_axis_specs():
    """(name, spec JSON) of the (2,) runs the ``clients`` phase makes for
    :func:`model_axis_cells`' (2, 2) cells other than the main path."""
    return [(p_name, js) for _, shape, js, _, p_name in model_axis_cells()
            if p_name.endswith("@2")]


def model_axis_rank(mesh, device: str, cells):
    """One of the phase's gloo ranks: each (cell, shape, spec JSON) run
    through ``run_spec(RunSpec(mesh_shape=shape))`` inside this group (as
    under torchrun: ``run_spec`` builds the mesh over the spec's axis
    names), with the kernels' launches counted; the global rank 0 also
    returns each run's fields and whole final parameters."""
    import torch
    from repro_torch.sim import RunSpec, run_spec
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    out = []
    for _, shape, spec_json in cells:
        spec = RunSpec.from_json(spec_json).replace(mesh_shape=shape)
        res, launches, wall = counted(torch, lambda: run_spec(
            spec, device=dev, log_fn=lambda *a: None))
        out.append(dict(launches=launches, wall_s=wall,
                        steady_round_ms=steady_ms(res.final_metrics),
                        res=run_fields(res) if mesh.rank == 0 else None))
    return out


def model_axis(torch, dev, refs):
    """``RunSpec(mesh_shape=(2, 2))`` and ``(1, 4)`` over MODEL_AXIS_RANKS
    gloo ranks on the one card (one spawn), every cell of
    :func:`model_axis_cells`: masks, K_t, |avail| and final r_k bitwise
    the reference card run, train loss and delta norm within LOSS_TOL,
    the final parameters bitwise their reference (whose masks, K_t,
    |avail| and r_k must be the same bits too), and ``fed_select_mask``
    (each rank's candidate cut) and ``fed_aggregate`` launched once a
    round on every rank.  ``refs``: {name: run_fields of the reference
    run}.  Returns the launches and the cells' rounds, summed."""
    import numpy as np
    from repro_torch.launch.mesh import spawn_ranks

    cells = model_axis_cells()
    t0 = time.perf_counter()
    ranks = spawn_ranks(model_axis_rank, MODEL_AXIS_RANKS, str(dev),
                        [c[:3] for c in cells], backend="gloo",
                        threads=MODEL_AXIS_THREADS)
    spawn_wall = time.perf_counter() - t0
    totals = dict(fed_select=0, fed_select_mask=0, fed_aggregate=0)
    ok, total_rounds = True, 0
    for k, (name, shape, _, ref_name, p_name) in enumerate(cells):
        got = ranks[0][k]["res"]
        ref, p_ref = refs[ref_name], refs[p_name]
        rounds = int(got["sel"].shape[0])
        total_rounds += rounds
        bit = same_bits(got, ref, SELECTION)
        p_bit = same_bits(got, p_ref, SELECTION)
        errs = {f + "_max_abs_err": float(np.abs(got[f] - ref[f]).max())
                for f in ("train_loss", "delta_norm")}
        p_same = all(a.tobytes() == b.tobytes()
                     for a, b in zip(got["params"], p_ref["params"]))
        p_err = max(float(np.abs(a - b).max())
                    for a, b in zip(got["params"], p_ref["params"]))
        launches = {f: sum(r[k]["launches"][f] for r in ranks)
                    for f in totals}
        add_launches(totals, launches)
        want = dict(fed_select=0, fed_select_mask=MODEL_AXIS_RANKS * rounds,
                    fed_aggregate=MODEL_AXIS_RANKS * rounds)
        emit(dict(phase="model_axis", cell=name, mesh_shape=list(shape),
                  backend="gloo", ranks=MODEL_AXIS_RANKS, rounds=rounds,
                  engine=got["final"]["engine"],
                  steady_round_ms=ranks[0][k]["steady_round_ms"],
                  rank_steady_round_ms=[r[k]["steady_round_ms"]
                                        for r in ranks],
                  reference_steady_round_ms=steady_ms(ref["final"]),
                  one_axis_2_steady_round_ms=steady_ms(
                      refs["clients_2"]["final"]),
                  wall_s=ranks[0][k]["wall_s"], launches=launches,
                  launches_per_round={f: v / rounds
                                      for f, v in launches.items()},
                  reference=ref_name, bitwise_vs_reference=bit, **errs,
                  tol=LOSS_TOL, params_reference=p_name,
                  bitwise_vs_params_reference=p_bit,
                  params_bitwise=p_same, params_max_abs_diff=p_err,
                  n_params=[list(a.shape) for a in got["params"]],
                  test_acc=got["final"]["test_acc"],
                  reference_test_acc=ref["final"]["test_acc"]))
        ok &= (all(bit.values()) and all(p_bit.values())
               and max(errs.values()) <= LOSS_TOL
               and got["final"]["engine"] == "sharded"
               and p_same and launches == want
               and all(np.isfinite(got["train_loss"])))
    emit(dict(phase="model_axis_summary", cells=len(cells),
              spawn_wall_s=spawn_wall, launches=totals, gpu=gpu_line()))
    if not ok:
        raise AssertionError("model_axis: a cell departs from its "
                             "reference")
    return totals, total_rounds


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

def _tree_to(tree, to):
    """Every leaf ``.to(to)``: a device or a dtype."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, to) for k, v in tree.items()}
    return tree.to(to)


def serve_path(torch, dev, flash_ms: float):
    """llama3.2-1b at full width on the weights ``launch.serve`` draws
    (``serve_params``, timed); returns the prefill's flash launches and
    the weights, which decode_shapes steps next."""
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve, serve_params
    from repro_torch.models import transformer

    arch = get_arch("llama3.2-1b")
    cfg = arch.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = serve_params("llama3.2-1b", 0, smoke=False, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
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
    del logits

    # (b) serve at full width on the same weights: decode only, no flash
    # kernel
    flash_attention.launches = 0
    res = serve("llama3.2-1b", smoke=False, device=dev, params=params,
                log_fn=lambda *a: None)
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
    return launches, params


# ---------------------------------------------------------------------------
# the serving paths' shared steps
# ---------------------------------------------------------------------------

def full_width_prefill(torch, cfg, params, batch, n_attn: int):
    """One ``prefill`` of ``batch`` (B = 1; ``get_model_api(cfg).prefill``:
    the last position's logits) with the flash count set to 0
    just before: ``n_attn`` launches, finite (1, 1, V) logits; then the
    median of 3, the peak memory and a profiled run whose flash kernels
    must all be the tensor-core route's.  The profiler drops some device
    events late in the script (a 1-layer prefill's one flash launch
    among them), so a trace with no flash kernel is taken again over 2,
    then 3 prefills.  Returns the record."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import get_model_api

    prefill = get_model_api(cfg).prefill
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    launches = flash_attention.launches
    finite = bool(torch.isfinite(logits).all())
    if (launches != n_attn or not finite
            or tuple(logits.shape) != (1, 1, cfg.vocab)):
        raise AssertionError(f"{cfg.name} prefill: {launches} flash launches "
                             f"(want {n_attn}), finite {finite}, shape "
                             f"{tuple(logits.shape)}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.reset_peak_memory_stats()
    for steps in (1, 2, 3):
        prof = device_profile(
            torch, lambda: [prefill(params, batch) for _ in range(steps)],
            steps=steps, kernel_name="flash_kernel")[0]
        if prof["kernel_names"]:
            break
    peak = torch.cuda.max_memory_allocated()
    if not prof["kernel_names"] or any(
            "flash_kernel_mma" not in n for n in prof["kernel_names"]):
        raise AssertionError(f"{cfg.name}: profiled flash kernels "
                             f"{prof['kernel_names']} in {steps} prefills")
    # the decoder's sequence: a vlm's patches and its text (an
    # encoder-decoder's frames are its encoder's)
    seq = sum(batch[k].shape[1] for k in ("patch_embeds", "tokens")
              if k in batch)
    return dict(batch=1, seq_len=seq, layers=cfg.n_layers,
                dtype=cfg.dtype, flash_launches=launches,
                logits_finite=finite, first_call_ms=first_ms,
                wall_ms_median_of_3=sorted(walls)[1], wall_ms_runs=walls,
                peak_gb=peak / 1e9, profiled_prefills=steps, profiled=prof)


def served_decode(torch, name, dev, params, n_layers, max_len=128,
                  launches=0):
    """8 greedy steps through ``serve`` (batch 4, prompt 16) on the drawn
    weights, with ``launches`` flash launches: none in the decode steps
    (an encoder-decoder's serve encodes its frames once first, one launch
    an encoder layer)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve

    flash_attention.launches = 0
    res = serve(name, steps=8, smoke=False, device=dev, params=params,
                n_layers=n_layers, max_len=max_len, log_fn=lambda *a: None)
    if flash_attention.launches != launches or res.tokens.shape != (4, 8):
        raise AssertionError(f"{name} serve: {flash_attention.launches} "
                             f"flash launches (want {launches}), tokens "
                             f"{res.tokens.shape}")
    return dict(batch=4, prompt_len=16, steps=8, max_len=max_len,
                flash_launches=launches, tokens_per_s=res.tokens_per_s,
                decode_s=res.decode_s, first_tokens=res.tokens[0].tolist())


def card_vs_cpu_prefill(torch, cfg, p32, batch):
    """The card's float32 prefill (the flash kernel's float32 route)
    against the CPU's (plain) on the same weights: (max |err|, the CPU's
    largest logit, the card's flash launches)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import get_model_api

    prefill = get_model_api(cfg).prefill
    dev = p32["embed"].device
    flash_attention.launches = 0
    card = prefill(p32, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = flash_attention.launches
    cpu = prefill(_tree_to(p32, "cpu"), batch)
    return (float((card.cpu() - cpu).abs().max()), float(cpu.abs().max()),
            launches)


# ---------------------------------------------------------------------------
# dense path: qwen3-8b, qwen3-14b and gemma-7b at full width
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("qwen3-8b", "qwen3-14b", "gemma-7b")
# every width, about an eighth of the depth (of 36, 40 and 28 layers): half
# when the moe archs joined the script, a quarter when the hybrid and vlm
# archs did, an eighth when the audio and decode-shape phases did, to keep
# it inside its 1,200 s limit
DENSE_DEPTH = {"qwen3-8b": 5, "qwen3-14b": 5, "gemma-7b": 4}
DENSE_F32_LAYERS = 2
INIT_WINDOW = 4096          # lanes of each drawn row re-drawn on the CPU


class DrawWindows:
    """Windows of one drawn leaf re-drawn on the CPU: ``parts`` maps
    (layer row, first lane) to the lanes' values."""

    def __init__(self, parts):
        self.parts = parts


def init_windows_check(torch, cfg, key, card):
    """``card``, drawn on the card by ``init_params(cfg, key)``, against
    the CPU's draw from ``key`` (on the CPU), without drawing the full
    widths on the CPU: the CPU walks the same key tree (``init_params``
    with ``layers._normal`` replaced) and re-draws, for each drawn leaf and
    each layer's row of it, the first and the last INIT_WINDOW lanes and
    the window that straddles the draw's first 2^24-lane chunk boundary,
    with the same ``random.normal(start=)``; every undrawn leaf (the norms)
    is compared whole, the computed ones (ULP_LEAVES) within an ulp.
    Returns (the windows and leaves compared, the paths that differ, the
    computed leaves' largest ulp gaps)."""
    import math

    from repro_torch import random as jr
    from repro_torch.models import encdec, get_model_api, layers, ssm, \
        transformer

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

    mods = (layers, transformer, ssm, encdec)
    saved = [m._normal for m in mods]
    for m in mods:
        m._normal = windows
    try:
        cpu = get_model_api(cfg).init_params(key, "cpu")
    finally:
        for m, fn in zip(mods, saved):
            m._normal = fn
    compared, differ, ulps = 0, [], {}
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
        elif path.rsplit("/", 1)[-1] in ULP_LEAVES:
            compared += 1
            ulps[path] = ulp_gap(torch, got.cpu(), want)
            if ulps[path] > 1:
                differ.append(path)
        else:
            compared += 1
            if not same_tensor_bits(torch, got.cpu(), want):
                differ.append(path)
    return compared, differ, ulps


# computed, not drawn (torch's log and expm1 on the card and on the CPU
# round apart): held within an ulp
ULP_LEAVES = ("A_log", "lam")


def ulp_gap(torch, a, b) -> int:
    """The largest distance in float32 steps between two float32 tensors
    of one shape."""
    if a.dtype != torch.float32 or b.dtype != a.dtype or a.shape != b.shape:
        return 1 << 31
    return int((a.contiguous().view(torch.int32).long()
                - b.contiguous().view(torch.int32).long()).abs().max())


def same_tensor_bits(torch, a, b) -> bool:
    """Equal dtypes, shapes and bits (NaNs and signed zeros included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(as_int),
                       b.contiguous().view(as_int))


def dense_path(torch, dev):
    """Each dense arch at full width and DENSE_DEPTH through
    ``launch.serve``'s entry points; returns the flash launches of their
    prefills."""
    from repro_torch import random as jr
    from repro_torch.launch.serve import serve_config, serve_params

    total = 0
    for name in DENSE_ARCHS:
        torch.cuda.empty_cache()
        depth = DENSE_DEPTH[name]
        cfg = serve_config(name, smoke=False, n_layers=depth)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = serve_params(name, 0, smoke=False, device=dev,
                              n_layers=depth)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in tree_leaves(params))
        gen = torch.Generator(device=dev).manual_seed(2)
        batch = {"tokens": torch.randint(0, cfg.vocab, (1, 8192),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)}

        # (a) prefill, B = 1, S = 8192, one flash launch a layer
        prefill = full_width_prefill(torch, cfg, params, batch,
                                     cfg.n_layers)
        total += prefill["flash_launches"]
        prefill.update(of_layers=serve_config(name, smoke=False).n_layers,
                       head_dim=cfg.head_dim, n_params=n_params,
                       init_params_s=init_s)

        # (b) a few decode tokens through serve, on the same weights
        served = served_decode(torch, name, dev, params, depth)

        # (c) the draw, by windows of every row against the CPU's, then
        # the first layers in float32: the card's logits (kernel) against
        # the CPU's (plain) on the same weights
        compared, differ, _ = init_windows_check(
            torch, cfg, jr.split(jr.PRNGKey(0, device="cpu"), 3)[0], params)
        if differ:
            raise AssertionError(f"{name} init: card differs in {differ}")
        cfg2 = cfg.replace(n_layers=DENSE_F32_LAYERS, dtype="float32")
        p2 = _tree_to(first_layers(params, DENSE_F32_LAYERS), torch.float32)
        del params
        torch.cuda.empty_cache()
        toks = torch.randint(0, cfg.vocab, (1, 512), generator=gen,
                             device=dev, dtype=torch.int32)
        card_vs_cpu, _, card_launches = card_vs_cpu_prefill(
            torch, cfg2, p2, {"tokens": toks.cpu()})
        if (card_launches != DENSE_F32_LAYERS
                or not card_vs_cpu <= F32_LOGIT_TOL):
            raise AssertionError(f"{name} depth-2 card vs CPU: "
                                 f"{card_vs_cpu} ({card_launches} launches)")
        del p2
        emit(dict(phase="dense_path", arch=name, prefill=prefill,
                  serve=served, init=dict(seed=0, key="serve_params",
                                          compared=compared,
                                          not_bitwise=[]),
                  depth2_f32_card_vs_cpu_max_abs_err=card_vs_cpu))
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# moe path: mixtral-8x22b and grok-1-314b at full width, cut in depth
# ---------------------------------------------------------------------------

# Every width kept, the depth cut to what one card holds: mixtral's layer
# is 2.504 B parameters (5.0 GB in bf16), grok's 4.920 B (9.84 GB); 2 and
# 1 layers (were 4 and 2) since the hybrid and vlm archs joined the
# script, 1 and 1 since the audio and decode-shape phases did
MOE_DEPTH = {"mixtral-8x22b": 1, "grok-1-314b": 1}
# the first layers cast to float32 for the card-vs-CPU prefill: grok's
# layer is 9.84 GB in bf16, so one (its bf16 copy written for the CPU and
# its float32 copy on the card each half of two layers')
MOE_F32_LAYERS = {"mixtral-8x22b": 1, "grok-1-314b": 1}
MOE_F32_SEQ = 512
# moe_block alone at S = 300, groups of 256: the second group padded with
# 212 zero rows, whose router probabilities tie exactly
MOE_BLOCK_SEQ, MOE_BLOCK_GROUP = 300, 256
MOE_BLOCK_RTOL = 1e-4       # y's largest gap over y's largest lane
MOE_LB_RTOL = 1e-6          # lb_loss: a mean over tokens, summed in
#                             another order on the card
MOE_CPU_THREADS = 6
# the worker's float32 arithmetic pinned to one code path on every x86
# host: ATen's kernels and MKL's GEMMs at AVX2 (chip_moe_cpu_pin.py
# measures what the thread count and each ISA choice move; ROADMAP.md
# queue 3 item 1)
MOE_CPU_ENV = {"ATEN_CPU_CAPABILITY": "avx2", "MKL_CBWR": "AVX2"}
TIED_ROWS = [[0.125] * 8, [0.1, 0.3, 0.3, 0.3, 0, 0, 0, 0],
             [0.25, 0.25, 0, 0, 0.25, 0.25, 0, 0], [0] * 7 + [1]]


def moe_f32_config(name: str):
    from repro_torch.configs import get_arch
    return get_arch(name).model.replace(n_layers=MOE_F32_LAYERS[name],
                                        dtype="float32")


def moe_inputs(torch, cfg):
    """The card-vs-CPU check's prompt and moe_block input, drawn on the
    CPU from a seed (the same in the main process and the worker)."""
    gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab, (1, MOE_F32_SEQ), generator=gen,
                         dtype=torch.int32)
    x = torch.randn(1, MOE_BLOCK_SEQ, cfg.d_model, generator=gen)
    return toks, x


@contextlib.contextmanager
def recorded_routing(log, summary):
    """Inside it, each ``moe_block`` call of the model also appends
    ``summary(routing, x)`` to ``log`` (``layers.moe_routing`` of the same
    input ``x``, the router's, recomputed)."""
    from repro_torch.models import layers, transformer
    block = transformer.moe_block

    def rec(p, x, cfg):
        log.append(summary(layers.moe_routing(p, x, cfg), x))
        return block(p, x, cfg)
    transformer.moe_block = rec
    try:
        yield
    finally:
        transformer.moe_block = block


def drop_summary(r, x) -> dict:
    """The share of the real tokens' (token, choice) pairs that capacity
    dropped, and what the router's input ``x`` (B, S, d) shares across
    positions: the mean cosine between two positions' rows, and the norm
    of the rows' mean over their mean norm."""
    B, S = x.shape[:2]
    nG, G, k, E = r.keep.shape[1:]
    kept = r.keep.reshape(B, nG * G, k, E)[:, :S].any(-1)
    x = x.float()
    unit = x / x.norm(dim=-1, keepdim=True)
    total = unit.sum(1).norm(dim=-1) ** 2          # sum over pairs, i = j too
    return dict(dropped_share=1.0 - float(kept.sum()) / kept.numel(),
                input_mean_cosine=float(((total - S) / (S * (S - 1))).mean()),
                input_mean_over_norm=float(
                    (x.mean(1).norm(dim=-1) / x.norm(dim=-1).mean(1)).mean()))


def route_summary(r, x):
    """The real tokens' chosen experts (B, S, k) and their three largest
    router probabilities (B, S, 3), on the CPU."""
    B, nG, G, k = r.idx.shape
    S = x.shape[1]
    top3 = r.probs.sort(dim=-1, descending=True).values[..., :3]
    return (r.idx.reshape(B, nG * G, k)[:, :S].cpu(),
            top3.reshape(B, nG * G, 3)[:, :S].cpu())


def moe_cpu_side(torch, name, params):
    """What the card's side of the check is held to, computed with
    ``params`` (float32) on their device: the depth-cut prefill with each
    layer's routing, moe_block alone on layer 0 (y, lb_loss, the experts
    and slots of every row, padded ones included) and ``top_k`` of the
    tied rows."""
    from repro_torch.models import layers, transformer
    cfg = moe_f32_config(name)
    dev = params["embed"].device
    toks, x = (t.to(dev) for t in moe_inputs(torch, cfg))
    routes = []
    with recorded_routing(routes, route_summary):
        logits = transformer.prefill(cfg, params, {"tokens": toks})
    bcfg = cfg.replace(moe_group_size=MOE_BLOCK_GROUP)
    p0 = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    y, aux = layers.moe_block(p0, x, bcfg)
    r = layers.moe_routing(p0, x, bcfg)
    tv, ti = layers.top_k(torch.tensor(TIED_ROWS, device=dev), 2)
    return dict(logits=logits.cpu(), routes=routes, y=y.cpu(),
                lb=aux["lb_loss"].cpu(), idx=r.idx.cpu(), slot=r.slot.cpu(),
                top_k=(tv.cpu(), ti.cpu()))


def cpu_runtime(torch) -> dict:
    """What this process's float32 CPU arithmetic ran with: the vector ISA
    ATen's kernels dispatch to, the intra-op threads, MKL's code-path
    setting and the CPU (model name, vendor and its wide-vector flags from
    /proc/cpuinfo)."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "vendor_id", "flags") \
                        and key not in info:
                    info[key] = value.strip()
                if len(info) == 3:
                    break
    except OSError:
        pass
    flags = set(info.get("flags", "").split())
    return dict(isa=torch.backends.cpu.get_cpu_capability(),
                threads=torch.get_num_threads(),
                mkl_cbwr=os.environ.get("MKL_CBWR"),
                aten_cpu_capability=os.environ.get("ATEN_CPU_CAPABILITY"),
                cpu_model=info.get("model name"),
                cpu_vendor=info.get("vendor_id"),
                cpu_flags=sorted(f for f in flags if f.startswith(
                    ("avx512", "amx")) or f in ("avx2", "fma")))


def moe_cpu(src: str, name: str, path: str, threads: int, results) -> None:
    """:func:`moe_cpu_side` on the CPU (a spawned worker, MOE_CPU_ENV set
    before torch is imported), from the card's first layers saved at
    ``path`` in bfloat16 and cast here; the result goes back as numpy
    arrays, with what the worker ran with (:func:`cpu_runtime`)."""
    os.environ.update(MOE_CPU_ENV)
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    params = _tree_to(torch.load(path, mmap=True), torch.float32)
    out = moe_cpu_side(torch, name, params)

    def to_np(x):
        if isinstance(x, (list, tuple)):
            return [to_np(v) for v in x]
        if isinstance(x, dict):
            return {k: to_np(v) for k, v in x.items()}
        return x.numpy()
    out = to_np(out)
    out["wall_s"] = time.perf_counter() - t0
    out["runtime"] = cpu_runtime(torch)
    results.put(out)


def first_layers(params, n: int, stack="blocks"):
    """The embeddings, the final norm (and a vlm's projector) and the first
    n entries of ``stack`` (a name, or a tuple of names): the stacked
    layers, a hybrid's "groups" (its tail left out), or an
    encoder-decoder's ("enc_blocks", "dec_blocks")."""
    stacks = (stack,) if isinstance(stack, str) else tuple(stack)

    def cut(tree):
        return ({k: cut(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree[:n])
    return dict({k: v for k, v in params.items()
                 if k not in stacks + ("tail",)},
                **{k: cut(params[k]) for k in stacks})


def moe_compare(torch, card, cpu) -> dict:
    """The card's side against the CPU's (numpy) on the same weights."""
    import numpy as np
    flips, gaps = [], []
    for (ci, cp), (pi, pp) in zip(card["routes"], cpu["routes"]):
        flips.append(int((ci.numpy() != pi).any(-1).sum()))
        gaps.append(float((pp[..., 1] - pp[..., 2]).min()))
    y, y_cpu = card["y"].numpy(), cpu["y"]
    lb, lb_cpu = float(card["lb"]), float(cpu["lb"])
    tv, ti = card["top_k"]
    return dict(
        prefill_max_abs_err=float(np.abs(card["logits"].numpy()
                                         - cpu["logits"]).max()),
        logit_scale=float(np.abs(cpu["logits"]).max()),
        routing_layers=len(flips), tokens_with_other_experts=flips,
        smallest_2nd_3rd_prob_gap=gaps,
        block_y_rel_err=float(np.abs(y - y_cpu).max() / np.abs(y_cpu).max()),
        block_lb_loss=[lb, lb_cpu], block_lb_rel_err=abs(lb - lb_cpu)
        / abs(lb_cpu), block_lb_bitwise=lb == lb_cpu,
        block_experts_equal=bool((card["idx"].numpy() == cpu["idx"]).all()),
        block_slots_equal=bool((card["slot"].numpy() == cpu["slot"]).all()),
        top_k_tied_bitwise=bool(
            ti.numpy().tobytes() == cpu["top_k"][1].tobytes()
            and tv.numpy().tobytes() == cpu["top_k"][0].tobytes()))


def moe_path(torch, dev):
    """Each moe arch at full width and cut depth through ``launch.serve``'s
    entry points, then the card against the CPU on the same drawn weights;
    returns the flash launches of the full-width prefills."""
    import multiprocessing
    from repro_torch import random as jr
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve_config, serve_params
    from repro_torch.models import transformer

    ctx = multiprocessing.get_context("spawn")
    total = 0
    for name, depth in MOE_DEPTH.items():
        torch.cuda.empty_cache()
        cfg = serve_config(name, smoke=False, n_layers=depth)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = serve_params(name, 0, smoke=False, device=dev,
                              n_layers=depth)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in tree_leaves(params))
        # the CPU's side runs meanwhile, from the first layers' bf16 weights
        t0 = time.perf_counter()
        path = ROOT / "build" / f"moe_{name}.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(_tree_to(first_layers(params, MOE_F32_LAYERS[name]),
                            "cpu"), path)
        save_s = time.perf_counter() - t0
        results = ctx.Queue()
        proc = ctx.Process(target=moe_cpu, args=(
            str(ROOT / "src"), name, str(path), MOE_CPU_THREADS, results),
            daemon=True)
        proc.start()
        try:
            gen = torch.Generator(device=dev).manual_seed(2)
            batch = {"tokens": torch.randint(0, cfg.vocab, (1, 8192),
                                             generator=gen, device=dev,
                                             dtype=torch.int32)}

            # (a) prefill, B = 1, S = 8192 (two routing groups of 4096),
            # one flash launch a layer
            prefill = full_width_prefill(torch, cfg, params, batch, depth)
            total += prefill["flash_launches"]
            drops = []
            with recorded_routing(drops, drop_summary):
                transformer.prefill(cfg, params, batch)
            prefill.update(of_layers=serve_config(name, smoke=False).n_layers,
                           n_params=n_params, init_params_s=init_s,
                           cpu_copy_save_s=save_s,
                           capacity_dropped_share_by_layer=[
                               d["dropped_share"] for d in drops],
                           router_input_mean_cosine_by_layer=[
                               d["input_mean_cosine"] for d in drops],
                           router_input_mean_over_norm_by_layer=[
                               d["input_mean_over_norm"] for d in drops])

            # (b) decode through serve on the same weights: no flash
            served = served_decode(torch, name, dev, params, depth)

            # (c) 1. the draw, by windows of every row against the CPU's
            compared, differ, _ = init_windows_check(
                torch, cfg, jr.split(jr.PRNGKey(0, device="cpu"), 3)[0],
                params)
            if differ:
                raise AssertionError(f"{name} init: card differs in "
                                     f"{differ}")
            # 2.-4. the first layers in float32, card against CPU
            p32 = _tree_to(first_layers(params, MOE_F32_LAYERS[name]),
                           torch.float32)
            del params
            torch.cuda.empty_cache()
            flash_attention.launches = 0
            card = moe_cpu_side(torch, name, p32)
            card_launches = flash_attention.launches
            del p32
            torch.cuda.empty_cache()
            cpu = finish_cpu(proc, results, timeout=900)
            if cpu is None:
                raise AssertionError(f"{name}: the CPU's side gave no "
                                     f"result")
        finally:
            if proc.is_alive():
                proc.terminate()
                proc.join()
            path.unlink(missing_ok=True)
        check = moe_compare(torch, card, cpu)
        ok = (card_launches == MOE_F32_LAYERS[name]
              and check["prefill_max_abs_err"] <= 1e-4
              and not any(check["tokens_with_other_experts"])
              and check["block_y_rel_err"] <= MOE_BLOCK_RTOL
              and check["block_lb_rel_err"] <= MOE_LB_RTOL
              and check["block_experts_equal"] and check["block_slots_equal"]
              and check["top_k_tied_bitwise"])
        emit(dict(phase="moe_path", arch=name, prefill=prefill,
                  serve=served, init=dict(seed=0, key="serve_params",
                                          compared=compared, not_bitwise=[]),
                  f32_check=dict(layers=MOE_F32_LAYERS[name],
                                 seq_len=MOE_F32_SEQ,
                                 block_seq_group=[MOE_BLOCK_SEQ,
                                                  MOE_BLOCK_GROUP],
                                 flash_launches=card_launches,
                                 cpu_wall_s=cpu["wall_s"],
                                 cpu_threads=MOE_CPU_THREADS,
                                 cpu_runtime=cpu["runtime"], **check)))
        if not ok:
            raise AssertionError(f"{name} card vs CPU: {check} "
                                 f"({card_launches} launches)")
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# hybrid and vlm paths: recurrentgemma-2b whole, llava-next-34b cut in depth
# ---------------------------------------------------------------------------

HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_F32_SEQ = 3072       # the window of 2048 hides the first 1,024 keys
#                             from the last rows
RING_MAX_LEN = 2304         # past the window: caches of exactly 2,048 slots
RGLRU_RTOL = 1e-5           # rglru_block alone, float32, card vs CPU
VLM_ARCH = "llava-next-34b"
# every width; 4 of 60 layers (557,856,768 parameters a layer: the whole
# model's 68.9 GB of bf16 would nearly fill the card, and its draw would
# take ~170 s); 8 until the audio and decode-shape phases joined the script
VLM_DEPTH = 4
VLM_F32_LAYERS = 2
VLM_F32_TEXT = 512          # after the 1,024 patches


def rec_layer_parts(torch, cfg, params, x):
    """Where a recurrent layer's RG-LRU spends its time at ``x``'s shape,
    on the first group's first block: the two float32 gate GEMMs, all of
    ``_rglru_gates``, the scan and the whole ``rglru_block``, each in ms
    (CUDA events) and device launches (a profiled call)."""
    from repro_torch.models import ssm

    p = {k: v[0] for k, v in params["groups"]["0_rec"]["rglru"].items()}
    u = ssm.causal_conv1d(x @ p["wx"], p["conv_w"], p["conv_b"])
    u32, wa, wi = u.float(), p["w_a"].float(), p["w_i"].float()
    a, gated = ssm._rglru_gates(p, u)
    parts = {"gate_gemms": lambda: (u32 @ wa, u32 @ wi),
             "gates": lambda: ssm._rglru_gates(p, u),
             "scan": lambda: ssm._linear_scan(a, gated),
             "rglru_block": lambda: ssm.rglru_block(p, x, cfg)}
    out = {}
    for name, fn in parts.items():
        out[f"{name}_ms"] = cuda_ms(fn, warmup=2, runs=9)
        out[f"{name}_launches"] = device_profile(
            torch, fn)[0]["device_launches_per_step"]
    S, w = u.shape[1], u.shape[2]
    out["gate_gemms_tflops_per_s"] = 4.0 * S * w * w / out["gate_gemms_ms"] \
        / 1e9
    return out


def hybrid_path(torch, dev):
    """recurrentgemma-2b at full width and depth (8 groups of (rec, rec,
    attn) and a tail of 2 rec blocks) through ``launch.serve``'s entry
    points, then the card against the CPU on the same drawn weights;
    returns the flash launches of the full-width prefill."""
    from repro_torch import random as jr
    from repro_torch.launch.serve import serve_config, serve_params
    from repro_torch.models import ssm, transformer

    torch.cuda.empty_cache()
    name = HYBRID_ARCH
    cfg = serve_config(name, smoke=False)
    pat, n_groups, rem = transformer._hybrid_layout(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = serve_params(name, 0, smoke=False, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 8192), generator=gen,
                                     device=dev, dtype=torch.int32)}

    # (a) prefill, B = 1, S = 8192: one flash launch a group's attention
    prefill = full_width_prefill(torch, cfg, params, batch, n_groups)
    n_rec = cfg.n_layers - n_groups
    x = torch.randn(1, 8192, cfg.d_model, generator=gen, device=dev).to(
        cfg.torch_dtype)
    parts = rec_layer_parts(torch, cfg, params, x)
    parts["rec_layers"] = n_rec
    parts["gates_and_scan_share_of_prefill"] = n_rec * (
        parts["gates_ms"] + parts["scan_ms"]) / prefill["wall_ms_median_of_3"]
    prefill.update(n_params=n_params, init_params_s=init_s,
                   rec_layer=parts)
    del x

    # (b) decode through serve; then with caches of exactly the window,
    # which attention_decode takes as rings
    served = served_decode(torch, name, dev, params, None)
    ring_state = transformer.init_decode_state(cfg, 4, RING_MAX_LEN, dev)
    ring_slots = ring_state["groups"]["2_attn"]["k"].shape[2]
    del ring_state
    if ring_slots != cfg.sliding_window:
        raise AssertionError(f"{name}: {ring_slots} cache slots at max_len "
                             f"{RING_MAX_LEN}")
    ring = served_decode(torch, name, dev, params, None, RING_MAX_LEN)
    ring["cache_slots"] = ring_slots

    # (c) 1. the draw, by windows of every row (lam within an ulp)
    compared, differ, ulps = init_windows_check(
        torch, cfg, jr.split(jr.PRNGKey(0, device="cpu"), 3)[0], params)
    if differ:
        raise AssertionError(f"{name} init: card differs in {differ}")
    # 2. the first group in float32 at S = 3072, card against CPU
    cfg1 = cfg.replace(n_layers=len(pat), dtype="float32")
    p32 = _tree_to(first_layers(params, 1, "groups"), torch.float32)
    del params
    torch.cuda.empty_cache()
    cpu_gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab, (1, HYBRID_F32_SEQ), generator=cpu_gen,
                         dtype=torch.int32)
    t0 = time.perf_counter()
    err, scale, f32_launches = card_vs_cpu_prefill(torch, cfg1, p32,
                                                   {"tokens": toks})
    # 3. rglru_block alone on layer 0's float32 weights at S = 8192
    p0 = {k: v[0] for k, v in p32["groups"]["0_rec"]["rglru"].items()}
    xs = torch.randn(1, 8192, cfg.d_model, generator=cpu_gen)
    y_card = ssm.rglru_block(p0, xs.to(dev), cfg1).cpu()
    y_cpu = ssm.rglru_block(_tree_to(p0, "cpu"), xs, cfg1)
    rglru_rel = float((y_card - y_cpu).abs().max() / y_cpu.abs().max())
    cpu_s = time.perf_counter() - t0
    del p32
    torch.cuda.empty_cache()
    check = dict(layers=len(pat), seq_len=HYBRID_F32_SEQ,
                 window=cfg.sliding_window, flash_launches=f32_launches,
                 prefill_max_abs_err=err, logit_scale=scale,
                 rglru_block_seq_len=8192, rglru_block_rel_err=rglru_rel,
                 wall_s=cpu_s)
    emit(dict(phase="hybrid_path", arch=name, prefill=prefill, serve=served,
              serve_ring=ring,
              init=dict(seed=0, key="serve_params", compared=compared,
                        not_bitwise=[], computed_leaf_ulps=max(
                            ulps.values())),
              f32_check=check))
    if (f32_launches != 1 or not err <= F32_LOGIT_TOL
            or not rglru_rel <= RGLRU_RTOL):
        raise AssertionError(f"{name} card vs CPU: {check}")
    torch.cuda.empty_cache()
    return prefill["flash_launches"]


def vlm_path(torch, dev):
    """llava-next-34b at full width and VLM_DEPTH layers through
    ``launch.serve``'s entry points (1,024 patch embeddings before 7,168
    text tokens), then the card against the CPU on the same drawn weights;
    returns the flash launches of the full-width prefill."""
    from repro_torch import random as jr
    from repro_torch.launch.serve import serve_config, serve_params

    torch.cuda.empty_cache()
    name = VLM_ARCH
    cfg = serve_config(name, smoke=False, n_layers=VLM_DEPTH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = serve_params(name, 0, smoke=False, device=dev,
                          n_layers=VLM_DEPTH)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(2)
    P = cfg.n_patches
    batch = {"patch_embeds": torch.randn(1, P, cfg.vit_dim, generator=gen,
                                         device=dev).to(cfg.torch_dtype),
             "tokens": torch.randint(0, cfg.vocab, (1, 8192 - P),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}

    # (a) prefill, B = 1, S = 1,024 patches + 7,168 tokens
    prefill = full_width_prefill(torch, cfg, params, batch, VLM_DEPTH)
    prefill.update(of_layers=serve_config(name, smoke=False).n_layers,
                   patches=P, text_tokens=8192 - P, n_params=n_params,
                   init_params_s=init_s)

    # (b) decode through serve: text only
    served = served_decode(torch, name, dev, params, VLM_DEPTH)

    # (c) 1. the draw, by windows of every row
    compared, differ, _ = init_windows_check(
        torch, cfg, jr.split(jr.PRNGKey(0, device="cpu"), 3)[0], params)
    if differ:
        raise AssertionError(f"{name} init: card differs in {differ}")
    # 2. the first layers and the projector in float32, card against CPU
    cfg2 = cfg.replace(n_layers=VLM_F32_LAYERS, dtype="float32")
    p32 = _tree_to(first_layers(params, VLM_F32_LAYERS), torch.float32)
    del params
    torch.cuda.empty_cache()
    cpu_gen = torch.Generator().manual_seed(11)
    small = {"patch_embeds": torch.randn(1, P, cfg.vit_dim,
                                         generator=cpu_gen),
             "tokens": torch.randint(0, cfg.vocab, (1, VLM_F32_TEXT),
                                     generator=cpu_gen, dtype=torch.int32)}
    t0 = time.perf_counter()
    err, scale, f32_launches = card_vs_cpu_prefill(torch, cfg2, p32, small)
    check = dict(layers=VLM_F32_LAYERS, patches=P, text_tokens=VLM_F32_TEXT,
                 flash_launches=f32_launches, prefill_max_abs_err=err,
                 logit_scale=scale, wall_s=time.perf_counter() - t0)
    del p32
    torch.cuda.empty_cache()
    emit(dict(phase="vlm_path", arch=name, prefill=prefill, serve=served,
              init=dict(seed=0, key="serve_params", compared=compared,
                        not_bitwise=[]),
              f32_check=check))
    if f32_launches != VLM_F32_LAYERS or not err <= F32_LOGIT_TOL:
        raise AssertionError(f"{name} card vs CPU: {check}")
    return prefill["flash_launches"]


# ---------------------------------------------------------------------------
# audio path: whisper-small whole; decode shapes: llama3.2-1b's KV caches
# ---------------------------------------------------------------------------

AUDIO_ARCH = "whisper-small"
# prefill_32k's length cut as the other archs' (past the 4,096 decoder
# positions: JAX's branch that adds none), then whisper's target length
# of 448 (the branch that adds them)
AUDIO_SEQ = 8192
AUDIO_TARGET_SEQ = 448
AUDIO_F32_LAYERS = 2        # of the encoder's and of the decoder's
DECODE_ARCH = "llama3.2-1b"
# decode_32k's batch cut from 128 to 32: its KV cache is then 16 layers x
# k, v x 32 x 32,768 x 8 heads x 64 bf16 = 34.4 GB (137 GB at 128);
# long_500k at its own batch of 1, a ring of 8,192 slots
# (long_context_window) a layer
DECODE_BATCH = {"decode_32k": 32, "long_500k": 1}
# the steps: decode_32k's 8 from index 32,760, its last positions;
# long_500k's 16 from index 524,280, slots 8,184-8,191 and then 0-7 of
# the ring: it wraps in the run
DECODE_STEPS = {"decode_32k": 8, "long_500k": 16}
DECODE_START = {"decode_32k": 32_760, "long_500k": 524_280}
# the depth-2 float32 step, card against CPU on the same cache: 2 rows of
# decode_32k's cache (537 MB in float32), long_500k's whole
DECODE_F32_BATCH = {"decode_32k": 2, "long_500k": 1}
DECODE_F32_LAYERS = 2


def audio_path(torch, dev):
    """whisper-small at full width and depth (12 + 12 layers, bf16) through
    ``launch.serve``'s entry points, then the card against the CPU on the
    same drawn weights; returns the flash launches counted in its
    prefills and its serve."""
    from repro_torch import random as jr
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve_config, serve_params
    from repro_torch.models import encdec, get_model_api

    torch.cuda.empty_cache()
    name = AUDIO_ARCH
    cfg = serve_config(name, smoke=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = serve_params(name, 0, smoke=False, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(2)
    frames = torch.randn(1, cfg.enc_seq, cfg.d_model, generator=gen,
                         device=dev).to(cfg.torch_dtype)
    tokens = torch.randint(0, cfg.vocab, (1, AUDIO_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    # one launch an encoder layer, two a decoder layer (self and cross)
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers

    # (a) prefill, B = 1, 1,500 frames and S = 8192 tokens; then at 448
    batch = {"frames": frames, "tokens": tokens}
    prefill = full_width_prefill(torch, cfg, params, batch, n_attn)
    prefill.update(enc_seq=cfg.enc_seq, enc_layers=cfg.n_enc_layers,
                   decoder_positions=AUDIO_SEQ <= encdec.DEC_POS,
                   n_params=n_params, init_params_s=init_s)
    short = {"frames": frames, "tokens": tokens[:, :AUDIO_TARGET_SEQ]}
    api = get_model_api(cfg)
    flash_attention.launches = 0
    logits = api.prefill(params, short)
    torch.cuda.synchronize()
    short_launches = flash_attention.launches
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill(params, short)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    target = dict(seq_len=AUDIO_TARGET_SEQ, flash_launches=short_launches,
                  decoder_positions=AUDIO_TARGET_SEQ <= encdec.DEC_POS,
                  logits_finite=bool(torch.isfinite(logits).all()),
                  wall_ms_median_of_3=sorted(walls)[1], wall_ms_runs=walls)
    if (short_launches != n_attn or not target["logits_finite"]
            or tuple(logits.shape) != (1, 1, cfg.vocab)):
        raise AssertionError(f"{name} prefill at {AUDIO_TARGET_SEQ}: "
                             f"{target}, logits {tuple(logits.shape)}")
    del logits

    # (b) decode through serve: the frames encoded once (encdec.prefill of
    # the cross K/V, one launch an encoder layer), then no launch a step
    served = served_decode(torch, name, dev, params, None,
                           launches=cfg.n_enc_layers)

    # (c) 1. the draw, by windows of every row
    compared, differ, _ = init_windows_check(
        torch, cfg, jr.split(jr.PRNGKey(0, device="cpu"), 3)[0], params)
    if differ:
        raise AssertionError(f"{name} init: card differs in {differ}")
    # 2. the first layers of both stacks in float32, card against CPU, at
    # whisper's target length
    n = AUDIO_F32_LAYERS
    cfg2 = cfg.replace(n_layers=n, n_enc_layers=n, dtype="float32")
    p32 = _tree_to(first_layers(params, n, ("enc_blocks", "dec_blocks")),
                   torch.float32)
    del params
    torch.cuda.empty_cache()
    cpu_gen = torch.Generator().manual_seed(11)
    small = {"frames": torch.randn(1, cfg.enc_seq, cfg.d_model,
                                   generator=cpu_gen),
             "tokens": torch.randint(0, cfg.vocab, (1, AUDIO_TARGET_SEQ),
                                     generator=cpu_gen, dtype=torch.int32)}
    t0 = time.perf_counter()
    err, scale, f32_launches = card_vs_cpu_prefill(torch, cfg2, p32, small)
    check = dict(enc_layers=n, dec_layers=n, enc_seq=cfg.enc_seq,
                 seq_len=AUDIO_TARGET_SEQ, flash_launches=f32_launches,
                 prefill_max_abs_err=err, logit_scale=scale,
                 wall_s=time.perf_counter() - t0)
    del p32
    torch.cuda.empty_cache()
    emit(dict(phase="audio_path", arch=name, prefill=prefill,
              prefill_target=target, serve=served,
              init=dict(seed=0, key="serve_params", compared=compared,
                        not_bitwise=[]),
              f32_check=check))
    if f32_launches != 3 * n or not err <= F32_LOGIT_TOL:
        raise AssertionError(f"{name} card vs CPU: {check}")
    return prefill["flash_launches"] + short_launches + cfg.n_enc_layers


def decode_state_check(state, shapes, batch: int):
    """The allocated decode state's leaves against ``build_decode_step``'s
    shapes and dtypes, with the batch axis (1 of every cache leaf) cut to
    ``batch``."""
    got = {path: (tuple(t.shape), t.dtype)
           for path, t in tree_items(state)}
    want = {path: (s.shape if len(s.shape) < 2 else
                   s.shape[:1] + (batch,) + s.shape[2:], s.dtype)
            for path, s in tree_items(shapes)}
    if got != want:
        raise AssertionError(f"decode state {got}, specs {want}")


def decode_shapes(torch, dev, params):
    """llama3.2-1b at full width through ``launch.steps.build_decode_step``
    at decode_32k (batch cut to 32) and long_500k, on ``params`` (the
    weights serve_path drew): each cache filled at random and stepped from
    near the shape's end with the flash count at 0; then the first layers
    in float32, card against CPU on one cache.  Returns 0, the flash
    launches of its steps."""
    from repro_torch.configs import INPUT_SHAPES, get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models import get_model_api

    arch = get_arch(DECODE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(5)
    for shape in ("decode_32k", "long_500k"):
        step, state_shapes, tok_shape = build_decode_step(arch, shape)
        cfg = arch.model_for_shape(shape)
        shp = INPUT_SHAPES[shape]
        B, n_steps = DECODE_BATCH[shape], DECODE_STEPS[shape]
        api = get_model_api(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = api.init_decode_state(B, shp["seq_len"], dev)
        decode_state_check(state, state_shapes, B)
        for t in state["caches"].values():
            t.normal_(generator=gen)
        state["index"].fill_(DECODE_START[shape])
        toks = torch.randint(0, cfg.vocab, (B, n_steps), generator=gen,
                             device=dev, dtype=torch.int32)
        flash_attention.launches = 0
        walls, finite = [], True
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = step(params, state, toks[:, i:i + 1])
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            finite = finite and bool(torch.isfinite(logits).all())
        launches = flash_attention.launches
        slots = state["caches"]["k"].shape[2]
        row = dict(arch=DECODE_ARCH, shape=shape, batch=B,
                   shape_batch=shp["global_batch"],
                   tok_shape=list(tok_shape.shape), seq_len=shp["seq_len"],
                   window=cfg.long_context_window, cache_slots=slots,
                   cache_gb=sum(t.numel() * t.element_size()
                                for t in state["caches"].values()) / 1e9,
                   start_index=DECODE_START[shape], steps=n_steps,
                   last_index=int(state["index"]) - 1,
                   first_slot=DECODE_START[shape] % slots,
                   last_slot=(int(state["index"]) - 1) % slots,
                   flash_launches=launches, logits_finite=finite,
                   ms_per_step_median=sorted(walls)[n_steps // 2],
                   ms_per_step_runs=walls,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        row["tokens_per_s"] = B / (row["ms_per_step_median"] / 1e3)
        del state, logits
        torch.cuda.empty_cache()

        # the first layers in float32 on one cache, card against CPU
        cfg2 = cfg.replace(n_layers=DECODE_F32_LAYERS, dtype="float32")
        api2 = get_model_api(cfg2)
        p32 = _tree_to(first_layers(params, DECODE_F32_LAYERS),
                       torch.float32)
        B2 = DECODE_F32_BATCH[shape]
        card = api2.init_decode_state(B2, shp["seq_len"], dev)
        for t in card["caches"].values():
            t.normal_(generator=gen)
        card["index"].fill_(DECODE_START[shape])
        cpu = _tree_to(card, "cpu")
        p_cpu = _tree_to(p32, "cpu")
        toks = torch.randint(0, cfg.vocab, (B2, n_steps), generator=gen,
                             device=dev, dtype=torch.int32)
        err = scale = 0.0
        t0 = time.perf_counter()
        for i in range(n_steps):
            got, card = api2.decode_step(p32, card, toks[:, i:i + 1])
            want, cpu = api2.decode_step(p_cpu, cpu, toks[:, i:i + 1].cpu())
            err = max(err, float((got.cpu() - want).abs().max()))
            scale = max(scale, float(want.abs().max()))
        cache_err = max(float((card["caches"][k].cpu()
                               - cpu["caches"][k]).abs().max())
                        for k in ("k", "v"))
        row["f32_check"] = dict(layers=DECODE_F32_LAYERS, batch=B2,
                                steps=n_steps, logits_max_abs_err=err,
                                logit_scale=scale,
                                cache_max_abs_err=cache_err,
                                wall_s=time.perf_counter() - t0)
        del card, cpu, p32, p_cpu
        torch.cuda.empty_cache()
        emit(dict(phase="decode_shapes", **row))
        if (launches != 0 or not finite or not err <= F32_LOGIT_TOL
                or not cache_err <= F32_LOGIT_TOL):
            raise AssertionError(f"decode_shapes {shape}: {row}")
    return 0


# ---------------------------------------------------------------------------
# mesh_serve: the serving programs over a (data, model) mesh
# ---------------------------------------------------------------------------

MESH_ARCH = "llama3.2-1b"
MESH_SERVE_SHAPE = (2, 2)            # (data, model): 4 gloo ranks, one card
MESH_SERVE_LAYERS = 2
MESH_SERVE_BATCH = 2
MESH_SERVE_SEQ = 2048
MESH_SERVE_STEPS = 8
MESH_SERVE_THREADS = 2
MESH_SEED = 17
MESH_KV_BLOCK = 1                  # cache rows drawn together (fill_kv)
# the gathered logits against one process on the card, over the largest
# magnitude: float32 as the CPU tests hold the mesh programs to the
# one-process ones, bfloat16 at tests/test_torch_transformer.py's
# LOGIT_TOL (each rank's partials float32, summed, rounded to bf16 once)
MESH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def mesh_arch(dtype: str, n_layers: int):
    """MESH_ARCH at full width, its first ``n_layers`` layers, in
    ``dtype``."""
    import dataclasses
    from repro_torch.configs import get_arch
    arch = get_arch(MESH_ARCH)
    return dataclasses.replace(arch, model=arch.model.replace(
        n_layers=n_layers, dtype=dtype))


def mesh_tokens(torch, vocab: int, batch: int, seq: int, dev, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, (batch, seq), generator=gen, device=dev,
                         dtype=torch.int32)


def fill_kv(torch, caches, seed: int, *, row0: int = 0, kv0: int = 0,
            kv_heads: int, block: int):
    """Fill ``caches`` {"k", "v"} (layers, rows, M, kv, hd), the rows
    ``row0``... and kv heads ``kv0``... of a full cache of ``kv_heads`` kv
    heads, with that cache's values: each layer's K and V drawn ``block``
    rows at a time, each block (block, M, kv_heads, hd) from a generator
    of its own (seeded by the layer, K or V, and the block's index), so
    that any rows can be filled alone (a block's draw at a time)."""
    L, rows, M, kv, hd = caches["k"].shape
    first, last = row0 // block, (row0 + rows - 1) // block
    for layer in range(L):
        for j, name in enumerate(("k", "v")):
            t = caches[name]
            for bi in range(first, last + 1):
                gen = torch.Generator(device=t.device).manual_seed(
                    seed + 7919 * (2 * layer + j) + bi)
                full = torch.empty((block, M, kv_heads, hd), dtype=t.dtype,
                                   device=t.device).normal_(generator=gen)
                lo = max(row0, bi * block)
                hi = min(row0 + rows, (bi + 1) * block)
                t[layer, lo - row0:hi - row0].copy_(
                    full[lo - bi * block:hi - bi * block, :,
                         kv0:kv0 + kv])
                del full


def rank_offsets(mesh, spec, shape) -> list:
    """Per dim of a block of ``shape`` laid out by ``spec``, the offset of
    this rank's block in the full tensor."""
    out = []
    for entry, n in zip(spec, shape):
        out.append(0 if entry is None else mesh.axes_mesh(entry).rank * n)
    return out


def mesh_serve_rank(mesh, device: str, layers_n: int, batch: int, seq: int,
                    steps: int):
    """One rank of ``mesh_serve``: for bfloat16, then float32, the prefill
    and decode programs over ``mesh`` on this rank's blocks of
    ``mesh_params``, the flash launches (and the heads each saw) and the
    all-reduced bytes counted from 0; the greedy tokens are the
    distributed argmax, each rank's rows fed back.  Rank 0 also returns
    the gathered logits (float32, on the host)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import layers
    from repro_torch.sharding.rules import gather_full
    from repro_torch.tree import tree_map

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    heads = []
    plain = layers.flash_attention

    def recording(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return plain(q, k, v, **kw)
    layers.flash_attention = recording
    out = []
    t0 = time.perf_counter()
    drawn = mesh_params(torch, mesh_arch("bfloat16", layers_n).model, dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    try:
        for dtype in ("bfloat16", "float32"):
            arch = mesh_arch(dtype, layers_n)
            cfg = arch.model
            pre = build_prefill_step(arch, "prefill_32k", mesh)
            dec = build_decode_step(arch, "decode_32k", mesh)
            tokens = mesh_tokens(torch, cfg.vocab, batch, seq, dev,
                                 MESH_SEED)
            p_loc, b_loc = pre.shard((_tree_to(drawn, cfg.torch_dtype),
                                      {"tokens": tokens}), batch)
            p_loc = tree_map(torch.clone, p_loc)   # a storage of its own
            torch.cuda.empty_cache()
            param_bytes = sum(x.numel() * x.element_size()
                              for x in tree_leaves(p_loc))
            pre.fn(p_loc, b_loc)                   # warm-up
            flash_attention.launches = 0
            layers.sum_partials.calls = layers.sum_partials.bytes = 0
            heads.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = pre.fn(p_loc, b_loc)
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            pre_launches, pre_heads = flash_attention.launches, list(heads)
            reduced = (layers.sum_partials.calls, layers.sum_partials.bytes)
            tok = pre.greedy(logits)
            (_, st_spec, tok_spec), _ = dec.specs(batch)
            toks = [gather_full(tok, tok_spec, mesh).cpu()]
            full = [pre.gather(logits, batch).float().cpu()]
            state = dec.init_state(batch, seq + steps, dev)
            caches = state["caches"]
            spec = st_spec["caches"]["k"]
            off = rank_offsets(mesh, spec, caches["k"].shape)
            fill_kv(torch, caches, MESH_SEED, row0=off[1], kv0=off[3],
                    kv_heads=cfg.n_kv_heads, block=MESH_KV_BLOCK)
            state["index"].fill_(seq)
            flash_attention.launches = 0
            walls = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, state = dec.fn(p_loc, state, tok)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
                full.append(dec.gather(lg, batch).float().cpu())
                tok = dec.greedy(lg)
                toks.append(gather_full(tok, tok_spec, mesh).cpu())
            row = dict(dtype=dtype, rank=mesh.rank, param_bytes=param_bytes,
                       draw_s=draw_s,
                       prefill_flash_launches=pre_launches,
                       flash_heads=[list(h) for h in sorted(set(pre_heads))],
                       decode_flash_launches=flash_attention.launches,
                       allreduce_calls=reduced[0],
                       allreduce_bytes=reduced[1], prefill_ms=prefill_ms,
                       step_ms=walls, cache_shape=list(caches["k"].shape),
                       local_batch=list(b_loc["tokens"].shape))
            if mesh.rank == 0:       # numpy: a tensor would go by fd
                row.update(logits=[x.numpy() for x in full],
                           tokens=torch.cat(toks, dim=1).numpy())
            out.append(row)
            del p_loc, b_loc, state, caches
            torch.cuda.empty_cache()
    finally:
        layers.flash_attention = plain
    return out


def mesh_params(torch, cfg, dev, seed: int = MESH_SEED):
    """``cfg``'s weights drawn in bfloat16 from ``seed`` (the same bits in
    every process on the card), cast to ``cfg``'s dtype."""
    from repro_torch import random as jr
    from repro_torch.models import transformer
    p = transformer.init_params(cfg.replace(dtype="bfloat16"),
                                jr.PRNGKey(seed, device=dev), dev)
    return _tree_to(p, cfg.torch_dtype)


def mesh_serve(torch, dev):
    """The (2, 2) mesh's 4 gloo ranks on the card (one spawn), then one
    process on the card on the same weights: the prefill's and each
    decode step's logits, fed the mesh's greedy tokens, within MESH_TOL
    of their largest magnitude, and the mesh's greedy tokens the one
    process's argmax (a token where they differ is a near-tie when the
    one process' logit gap between them is within the limit: counted,
    else the check fails).  Returns the flash launches, summed over the
    ranks."""
    import numpy as np
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import transformer

    L, B, S, n = (MESH_SERVE_LAYERS, MESH_SERVE_BATCH, MESH_SERVE_SEQ,
                  MESH_SERVE_STEPS)
    d, m = MESH_SERVE_SHAPE
    t0 = time.perf_counter()
    ranks = spawn_ranks(mesh_serve_rank, d * m, str(dev), L, B, S, n,
                        backend="gloo", threads=MESH_SERVE_THREADS,
                        mesh_shape=MESH_SERVE_SHAPE,
                        axis_names=("data", "model"))
    spawn_wall = time.perf_counter() - t0
    launches, ok = 0, True
    drawn = mesh_params(torch, mesh_arch("bfloat16", L).model, dev)
    for k, dtype in enumerate(("bfloat16", "float32")):
        r0 = ranks[0][k]
        cfg = mesh_arch(dtype, L).model
        params = _tree_to(drawn, cfg.torch_dtype)
        tokens = mesh_tokens(torch, cfg.vocab, B, S, dev, MESH_SEED)
        want = [transformer.prefill(cfg, params, {"tokens": tokens})]
        state = transformer.init_decode_state(cfg, B, S + n, dev)
        fill_kv(torch, state["caches"], MESH_SEED, kv_heads=cfg.n_kv_heads,
                block=MESH_KV_BLOCK)
        state["index"].fill_(S)
        fed = torch.from_numpy(r0["tokens"]).to(dev)
        for t in range(n):
            lg, state = transformer.decode_step(cfg, params, state,
                                                fed[:, t:t + 1])
            want.append(lg)
        want = [w.float().cpu() for w in want]
        del params, state
        torch.cuda.empty_cache()
        scale = max(float(w.abs().max()) for w in want)
        errs = [float((torch.from_numpy(g) - w).abs().max()) / scale
                for g, w in zip(r0["logits"], want)]
        ties, flips = 0, 0
        for t, w in enumerate(want):
            mine = torch.from_numpy(r0["tokens"][:, t]).long()
            best = w[:, 0].argmax(-1)
            for b in range(B):
                if int(mine[b]) == int(best[b]):
                    continue
                gap = float(w[b, 0, best[b]] - w[b, 0, mine[b]]) / scale
                if gap <= MESH_TOL[dtype]:
                    ties += 1
                else:
                    flips += 1
        per_rank = [r[k] for r in ranks]
        rank_launches = [r["prefill_flash_launches"] for r in per_rank]
        launches += sum(rank_launches)
        b_loc = B // d
        embed_bytes = b_loc * S * cfg.d_model * 4
        h_m, kv_m = cfg.n_heads // m, cfg.n_kv_heads // m
        row = dict(phase="mesh_serve", arch=MESH_ARCH, dtype=dtype,
                   mesh_shape=list(MESH_SERVE_SHAPE), backend="gloo",
                   layers=L, batch=B, seq_len=S, decode_steps=n,
                   prefill_shape="prefill_32k", decode_shape="decode_32k",
                   local_batch=r0["local_batch"],
                   cache_shape_per_rank=r0["cache_shape"],
                   prefill_flash_launches=rank_launches,
                   flash_heads=[r["flash_heads"] for r in per_rank],
                   decode_flash_launches=[r["decode_flash_launches"]
                                          for r in per_rank],
                   param_bytes_per_rank=[r["param_bytes"]
                                         for r in per_rank],
                   allreduce_calls_prefill=r0["allreduce_calls"],
                   allreduce_bytes_prefill=r0["allreduce_bytes"],
                   allreduce_bytes_per_layer=(r0["allreduce_bytes"]
                                              - embed_bytes) / L,
                   prefill_ms=[r["prefill_ms"] for r in per_rank],
                   step_ms_median=[sorted(r["step_ms"])[n // 2]
                                   for r in per_rank],
                   prefill_max_rel_err=errs[0],
                   decode_max_rel_err=max(errs[1:]), logit_scale=scale,
                   tol=MESH_TOL[dtype], greedy_near_ties=ties,
                   greedy_flips=flips, spawn_wall_s=spawn_wall,
                   rank_draw_s=[r["draw_s"] for r in per_rank],
                   gpu=gpu_line())
        emit(row)
        ok &= (all(x == L for x in rank_launches)
               and all(r["flash_heads"] == [[h_m, kv_m]] for r in per_rank)
               and all(r["decode_flash_launches"] == 0 for r in per_rank)
               and max(errs) <= MESH_TOL[dtype] and flips == 0
               and all(np.isfinite(e) for e in errs))
    del drawn
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("mesh_serve: a check failed (see its lines)")
    return launches


# ---------------------------------------------------------------------------
# zoo_train: llama3.2-1b's federated round at full width
# ---------------------------------------------------------------------------

ZOO_ARCH = "llama3.2-1b"
ZOO_MAMBA = "mamba2-2.7b"
ZOO_SHAPE = (2, 2, 1, 4096)         # K, E, B, S; FedExec's K = 32, B = 8
ZOO_ROUNDS = {ZOO_ARCH: 4, ZOO_MAMBA: 3}    # the first is the warm-up
# mamba2-2.7b's first layers, the deepest whose round stays under ~70 GB
# of the card's 80 (Adam's float32 moments and two clients' weights,
# gradients and float32 deltas: 50.95 GB at 32 layers, 1.42 B parameters,
# ~1.45 GB a layer; 48 layers ran out of memory; NVIDIA H100 80GB HBM3,
# 700 W); the full 64 layers at K = 2 wait for the model axis (ROADMAP.md
# queue 1 item 11)
ZOO_DEPTH = {ZOO_ARCH: None, ZOO_MAMBA: 44}
ZOO_DEPTH2_SHAPE = (2, 1, 1, 512)   # the card-vs-CPU round, float32
ZOO_CPU_THREADS = 5
# The depth-2 round, card against CPU.  llama3.2-1b: the loss and the
# delta norm, relative: measured equal in every bit (NVIDIA H100 80GB
# HBM3, 700 W).  Each leaf of the delta, a stacked block leaf per layer:
# its norm, relative (measured at most 3.2e-7), and its largest lane gap
# over its largest lane (measured at most 5.0e-4, in wq of the last layer,
# where dS = P (dP - D) cancels).  chip_grad_sensitivity.py shows what
# they fail.
ZOO_TOL = 1e-6
ZOO_LEAF_NORM_TOL = 1e-6
ZOO_LEAF_MAX_TOL = 2e-3
# mamba2-2.7b, written before its first run on the card: float32 on both
# sides, but its forward's ssd_chunk kernel and its backward's
# ssd_chunk_bwd sum in other orders than the CPU's plain versions (the
# llama layers' matmuls agreed bitwise, these do not), dcum is a
# difference of G's row and column sums that cancels, and A_log, dt_bias
# and D are reductions over every position of a layer: ten times llama's
# loss, delta norm and leaf norm limits (the leaf norm a hundred), the same
# share of a leaf's largest lane.
ZOO_MAMBA_TOL = 1e-5
ZOO_MAMBA_LEAF_NORM_TOL = 1e-4
ZOO_MAMBA_LEAF_MAX_TOL = 2e-3
ZOO_LIMITS = {ZOO_ARCH: (ZOO_TOL, ZOO_LEAF_NORM_TOL, ZOO_LEAF_MAX_TOL),
              ZOO_MAMBA: (ZOO_MAMBA_TOL, ZOO_MAMBA_LEAF_NORM_TOL,
                          ZOO_MAMBA_LEAF_MAX_TOL)}


def zoo_depth2_arch(arch_id: str = ZOO_ARCH):
    """``arch_id`` at its full widths, 2 layers, float32, E = 1."""
    import dataclasses
    from repro_torch.configs import get_arch
    arch = get_arch(arch_id)
    return dataclasses.replace(
        arch, model=arch.model.replace(n_layers=2, dtype="float32"),
        fed=dataclasses.replace(arch.fed, local_steps=ZOO_DEPTH2_SHAPE[1]))


def zoo_round_cpu(src: str, arch_id: str, path: str, threads: int,
                  results) -> None:
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
    arch = zoo_depth2_arch(arch_id)
    fed_round, opt, _ = build_train_step(arch, "train_4k")
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


def zoo_kernels(arch_id: str, L: int, E: int):
    """(the counted wrappers, the launches a round beside the simulation
    kernels', the profile's name filter, a check of the profiled kernel
    names) of the arch's training layer: per local step the forward runs
    once under the gradient and once more in each layer's checkpoint, the
    backward once."""
    if arch_id == ZOO_MAMBA:
        from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd

        def names_ok(names):
            # bf16: the forward's tensor-core route; the backward's three
            # tensor-core launches, and none of its CUDA-core kernels
            fwd = [n for n in names if "ssd_chunk_kernel" in n]
            bwd = [n for n in names if "ssd_bwd_" in n]
            return (fwd and all("_mma" in n for n in fwd)
                    and len(fwd) + len(bwd) == len(names)
                    and all(any(k in n for n in bwd) for k in SSD_BWD_PARTS)
                    and all(any(k in n for k in SSD_BWD_PARTS) for n in bwd))
        return ((ssd_chunk, ssd_chunk_bwd),
                dict(ssd_chunk=2 * L * E, ssd_chunk_bwd=L * E), "ssd_",
                names_ok)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    def names_ok(names):
        # bf16: the backward runs D, then the tensor-core dK/dV and dQ
        bwd = [n for n in names if "flash_bwd" in n]
        return (any("flash_bwd_dkdv_mma" in n for n in bwd)
                and any("flash_bwd_dq_mma" in n for n in bwd)
                and all("_mma" in n or "flash_bwd_delta" in n for n in bwd))
    return ((flash_attention, flash_attention_bwd),
            dict(flash_attention=2 * L * E, flash_attention_bwd=L * E),
            "flash", names_ok)


def zoo_flops(cfg, n_params: int, shape) -> float:
    """The round's products: 8 flops a parameter a token (the forward, its
    recompute in the checkpoints, the backward), and the attention's or
    the SSD's products on top."""
    K, E, B, S = shape
    flops = 8.0 * n_params * K * E * B * S
    if cfg.family == "ssm":
        from repro_torch.models.ssm import mamba2_dims
        H = mamba2_dims(cfg)[1]
        Q, N, P = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_head_dim
        layer = (K * B, S // Q, Q, H, P, N)
        return flops + cfg.n_layers * E * (2 * ssd_work(layer, 2)[1]
                                           + ssd_bwd_work(layer, 2)[1])
    pairs = attn_pairs(S, S, True, 0)
    return flops + cfg.n_layers * K * B * E * cfg.n_heads * cfg.head_dim \
        * pairs * (2 * 4 + 10)      # the forward twice (remat), backward


def zoo_train(torch, dev, arch_id: str = ZOO_ARCH, params=None):
    """``arch_id`` trained through ``launch.steps.build_train_step`` and
    the loop of ``launch.train.run_arch_smoke`` (``federated_rounds``) at
    full width (its first ZOO_DEPTH layers), then the depth-2 float32
    round against the CPU's.  ``params``: None for a fresh draw, or a list
    holding weights already drawn and cut to those layers, which it
    empties, so that no caller keeps them alive through the rounds.
    Returns the launches of the full-width rounds."""
    import dataclasses
    import multiprocessing
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import federated_rounds
    from repro_torch.models import transformer

    tol, leaf_norm_tol, leaf_max_tol = ZOO_LIMITS[arch_id]
    clock = [time.perf_counter()]
    seconds = {}

    def lap(name):
        clock.append(time.perf_counter())
        seconds[name] = clock[-1] - clock[-2]

    # the depth-2 parameters first, so the CPU's round runs meanwhile
    arch2 = zoo_depth2_arch(arch_id)
    key2 = jr.PRNGKey(1, device=dev)
    p2 = transformer.init_params(arch2.model, key2, dev)
    path = ROOT / "build" / "zoo_depth2_params.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_tree_to(p2, "cpu"), path)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=zoo_round_cpu, args=(
        str(ROOT / "src"), arch_id, str(path), ZOO_CPU_THREADS, results),
        daemon=True)
    proc.start()
    lap("depth2_draw_save_spawn")

    try:
        arch = get_arch(arch_id)
        if ZOO_DEPTH[arch_id] is not None:
            arch = dataclasses.replace(arch, model=arch.model.replace(
                n_layers=ZOO_DEPTH[arch_id]))
        cfg = arch.model
        fed_round, opt, spec_shapes = build_train_step(arch, "train_4k")
        K, E, B, S = ZOO_SHAPE
        L = cfg.n_layers
        kernels, want_model, profile_name, names_ok = zoo_kernels(
            arch_id, L, E)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init_s = None
        if params is None:
            params, init_s = timed_init(torch, transformer, cfg, 0, dev)
        else:
            params = params.pop()
        n_params = sum(x.numel() for x in tree_leaves(params))
        rounds = federated_rounds(fed_round, params, opt.init(params),
                                  jr.PRNGKey(0, device=dev),
                                  vocab=cfg.vocab, shape=ZOO_SHAPE,
                                  rounds=ZOO_ROUNDS[arch_id] + 1)
        del params                  # the loop holds them
        want = dict(fed_select=1, fed_select_mask=0, fed_aggregate=1,
                    **want_model)
        per_round, total = [], dict.fromkeys(want, 0)
        for _ in range(ZOO_ROUNDS[arch_id]):
            (t, sel, m, _), got, wall = counted(torch, lambda: next(rounds),
                                                kernels)
            loss, dnorm = float(m.loss), float(m.delta_norm)
            per_round.append(dict(round=t, wall_ms=1e3 * wall, loss=loss,
                                  delta_norm=dnorm,
                                  selected=sel.nonzero().flatten().tolist(),
                                  launches=got))
            total = {n: total[n] + got[n] for n in want}
            if got != want or not all(map(math.isfinite, (loss, dnorm))):
                raise AssertionError(f"zoo_train {arch_id} round {t}: "
                                     f"launches {got} (want {want}), loss "
                                     f"{loss}, delta norm {dnorm}")
        peak = torch.cuda.max_memory_allocated()
        lap("rounds")
        profiled = device_profile(torch, lambda: next(rounds),
                                  kernel_name=profile_name, cpu=False)[0]
        lap("profiled_round")
        if not names_ok(profiled["kernel_names"]):
            raise AssertionError(f"zoo_train {arch_id}: the profiled round's "
                                 f"kernels are {profiled['kernel_names']}, "
                                 f"not the bf16 routes' and the backward's")
        del rounds
        torch.cuda.empty_cache()
        tokens = K * E * B * S
        flops = zoo_flops(cfg, n_params, ZOO_SHAPE)
        steady = sum(r["wall_ms"] for r in per_round[1:]) \
            / (len(per_round) - 1)
        full = dict(arch=arch_id, layers=L, dtype=cfg.dtype,
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
            federated_rounds(fed2, p2, opt2.init(p2), key2,
                             vocab=cfg.vocab, shape=ZOO_DEPTH2_SHAPE,
                             rounds=1)), kernels)
        card = dict(mask=sel2.cpu().numpy(), loss=float(m2.loss),
                    delta_norm=float(m2.delta_norm))
        del p2
        lap("depth2_card")
        cpu = finish_cpu(proc, results, timeout=900)
        if cpu is None:
            raise AssertionError("zoo_train: the CPU's depth-2 round gave "
                                 "no result")
        lap("depth2_cpu_wait")
        gaps = delta_leaf_gaps(torch, st2.m, torch.load(str(path) + ".m"))
        lap("depth2_gaps")
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join()
        path.unlink(missing_ok=True)
        Path(str(path) + ".m").unlink(missing_ok=True)
    rel = {f: abs(card[f] - cpu[f]) / abs(cpu[f])
           for f in ("loss", "delta_norm")}
    worst = [max(g[i] for g in gaps.values()) for i in (0, 1)]
    want2 = dict(want, **zoo_kernels(arch_id, 2, ZOO_DEPTH2_SHAPE[1])[1])
    bitwise = card["mask"].tobytes() == cpu["mask"].tobytes()
    if not (bitwise and got2 == want2 and max(rel.values()) <= tol
            and worst[0] <= leaf_norm_tol and worst[1] <= leaf_max_tol):
        raise AssertionError(
            f"zoo_train {arch_id} depth 2: masks bitwise {bitwise}, launches "
            f"{got2} (want {want2}), relative errors {rel} (limit {tol}), "
            f"the delta's leaves {gaps} (limits {leaf_norm_tol} on the "
            f"norm, {leaf_max_tol} of the leaf's largest lane)")
    emit(dict(phase="zoo_train", arch=arch_id, full_width=full, depth2=dict(
        shape=list(ZOO_DEPTH2_SHAPE), dtype="float32", launches=got2,
        mask_bitwise_vs_cpu=bitwise, card_loss=card["loss"],
        cpu_loss=cpu["loss"], card_delta_norm=card["delta_norm"],
        cpu_delta_norm=cpu["delta_norm"], relative_errors=rel, tol=tol,
        delta_leaf_gaps=gaps, worst_leaf_norm_gap=worst[0],
        worst_leaf_max_gap=worst[1], leaf_norm_tol=leaf_norm_tol,
        leaf_max_tol=leaf_max_tol, cpu_wall_s=cpu["wall_s"],
        cpu_threads=ZOO_CPU_THREADS), seconds=seconds))
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
               queued_ms=cuda_ms(lambda: ssd_chunk(*ins), warmup=3, runs=9,
                                 calls=10),
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
# ssd_chunk_bwd
# ---------------------------------------------------------------------------

# mamba2-2.7b's training layer as the cohort folds it: K = 2 clients x
# B = 1 at S = 4096 (32 chunks), one A a client
TRAIN_SSD = (2, 32, 128, 80, 64, 128)
RAGGED_SSD = (2, 3, 13, 3, 10, 7)        # no dimension a multiple of 4
# Kernel and plain version both form every product and sum in float32, in
# other orders (the plain version's dcum, a difference of G's row and
# column sums, and its dA, a sum over every position, cancel most).
# (rtol, atol as a share of the reference's largest magnitude): float32
# outputs (ddt, dA, and dx, dBm, dCm of float32 inputs) 1e-4 of both;
# bf16 outputs are one float32 result rounded once on each side, so one
# bf16 step of the lane plus 1e-4 of the largest magnitude for lanes that
# cancel to near zero.
SSD_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (BF16_STEP, 1e-4)}
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dBm", "dCm")
# the bf16 route's launches: the scan kernel (states and scan of 8 heads a
# block), the B and C pass, dA
SSD_BWD_PARTS = ("ssd_bwd_kernel_mma", "ssd_bwd_bc_kernel_mma",
                 "ssd_bwd_a_kernel")


def ssd_bwd_inputs(torch, dev, shape, dtype, seed, *, strided=False,
                   a_rows=False, cotangents=True):
    """``ssd_inputs`` (A one row a batch row with ``a_rows``) and the
    cotangents dy, dstates and ddecays ~ N(0, 1) float32 (``None`` for
    the last two unless ``cotangents``)."""
    x, dt, A, Bm, Cm = ssd_inputs(torch, dev, shape, dtype, seed, strided)
    B, nc, Q, H, P, N = shape
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if a_rows:
        A = -torch.exp(0.3 * torch.randn(B, H, generator=gen, device=dev))
    dy = torch.randn(B, nc, Q, H, P, generator=gen, device=dev)
    dst = ddec = None
    if cotangents:
        dst = torch.randn(B, nc, H, N, P, generator=gen, device=dev)
        ddec = torch.randn(B, nc, H, generator=gen, device=dev)
    return (x, dt, A, Bm, Cm), (dy, dst, ddec)


def ssd_grad_through_op(torch, ins, cots):
    """(dx, ddt, dA, dBm, dCm) of <ssd_chunk(ins), cots> through the
    autograd Functions as the parallel round takes them: ``torch.func.
    vmap`` of ``grad`` over the batch, one row (and one A) a client, which
    the vmap rules fold back into one forward and one backward launch."""
    from torch.func import grad, vmap
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    def loss(x, dt, A, Bm, Cm, dy, dst, ddec):
        y, st, dec = ssd_chunk(x[None], dt[None], A, Bm[None], Cm[None])
        return (y[0] * dy).sum() + (st[0] * dst).sum() + (dec[0] * ddec).sum()

    return vmap(grad(loss, argnums=(0, 1, 2, 3, 4)))(*ins, *cots)


def ssd_bwd_errors(torch, got, want, dtype):
    """{name: [max |err|, reference max, worst lane over its limit (<= 0
    passes), the worst lane's error as a share of its limit (<= 1
    passes)]} of the five gradients, and whether all pass."""
    errs, ok = {}, True
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        gf, wf = g.float(), w.float()
        diff = (gf - wf).abs()
        scale = float(wf.abs().max())
        low = dtype if name in ("dx", "dBm", "dCm") else torch.float32
        rt, at = SSD_BWD_TOL[str(low).split(".")[-1]]
        worst = float((diff - rt * wf.abs()).max()) - at * scale
        share = float((diff / (rt * wf.abs() + at * scale)).max())
        errs[name] = [float(diff.max()), scale, worst, share]
        ok = (ok and worst <= 0.0 and g.dtype == w.dtype
              and g.shape == w.shape and bool(torch.isfinite(gf).all()))
    return errs, ok


def check_ssd_backward(torch, dev):
    """The backward kernel against ``ref.ssd_chunk_bwd`` on the same
    inputs and cotangents: f32 and bf16 at the forward phase's shapes, a
    ragged shape with no dstates or ddecays gradient, the strided x of the
    model, and the training layer with one A per row; each case run twice,
    bitwise.  At the training layer the gradient through the autograd
    Functions under vmap must equal the kernel's bit for bit, in one
    backward launch for the cohort."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd

    dtypes = (torch.float32, torch.bfloat16)
    cases = [(shape, dtype, {})
             for shape in TEST_SSD_SHAPES + [SMOKE_SSD, CONSISTENCY_SSD,
                                             MAMBA_SSD, BATCH2_SSD]
             for dtype in dtypes]
    cases += [(RAGGED_SSD, dtype, dict(cotangents=False)) for dtype in dtypes]
    cases += [(MAMBA_SSD, dtype, dict(strided=True)) for dtype in dtypes]
    cases += [(TRAIN_SSD, dtype, dict(a_rows=True)) for dtype in dtypes]
    rows, max_err = [], {}
    for i, (shape, dtype, kw) in enumerate(cases):
        t0 = time.perf_counter()
        ins, cots = ssd_bwd_inputs(torch, dev, shape, dtype, 500 + i, **kw)
        got = ssd_chunk_bwd(*ins, *cots)
        again = ssd_chunk_bwd(*ins, *cots)
        want = ref.ssd_chunk_bwd(*ins, *cots)
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        errs, ok = ssd_bwd_errors(torch, got, want, dtype)
        ok = ok and bitwise
        max_err[dname] = max([max_err.get(dname, 0.0)]
                             + [e[0] for e in errs.values()])
        row = dict(shape=list(shape), dtype=dname, **kw,
                   max_abs_err_ref_max_worst_over_share=errs,
                   worst_share_of_limit=max(e[3] for e in errs.values()),
                   bitwise_rerun=bitwise)
        if kw.get("a_rows"):
            before = ssd_chunk_bwd.launches
            chain = ssd_grad_through_op(torch, ins, cots)
            row["autograd_launches"] = ssd_chunk_bwd.launches - before
            row["autograd_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(chain, got))
            ok = ok and row["autograd_bitwise"] \
                and row["autograd_launches"] == 1
            del chain
        row.update(ok=ok, wall_s=time.perf_counter() - t0)
        rows.append(row)
        if not ok:
            raise AssertionError(
                f"ssd_chunk_bwd {shape} {dtype} {kw}: {row}; limits "
                f"(rtol, share of the reference max) {SSD_BWD_TOL}, the "
                f"autograd chain one launch, bitwise")
        del ins, cots, got, again, want
        torch.cuda.empty_cache()
    emit(dict(phase="ssd_backward", cases=len(rows),
              all_bitwise_rerun=all(r["bitwise_rerun"] for r in rows),
              max_abs_err_by_dtype=max_err, checks=rows))
    return max(max_err.values())


def ssd_bwd_work(shape, in_bytes: int):
    """(bytes, flops) the gradient needs: x, Bm, Cm read and dx, dBm, dCm
    written in the input dtype; dy, dstates, ddecays, dt read and ddt
    written in float32, A and dA one row a batch row; the products S =
    C B^T, D^T C and D B once per chunk on the lower triangle, per head
    dM and M^T dy on the lower triangle and B dstate and (w o xdt)
    dstate^T in full."""
    B, nc, Q, H, P, N = shape
    bc = B * nc
    nbytes = (2 * in_bytes * (bc * Q * H * P + 2 * bc * Q * N)
              + 4 * (bc * Q * H * P + bc * H * N * P + bc * H)
              + 4 * 2 * bc * Q * H + 4 * 2 * B * H)
    tri = Q * (Q + 1) // 2
    flops = 2.0 * bc * (3 * tri * N + H * (2 * tri * P + 2 * Q * N * P))
    return nbytes, flops


def time_ssd_backward(torch, dev):
    """The backward at the training layer: bf16 inputs (``ms``, the
    tensor-core route), float32 (``f32_ms``, the CUDA cores) and the plain
    version, beside the bound: the products over the card's peak for bf16
    operands, the tensor cores' 989 TFLOP/s, or the bytes, the larger
    (``bound_f32_cuda_cores_ms``: the products over the float32 CUDA
    cores' 67, where the float32 route runs them); and each of the bf16
    route's three launches' device ms (``parts_ms``, SSD_BWD_PARTS), from
    a profile taken again over more calls where the profiler dropped a
    launch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd

    ins, cots = ssd_bwd_inputs(torch, dev, TRAIN_SSD, torch.bfloat16, 600,
                               a_rows=True)
    ins32 = [t.float() for t in ins]
    nbytes, flops = ssd_bwd_work(TRAIN_SSD, 2)
    b, by = bound_ms(nbytes, flops, peak=BF16_FLOPS)
    row = dict(shape=list(TRAIN_SSD), dtype="bfloat16", a_rows=True,
               ms=cuda_ms(lambda: ssd_chunk_bwd(*ins, *cots), warmup=3,
                          runs=15),
               queued_ms=cuda_ms(lambda: ssd_chunk_bwd(*ins, *cots),
                                 warmup=2, runs=5, calls=10),
               f32_ms=cuda_ms(lambda: ssd_chunk_bwd(*ins32, *cots),
                              warmup=2, runs=9),
               plain_ms=cuda_ms(lambda: ref.ssd_chunk_bwd(*ins, *cots),
                                warmup=1, runs=5),
               library_ms=None, bound_ms=b, bound_by=by,
               bound_f32_cuda_cores_ms=bound_ms(nbytes, flops,
                                                peak=FP32_FLOPS)[0],
               flops=flops, bytes=nbytes)
    row["tflops_per_s"] = flops / row["ms"] / 1e9
    row["bound_share"] = b / row["ms"]
    # the launches of a call, by kernel; the profiler drops device events
    # late in the script (a one-call trace here has come back with none of
    # them), so a trace missing one is taken again over more calls
    parts = SSD_BWD_PARTS
    for steps in (1, 2, 4, 8):
        prof = device_profile(
            torch, lambda: [ssd_chunk_bwd(*ins, *cots) for _ in range(steps)],
            steps=steps, kernel_name="ssd_bwd_", cpu=False)[0]
        row["parts_ms"] = {p: sum(k["ms_per_step"] for k in prof["top_kernels"]
                                  if p in k["name"]) for p in parts
                           if any(p in k["name"] for k in prof["top_kernels"])}
        row["parts_profiled_calls"] = steps
        if len(row["parts_ms"]) == len(parts):
            break
    if len(row["parts_ms"]) != len(parts):
        raise AssertionError(f"profiled backward kernels "
                             f"{prof['kernel_names']}: want {parts}")
    emit(dict(phase="ssd_bwd_timing", kernel=row))
    del ins, ins32, cots
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# mamba path: mamba2-2.7b at full width
# ---------------------------------------------------------------------------

def mamba_path(torch, dev, ssd_ms: float):
    """mamba2-2.7b whole: prefill, serve and the float32 checks; returns
    the prefill's launches and the drawn weights (zoo_train trains their
    first layers)."""
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
    del batch
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
    return launches, params


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
    grid_launches, grid_refs = phase("scenarios", scenarios, torch, dev)
    task_launches, agg_resnet18, task_refs = phase("paper_tasks",
                                                   paper_tasks, torch, dev)
    host_launches = phase("host_async", host_async, torch, dev, main_run)
    client_launches, clients_2, one_axis = phase(
        "clients", clients, torch, dev, main_run,
        model_axis_one_axis_specs())
    refs = {"/".join(key): run for key, run in {**grid_refs,
                                                **task_refs}.items()}
    refs.update(main_path=run_fields(main_run), clients_2=clients_2,
                **one_axis)
    axis_launches, axis_rounds = phase("model_axis", model_axis, torch, dev,
                                       refs)
    del refs
    phase("init", check_init, torch, dev)
    attn_err = phase("flash_attention", check_flash_attention, torch, dev)
    t_attn = phase("flash_timing", time_flash_attention, torch, dev)
    bwd_err = phase("flash_backward", check_flash_backward, torch, dev)
    t_bwd = phase("flash_bwd_timing", time_flash_backward, torch, dev)
    serve_launches, llama = phase("serve_path", serve_path, torch, dev,
                                  t_attn["ms"])
    flash_by_path = {"serve_path": serve_launches,
                     "decode_shapes": phase("decode_shapes", decode_shapes,
                                            torch, dev, llama)}
    del llama
    torch.cuda.empty_cache()
    flash_by_path["mesh_serve"] = phase("mesh_serve", mesh_serve, torch, dev)
    for name, fn in (("dense_path", dense_path), ("moe_path", moe_path),
                     ("hybrid_path", hybrid_path), ("vlm_path", vlm_path),
                     ("audio_path", audio_path)):
        flash_by_path[name] = phase(name, fn, torch, dev)
    zoo = phase("zoo_train", zoo_train, torch, dev)
    flash_by_path["zoo_train"] = zoo["flash_attention"]
    flash_launches = sum(flash_by_path.values())
    ssd_err = phase("ssd_chunk", check_ssd_chunk, torch, dev)
    t_ssd = phase("ssd_timing", time_ssd, torch, dev)
    ssd_bwd_err = phase("ssd_backward", check_ssd_backward, torch, dev)
    t_ssd_bwd = phase("ssd_bwd_timing", time_ssd_backward, torch, dev)
    ssd_launches, mamba = phase("mamba_path", mamba_path, torch, dev,
                                t_ssd["ms"])
    from repro_torch.tree import tree_map
    mamba = [tree_map(torch.clone,
                      first_layers(mamba, ZOO_DEPTH[ZOO_MAMBA]))]
    zoo_mamba = phase("zoo_train_mamba", zoo_train, torch, dev, ZOO_MAMBA,
                      mamba)
    ssd_by_path = {"mamba_path": ssd_launches,
                   "zoo_train": zoo_mamba["ssd_chunk"]}
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
                       + client_launches["fed_select"] + zoo["fed_select"]
                       + zoo_mamba["fed_select"]),
             max_abs_err=sel_err,
             shape=[1 << 20], **{k: t_sel[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="fed_select_mask", route="cuda",
             source=src + "fed_select.cu",
             replaces="src/repro/kernels/fed_select.py:152",
             launches=(launches["fed_select_mask"]
                       + grid_launches["fed_select_mask"]
                       + host_launches["fed_select_mask"]
                       + client_launches["fed_select_mask"]
                       + axis_launches["fed_select_mask"]),
             launches_model_axis=axis_launches["fed_select_mask"],
             model_axis_launches_per_round=(
                 axis_launches["fed_select_mask"] / axis_rounds),
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
                       + axis_launches["fed_aggregate"]
                       + zoo["fed_aggregate"]
                       + zoo_mamba["fed_aggregate"]),
             launches_model_axis=axis_launches["fed_aggregate"],
             model_axis_launches_per_round=(
                 axis_launches["fed_aggregate"] / axis_rounds),
             max_abs_err=agg_err,
             shape=[10, 1 << 24], **{k: t_agg[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             at_resnet18={k: agg_resnet18[k] for k in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "max_abs_err")}),
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:77",
             launches=flash_launches, launches_by_path=flash_by_path,
             max_abs_err=attn_err,
             routes={"bfloat16": "tensor cores (mma.sync m16n8k16, P split "
                                 "into bf16 hi + lo); ms",
                     "float32": "CUDA cores; f32_ms"},
             shape=list(LLAMA_ATTN), **{k: t_attn[k] for k in (
                 "ms", "f32_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")},
             **{f"at_{a}": {k: t_attn[f"at_{a}"][k] for k in (
                 "shape", "mode", "ms", "f32_ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "library", "sdpa_mask_ms")
                 if k in t_attn[f"at_{a}"]}
                for a in ("gemma", "mixtral", "grok", "recurrentgemma",
                          "llava", "whisper_encoder", "whisper_cross")}),
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
             launches=sum(ssd_by_path.values()),
             launches_by_path=ssd_by_path, max_abs_err=ssd_err,
             routes={"bfloat16": "tensor cores (mma.sync m16n8k16, M' split "
                                 "into bf16 hi + mid + lo, the states' "
                                 "weights into hi + lo); ms",
                     "float32": "CUDA cores; f32_ms"},
             shape=list(MAMBA_SSD), **{k: t_ssd[k] for k in (
                 "ms", "f32_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
        dict(name="ssd_chunk_bwd", route="cuda",
             source=src + "ssd_chunk_bwd.cu",
             replaces="src/repro/models/ssm.py:71",
             replaces_note="no Pallas backward exists: JAX trains by "
                           "jax.grad of the plain _ssd_chunked",
             launches=zoo_mamba["ssd_chunk_bwd"], max_abs_err=ssd_bwd_err,
             routes={"bfloat16": "tensor cores (mma.sync m16n8k16; dy, "
                                 "dstate and D split into bf16 hi + lo, M "
                                 "into hi + lo with M^T dy's products "
                                 "hi.hi, hi.lo, lo.hi, each split summed "
                                 "from zero; three launches: "
                                 + ", ".join(SSD_BWD_PARTS)
                                 + ", launched by "
                                 "ssd_chunk_bwd.launches; no atomics); ms, "
                                 "parts_ms",
                     "float32": "CUDA cores in float32 (four launches: "
                                "states, scan, B and C, dA); f32_ms"},
             shape=list(TRAIN_SSD), a_rows=True,
             **{k: t_ssd_bwd[k] for k in (
                 "ms", "queued_ms", "f32_ms", "plain_ms", "bound_ms",
                 "bound_by", "bound_f32_cuda_cores_ms", "parts_ms",
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
