#!/usr/bin/env python3
"""What moves the CPU side of ``chip_smoke.py``'s ``moe_path`` check.

    python3 chip_moe_cpu_pin.py       # from the root of a checkout, one card

``moe_path`` holds mixtral-8x22b's first layer in float32 on the card
against the same weights on the CPU (``chip_smoke.moe_cpu``, a spawned
worker of ``MOE_CPU_THREADS`` threads): logits within 1e-4.  This script
draws that layer on the card as ``moe_path`` does, computes the card's
side once, saves the layer's bf16 copy, and then runs the CPU side in a
fresh process for each variant of what can steer its float32 arithmetic:

* its thread count;
* the vector ISA ATen's kernels dispatch to (``ATEN_CPU_CAPABILITY``);
* MKL's code path for the GEMMs (``MKL_CBWR``, ``MKL_ENABLE_INSTRUCTIONS``).

Each variant prints one JSON line: the ISA ATen chose, the threads, the
CPU's model name, its wall, its logits' largest gap from the base
variant's (threads as ``moe_path``, nothing pinned), from the pinned
variant's and from the card's, and the router's smallest gap between its
second and third probabilities.  The last line is the card's name and
power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = "mixtral-8x22b"
OUT = ROOT / "build" / "moe_pin"

VARIANTS = {
    "base": ({}, None),
    "threads_3": ({}, 3),
    "threads_8": ({}, 8),
    "aten_avx2": ({"ATEN_CPU_CAPABILITY": "avx2"}, None),
    "aten_default": ({"ATEN_CPU_CAPABILITY": "default"}, None),
    "mkl_cbwr_compatible": ({"MKL_CBWR": "COMPATIBLE"}, None),
    "mkl_cbwr_avx2": ({"MKL_CBWR": "AVX2"}, None),
    "mkl_cbwr_avx512": ({"MKL_CBWR": "AVX512"}, None),
    "mkl_instructions_avx2": ({"MKL_ENABLE_INSTRUCTIONS": "AVX2"}, None),
    "pinned": ({"ATEN_CPU_CAPABILITY": "avx2", "MKL_CBWR": "AVX2"}, None),
    "pinned_threads_3": ({"ATEN_CPU_CAPABILITY": "avx2",
                          "MKL_CBWR": "AVX2"}, 3),
    "pinned_compatible": ({"ATEN_CPU_CAPABILITY": "avx2",
                           "MKL_CBWR": "COMPATIBLE"}, None),
}


def worker(name: str, env: dict, threads: int) -> None:
    """One variant: the CPU side of the check on the saved layer, written
    to ``OUT/<name>.npz`` with what the process ran with."""
    os.environ.update(env)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    params = cs._tree_to(torch.load(OUT / "layer.pt", mmap=True),
                         torch.float32)
    out = cs.moe_cpu_side(torch, NAME, params)
    gaps = [float((p[..., 1] - p[..., 2]).min()) for _, p in out["routes"]]
    np.savez(OUT / f"{name}.npz", logits=out["logits"].numpy(),
             y=out["y"].numpy())
    print(json.dumps(dict(cs.cpu_runtime(torch), wall_s=time.perf_counter()
                          - t0, smallest_2nd_3rd_prob_gap=gaps)))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_moe_cpu_pin: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.launch.serve import serve_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    OUT.mkdir(parents=True, exist_ok=True)
    params = serve_params(NAME, 0, smoke=False, device=dev,
                          n_layers=cs.MOE_DEPTH[NAME])
    first = cs.first_layers(params, cs.MOE_F32_LAYERS[NAME])
    torch.save(cs._tree_to(first, "cpu"), OUT / "layer.pt")
    p32 = cs._tree_to(first, torch.float32)
    del params, first
    card = cs.moe_cpu_side(torch, NAME, p32)["logits"].numpy()
    del p32
    torch.cuda.empty_cache()
    ok = True
    logits = {}
    try:
        for name, (env, threads) in VARIANTS.items():
            threads = threads or cs.MOE_CPU_THREADS
            proc = subprocess.run(
                [sys.executable, __file__, "--worker", name,
                 json.dumps(env), str(threads)],
                capture_output=True, text=True, timeout=600)
            if proc.returncode:
                ok = False
                print(json.dumps(dict(variant=name, env=env,
                                      error=proc.stderr[-2000:])),
                      flush=True)
                continue
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            got = np.load(OUT / f"{name}.npz")["logits"]
            logits[name] = got

            def gap(other):
                return (None if other is None
                        else float(np.abs(got - other).max()))
            print(json.dumps(dict(
                variant=name, env=env, **row,
                max_abs_vs_base=gap(logits.get("base")),
                max_abs_vs_pinned=gap(logits.get("pinned")),
                max_abs_vs_card=gap(card),
                logit_scale=float(np.abs(got).max()))), flush=True)
    finally:
        for f in OUT.glob("*"):
            f.unlink()
    print(cs.gpu_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], json.loads(sys.argv[3]), int(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
