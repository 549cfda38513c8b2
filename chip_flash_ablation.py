#!/usr/bin/env python3
"""What each part of the bf16 flash_attention kernel costs, on one GPU.

    python3 chip_flash_ablation.py     # from the root of a checkout

Builds the committed ``src/repro_torch/kernels/csrc/flash_attention.cu``
and variants of it, each the same source with one edit, with the flags
of ``kernels/_build.py`` (one nvcc each, in parallel, into
``build/ablation/``), then calls each through its C entry point on the
same inputs, in turns (all variants, then all again in reverse order), at
llama3.2-1b's prefill shape and at (1, 4096, 32, 8, 128), causal:

* ``kernel``      the committed source;
* ``no_lo``       P rounded to bf16 once (no ``lo`` products): what the
                  split costs, and how many lanes then leave one bf16 step
                  of the plain version;
* ``no_exp``      exp replaced by an affine map: what the exponentials cost
                  (wrong results by design);
* ``no_reads``    K and V copies read nothing (zero-fill): what the K/V
                  traffic costs (wrong results by design);
* ``inline_branches`` the soft-cap and mask tests inside the per-score
                  loop, as a first version had them;
* ``expf``        the accurate ``expf`` in place of ``ex2.approx``;
* ``warps8``      128 rows a block (8 warps of 16) in place of 64.

Each variant's time is the median of CUDA-event times (``chip_smoke``'s
``cuda_ms``).  Prints the card's name and power limit, then one JSON line
per shape.  Measurement only: nothing here is on a path of the port.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (name, old text, new text): one edit of the committed source each
_EDITS = {
    "no_lo": ("""          mma_bf16(acc[2 * np], pl, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], pl, vf[2], vf[3]);
""", ""),
    "no_exp": ("""  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));""",
               """  y = x * 1.4426950408889634f + 1.0f;"""),
    "no_reads": ("""      const bool in = kp < a.Skv;
      const int64_t kr""", """      const bool in = false;
      const int64_t kr"""),
    "inline_branches": ("""#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= a.scale;
      if (a.softcap > 0.0f) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = a.softcap * tanhf(s[j][e] / a.softcap);
      }
      if (kt + kKeys > a.Skv || (a.causal && kt + kKeys - 1 > wq_lo)
          || (a.window > 0 && kt <= wq_hi - a.window)) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kt + 8 * j + 2 * t + (e & 1);
            const int pos = e < 2 ? pos_a : pos_b;
            bool keep = kp < a.Skv;
            if (a.causal) keep = keep && kp <= pos;
            if (a.window > 0) keep = keep && kp > pos - a.window;
            if (!keep) s[j][e] = kNeg;
          }
        }
      }
""", """      const bool edge = kt + kKeys > a.Skv
                        || (a.causal && kt + kKeys - 1 > wq_lo)
                        || (a.window > 0 && kt <= wq_hi - a.window);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * a.scale;
          if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
          if (edge) {
            const int kp = kt + 8 * j + 2 * t + (e & 1);
            const int pos = e < 2 ? pos_a : pos_b;
            bool keep = kp < a.Skv;
            if (a.causal) keep = keep && kp <= pos;
            if (a.window > 0) keep = keep && kp > pos - a.window;
            x = keep ? x : kNeg;
          }
          s[j][e] = x;
        }
      }
"""),
    "expf": ("""  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;""", """  return expf(x);"""),
    "warps8": ("""constexpr int kWarps = 4;""", """constexpr int kWarps = 8;"""),
}
# warps8 keeps the 128-register cap: two blocks of 256 threads an SM
_EXTRA = {"warps8": [("__launch_bounds__(kThreads, HD <= 64 ? 4 : 2)",
                      "__launch_bounds__(kThreads, HD <= 64 ? 2 : 1)")]}
SHAPES = [(1, 8192, 32, 8, 64), (1, 4096, 32, 8, 128)]


def variant_sources(src: str, edits: dict, extra: dict) -> dict:
    """The committed source and one variant per edit: {name: text}.  Each
    edit's old text must be in the source exactly once; ``extra`` holds
    further (old, new) replacements of a variant."""
    out = {"kernel": src}
    for name, (old, new) in edits.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edited text is not in the source "
                               f"exactly once")
        text = src.replace(old, new)
        for more_old, more_new in extra.get(name, ()):
            if text.count(more_old) != 1:
                raise RuntimeError(f"{name}: an extra edit's text is not in "
                                   f"the source exactly once")
            text = text.replace(more_old, more_new)
        out[name] = text
    return out


def build(sources: dict, build_dir: Path, _build,
          kernel: str = "flash_attention") -> dict:
    """Build every variant with ``kernel``'s flags (one nvcc each, in
    parallel) and bind its ``<kernel>_launch``; each ptxas report is kept
    beside its library as ``<variant>.log``."""
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (build_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            _build.nvcc_command(kernel, build_dir / f"{name}.cu",
                                build_dir / f"{name}.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entry = f"{kernel}_launch"
    argtypes, restype = _build._SIGNATURES[kernel][entry]
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (build_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(build_dir / f"{name}.so")), entry)
        fn.argtypes, fn.restype = argtypes, restype
        fns[name] = fn
    return fns


def in_turns(names) -> list:
    """Every variant, then every variant again in reverse order."""
    order = list(names)
    return order + order[::-1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref

    fns = build(variant_sources(
        (_build.CSRC / "flash_attention.cu").read_text(), _EDITS, _EXTRA),
        ROOT / "build" / "ablation", _build)
    dev = torch.device("cuda:0")
    print(cs.gpu_line(), flush=True)

    def call(fn, q, k, v):
        B, Sq, H, hd = q.shape
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None, 1,
                 B, Sq, k.shape[1], H, k.shape[2], hd, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], 1, 0, 0.0,
                 ref.attn_scale(hd), torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_attention variant launch")
        return o

    for shape in SHAPES:
        q, k, v = cs.attn_inputs(torch, dev, shape, torch.bfloat16, 100)
        want = ref.sdpa(q, k, v, causal=True).float()
        row = dict(shape=list(shape), dtype="bfloat16", mode="causal",
                   lanes=want.numel())
        for name in in_turns(fns):
            got = call(fns[name], q, k, v).float()
            over = (got - want).abs() - cs.BF16_STEP * want.abs() \
                - cs.BF16_STEP_ATOL
            rec = row.setdefault(name, dict(ms=[], lanes_over_one_step=0))
            rec["lanes_over_one_step"] = int((over > 0).sum())
            rec["ms"].append(cs.cuda_ms(lambda: call(fns[name], q, k, v),
                                        warmup=2, runs=15))
        print(json.dumps(row), flush=True)
        del q, k, v, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
