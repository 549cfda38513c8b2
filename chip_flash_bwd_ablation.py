#!/usr/bin/env python3
"""What each part of the bf16 flash_attention backward costs, on one GPU.

    python3 chip_flash_bwd_ablation.py     # from the root of a checkout

Builds the committed ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
and variants of it, each the same source with one change, with the flags
of ``kernels/_build.py`` (one nvcc each, in parallel, into
``build/ablation_bwd/``), then calls each through its C entry point on the
same inputs, in turns (all variants, then all again in reverse order), at
llama3.2-1b's training layer (1, 4096, 32, 8, 64), bf16, causal and
(off every path, where the sums are longest) without the causal mask:

* ``kernel``   the committed source;
* ``no_lo``    P and dS rounded to bf16 once (no ``lo`` products, in both
               passes): what the split costs, and how many lanes of dq, dk
               and dv then leave one bf16 step of the plain version;
* ``no_exp``   exp replaced by an affine map: what the exponentials cost
               (wrong results by design);
* ``no_reads`` the streamed tiles (Q and dO in the dK/dV pass, K and V in
               the dQ pass) read nothing (zero-fill): what that traffic
               costs (wrong results by design);
* ``in_accumulator`` each hi + lo pair of products added into the running
               sum inside the tensor cores' accumulator, in place of
               summing it from zero and adding it by the float32 unit:
               what the tensor cores' truncating float32 adds cost in
               accuracy, and what avoiding them costs in time;
* ``steps32``  score steps of 32 queries (dK/dV) or keys (dQ) in place of
               16: the registers the wider step takes, and its time.

Each variant's time is the median of CUDA-event times (``chip_smoke``'s
``cuda_ms``) of the three launches (D, dK/dV, dQ).  Beside it: the lanes
of dq, dk and dv more than one bf16 step (plus 1e-5 of the largest) from
the plain version (``chip_smoke``'s check), and the share of lanes that
differ from the correctly rounded gradient (float64 throughout, then
rounded to bf16 once); the plain version's share is ``plain_differs``.
Prints the card's name and power limit, each variant's registers and
spilled bytes by kernel (``-Xptxas -v``), then one JSON line a mode.
Measurement only: nothing here is on a path of the port.
"""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# name -> the (old text, new text) replacements of the committed source
# that make it; each old text must be in the source exactly once
_EDITS = {
    "no_lo": [("""  mma_bf16(t, lo, b0, b1);
""", "")],
    "no_exp": [("""  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));""",
                """  y = x * 1.4426950408889634f + 1.0f;""")],
    "no_reads": [("""      const bool in = pos < a.Sq;
      const int64_t pr = in ? pos : 0;""", """      const bool in = false;
      const int64_t pr = in ? pos : 0;"""),
                 ("""      const bool in = kp < a.Skv;
      const int64_t kr = in ? kp : 0;
      const uint32_t dst""", """      const bool in = false;
      const int64_t kr = in ? kp : 0;
      const uint32_t dst""")],
    "in_accumulator": [("""  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(t, hi, b0, b1);
  mma_bf16(t, lo, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];""", """  mma_bf16(c, hi, b0, b1);
  mma_bf16(c, lo, b0, b1);""")],
    "steps32": [("constexpr int kSub = 16;", "constexpr int kSub = 32;")],
}
MODES = {"causal": dict(causal=True, window=0, softcap=0.0),
         "full": dict(causal=False, window=0, softcap=0.0)}
SHAPE = (1, 4096, 32, 8, 64)


def variant_sources(src: str) -> dict:
    """{name: text}: the committed source and one variant per entry of
    ``_EDITS``."""
    out = {"kernel": src}
    for name, edits in _EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: an edited text is not in the "
                                   f"source exactly once")
            text = text.replace(old, new)
        out[name] = text
    return out


def ptxas_summary(log: str) -> dict:
    """{kernel<hd>: [registers, spilled bytes]} of the tensor-core kernels
    in an ``nvcc -Xptxas -v`` report."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        name = re.search(r"(flash_bwd_\w+_mma)ILi(\d+)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if name and regs and spill:
            out[f"{name.group(1)}<{name.group(2)}>"] = [int(regs.group(1)),
                                                      int(spill.group(1))]
    return out


def exact_bwd(torch, q, k, v, o, lse, do, causal):
    """(dq, dk, dv) in float64 throughout (``ref.sdpa_bwd``'s formulas, 512
    query rows at a time), each rounded to bf16 once."""
    f64 = torch.float64
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.to(f64).reshape(B, Sq, KV, g, hd)
    dof = do.to(f64).reshape(B, Sq, KV, g, hd)
    kf, vf = k.to(f64), v.to(f64)
    delta = (dof * o.to(f64).reshape(B, Sq, KV, g, hd)).sum(-1) \
        .permute(0, 2, 3, 1)
    lse = lse.to(f64).reshape(B, KV, g, Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    dq = torch.empty(B, Sq, KV, g, hd, dtype=f64, device=q.device)
    dk = torch.zeros(B, Skv, KV, hd, dtype=f64, device=q.device)
    dv = torch.zeros_like(dk)
    for a in range(0, Sq, 512):
        b = min(a + 512, Sq)
        s = torch.einsum("bqkgh,bskh->bkgqs", qf[:, a:b], kf) / hd ** 0.5
        keep = kpos <= torch.arange(a, b, device=q.device)[:, None]
        p = torch.exp(s - lse[..., a:b, None])
        if causal:
            p = torch.where(keep, p, torch.zeros((), dtype=f64,
                                                 device=q.device))
        dv += torch.einsum("bkgqs,bqkgh->bskh", p, dof[:, a:b])
        dp = torch.einsum("bqkgh,bskh->bkgqs", dof[:, a:b], vf)
        ds = p * (dp - delta[..., a:b, None]) / hd ** 0.5
        dq[:, a:b] = torch.einsum("bkgqs,bskh->bqkgh", ds, kf)
        dk += torch.einsum("bkgqs,bqkgh->bskh", ds, qf[:, a:b])
    bf = torch.bfloat16
    return dq.reshape(B, Sq, H, hd).to(bf), dk.to(bf), dv.to(bf)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from chip_flash_ablation import build, in_turns
    from repro_torch.kernels import _build, ref

    fns = build(variant_sources(
        (_build.CSRC / "flash_attention_bwd.cu").read_text()),
        ROOT / "build" / "ablation_bwd", _build, kernel="flash_attention_bwd")
    dev = torch.device("cuda:0")
    print(cs.gpu_line(), flush=True)
    for name in fns:
        print(json.dumps({"variant": name, "ptxas": ptxas_summary(
            (ROOT / "build" / "ablation_bwd" / f"{name}.log").read_text())}),
            flush=True)

    for mode_name, mode in MODES.items():
        q, k, v, o, lse, do = cs.bwd_inputs(torch, dev, SHAPE,
                                            torch.bfloat16, mode, 200)
        o = o.contiguous()
        B, Sq, H, hd = q.shape
        delta = torch.empty(B, H, Sq, device=dev)
        grads = (torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v))

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     *(g.data_ptr() for g in grads), 1, B, Sq, k.shape[1], H,
                     k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
                     *v.stride()[:3], int(mode["causal"]), 0, 0.0,
                     ref.attn_scale(hd),
                     torch.cuda.current_stream().cuda_stream)
            _build.check(err, "flash_attention_bwd variant launch")

        want = ref.sdpa_bwd(q, k, v, o, lse, do, **mode)
        exact = exact_bwd(torch, q, k, v, o, lse, do, mode["causal"])
        row = dict(shape=list(SHAPE), dtype="bfloat16", mode=mode_name,
                   lanes=[w.numel() for w in want],
                   plain_differs=[float((w != x).double().mean())
                                  for w, x in zip(want, exact)])
        for name in in_turns(fns):
            call(fns[name])
            over = []
            for g, w in zip(grads, want):
                wf = w.float()
                d = (g.float() - wf).abs() - cs.BF16_STEP * wf.abs() \
                    - cs.BWD_BF16_ATOL * float(wf.abs().max())
                over.append(int((d > 0).sum()))
            rec = row.setdefault(name, dict(ms=[]))
            rec["lanes_over_one_step_dq_dk_dv"] = over
            rec["differs"] = [float((g != x).double().mean())
                              for g, x in zip(grads, exact)]
            rec["ms"].append(cs.cuda_ms(lambda: call(fns[name]), warmup=2,
                                        runs=15))
        print(json.dumps(row), flush=True)
        del q, k, v, o, lse, do, grads, want, exact
    return 0


if __name__ == "__main__":
    sys.exit(main())
