#!/usr/bin/env python3
"""What each part of the bf16 ssd_chunk backward costs, on one GPU.

    python3 chip_ssd_bwd_ablation.py      # from the root of a checkout

Builds the committed ``src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu`` and
variants of it, each the same source with one change (``chip_flash_ablation``'s
``build`` and ``in_turns``: one nvcc each, in parallel, into
``build/ablation_ssd_bwd/``), then calls each through its C entry point on
the same bf16 inputs and cotangents, in turns (all variants, then all again
in reverse order), at mamba2-2.7b's training layer as the cohort folds it
(2, 32 chunks, 128, 80 heads, 64), N = 128, one A a batch row:

* ``kernel``      the committed source (tensor cores);
* ``parent``      bf16 inputs through the CUDA-core kernels (four launches,
                  float32 products), the design the tensor-core route
                  replaced, which the committed source instantiates for
                  float32 only: parent and change in one call;
* ``in_accumulator`` each split pair (and M^T dy's three products) added
                  into the running sum inside the tensor cores'
                  accumulator, in place of summing it from zero and adding
                  it by the float32 unit;
* ``dy_single``, ``m_single``, ``dstate_single``, ``d_single``  one bf16
                  term of dy (in dM and M^T dy), of M (in M^T dy), of
                  dstate (in U and the states' term of dB) or of D (in dC
                  and dB) in place of hi + lo: what each split costs, and
                  how many lanes then leave ``chip_smoke.SSD_BWD_TOL``;
* ``no_hi_lo``    M^T dy without its hi.lo product (M hi times dy lo);
* ``m_three``, ``lo_lo``  the products the kernel drops, kept: M split
                  hi + mid + lo (mid.hi and lo.hi formed, as the forward's
                  M'), or M^T dy's lo.lo formed: what keeping each costs;
* ``no_exp``      exp(cum_i - cum_j) of the scan replaced by an affine map
                  (wrong results by design);
* ``no_reads``    the copies of x, dy and dstate read nothing (zero-fill):
                  what that traffic costs (wrong results by design);
* ``expf``        the scan's exponentials by the accurate expf in place of
                  the special function unit's ex2.approx;
* ``no_states``, ``no_scan``, ``no_diag``  the states' products (U, the
                  states' term of dB), the scan's tiles, or the sums of G
                  inside the diagonal tiles left out: where the time goes
                  (wrong results by design).

Each variant's time is the median of CUDA-event times (``chip_smoke``'s
``cuda_ms``) of the three launches (the scan kernel, B and C, dA); lanes
over the limit, and each output's worst lane as a share of its limit, are
taken against ``ref.ssd_chunk_bwd`` on the card.
Prints the card's name and power limit, each variant's ptxas registers and
spills, then one JSON line.  Measurement only: nothing here is on a path of
the port.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_MMA3_LO = "  mma_bf16(s, ah, bl0, bl1);\n  mma_bf16(s, al, bh0, bh1);\n"
_M_SPLIT = """        uint32_t mh[4], ml[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) split(m[2 * k], m[2 * k + 1], &mh[k], &ml[k]);
"""
# M as bf16 hi + mid + lo (ml the mid term, m3 the lo), as the forward
# splits its M'
_M_SPLIT3 = """        uint32_t mh[4], ml[4], m3[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(m[2 * k], m[2 * k + 1]);
          mh[k] = as_u32(h);
          split(m[2 * k] - __low2float(h), m[2 * k + 1] - __high2float(h),
                &ml[k], &m3[k]);
        }
"""
# name -> the (old text, new text) replacements of the committed source
# that make it; each old text must be in the source exactly once
_EDITS = {
    "parent": [("  if (dtype == 1) return launch_mma(a, s);",
                "  if (dtype == 1) return launch<__nv_bfloat16>(a, s);"),
               ("  if (dtype == 0) {\n", "  if (dtype == 0 || dtype == 1) {\n")],
    "in_accumulator": [
        ("""  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(s, a, bh0, bh1);
  mma_bf16(s, a, bl0, bl1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += s[e];""",
         """  mma_bf16(c, a, bh0, bh1);
  mma_bf16(c, a, bl0, bl1);"""),
        ("""  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(s, ah, b0, b1);
  mma_bf16(s, al, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += s[e];""",
         """  mma_bf16(c, ah, b0, b1);
  mma_bf16(c, al, b0, b1);"""),
        ("""  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(s, ah, bh0, bh1);
""" + _MMA3_LO + """#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += s[e];""",
         """  mma_bf16(c, ah, bh0, bh1);
  mma_bf16(c, ah, bl0, bl1);
  mma_bf16(c, al, bh0, bh1);""")],
    "dy_single": [
        (_MMA3_LO, "  mma_bf16(s, al, bh0, bh1);\n"),
        ("          mma_bf16(d2l[0], xf, yl[0], yl[1]);\n", ""),
        ("          mma_bf16(d2l[1], xf, yl[2], yl[3]);\n", "")],
    "m_single": [(_MMA3_LO, "  mma_bf16(s, ah, bl0, bl1);\n")],
    "no_hi_lo": [(_MMA3_LO, "  mma_bf16(s, al, bh0, bh1);\n")],
    "lo_lo": [(_MMA3_LO, _MMA3_LO + "  mma_bf16(s, al, bl0, bl1);\n")],
    "m_three": [
        ("const uint32_t (&al)[4], uint32_t bh0,",
         "const uint32_t (&al)[4], const uint32_t (&am)[4], uint32_t bh0,"),
        (_MMA3_LO, _MMA3_LO + "  mma_bf16(s, am, bh0, bh1);\n"),
        (_M_SPLIT, _M_SPLIT3),
        ("mma3(acc[2 * np], mh, ml, yh", "mma3(acc[2 * np], mh, ml, m3, yh"),
        ("mma3(acc[2 * np + 1], mh, ml, yh",
         "mma3(acc[2 * np + 1], mh, ml, m3, yh")],
    "dstate_single": [
        ("  mma_bf16(s, a, bl0, bl1);\n", ""),
        ("          mma_bf16(l0, xa[kp], zl[0], zl[1]);\n", ""),
        ("          mma_bf16(l1, xa[kp], zl[2], zl[3]);\n", "")],
    "d_single": [("  mma_bf16(s, al, b0, b1);\n", "")],
    "no_exp": [("const float L = keep ? exp_sfu(arg) : 0.0f;",
                "const float L = keep ? arg + 1.0f : 0.0f;")],
    "expf": [("const float L = keep ? exp_sfu(arg) : 0.0f;",
              "const float L = keep ? expf(arg) : 0.0f;")],
    "no_reads": [
        ("      const bool in = r < n_rows && q < n_cols;\n"
         "      cp_async16(", "      const bool in = false;\n"
                             "      cp_async16("),
        ("              r < Q, P - 8 * ch, vec_x, x);",
         "              false, P - 8 * ch, vec_x, x);")],
    "no_states": [("    if (live && states) {\n      // U = B dstate",
                   "    if (live && states && Q < 0) {\n      // U = B dstate")],
    "no_scan": [("      for (int it = st; it < nQ; ++it) {",
                 "      for (int it = st; it < st; ++it) {")],
    "no_diag": [("                        + reduce_scatter16(pr);",
                 "                        + 0.0f;")],
}
# (B, nc, Q, H, P, N): the training layer as the cohort folds it
SHAPE = (2, 32, 128, 80, 64, 128)


def variant_sources(src: str) -> dict:
    """{name: text}: the committed source and one variant per entry of
    ``_EDITS``."""
    out = {"kernel": src}
    for name, edits in _EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: an edited text is not in the "
                                   f"source exactly once: {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ssd_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from chip_flash_ablation import build, in_turns
    from repro_torch.kernels import _build, ref

    build_dir = ROOT / "build" / "ablation_ssd_bwd"
    fns = build(variant_sources(
        (_build.CSRC / "ssd_chunk_bwd.cu").read_text()), build_dir, _build,
        kernel="ssd_chunk_bwd")
    dev = torch.device("cuda:0")
    print(cs.gpu_line(), flush=True)
    print(json.dumps({"ptxas": {
        name: [ln.strip() for ln in (build_dir / f"{name}.log").read_text()
               .splitlines() if "registers" in ln or "spill" in ln]
        for name in fns}}), flush=True)

    ins, cots = cs.ssd_bwd_inputs(torch, dev, SHAPE, torch.bfloat16, 700,
                                  a_rows=True)
    x, dt, A, Bm, Cm = ins
    dy, dst, ddec = cots
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    wsf = _build._SIGNATURES["ssd_chunk_bwd"]["ssd_chunk_bwd_workspace_floats"]
    sizes = {}
    for name in fns:
        fn = getattr(ctypes.CDLL(str(build_dir / f"{name}.so")),
                     "ssd_chunk_bwd_workspace_floats")
        fn.argtypes, fn.restype = wsf
        sizes[name] = fn(B, nc, Q, H, P, N, 1, 1)
    ws = torch.empty(max(sizes.values()), dtype=torch.float32, device=dev)
    outs = (torch.empty_like(x), torch.empty_like(dt),
            torch.empty_like(A), torch.empty_like(Bm), torch.empty_like(Cm))

    def call(fn):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), dy.data_ptr(), dst.data_ptr(),
                 ddec.data_ptr(), *(o.data_ptr() for o in outs),
                 ws.data_ptr(), 1, B, nc, Q, H, P, N, *x.stride()[:4],
                 *dt.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3],
                 A.stride(0), 1, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "ssd_chunk_bwd variant launch")

    want = ref.ssd_chunk_bwd(*ins, *cots)
    row = dict(shape=list(SHAPE), dtype="bfloat16", a_rows=True,
               lanes={n: w.numel() for n, w in zip(cs.SSD_BWD_NAMES, want)})
    for name in in_turns(fns):
        call(fns[name])
        torch.cuda.synchronize()
        rec = row.setdefault(name, dict(ms=[]))
        over, share = {}, {}
        for n, g, w in zip(cs.SSD_BWD_NAMES, outs, want):
            rt, at = cs.SSD_BWD_TOL["bfloat16" if g.dtype == torch.bfloat16
                                    else "float32"]
            gf, wf = g.float(), w.float()
            lim = rt * wf.abs() + at * float(wf.abs().max())
            d = (gf - wf).abs() - lim
            over[n] = int((~(d <= 0)).sum())
            share[n] = float(((gf - wf).abs() / lim).max())
        rec["lanes_over"], rec["worst_share"] = over, share
        rec["ms"].append(cs.cuda_ms(lambda: call(fns[name]), warmup=3,
                                    runs=20))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
