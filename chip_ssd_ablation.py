#!/usr/bin/env python3
"""What each part of the bf16 ssd_chunk kernel costs, on one GPU.

    python3 chip_ssd_ablation.py       # from the root of a checkout

Builds the committed ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` and
variants of it, each the same source with one edit (``chip_flash_ablation``'s
``variant_sources``, ``build`` and ``in_turns``: one nvcc each, in parallel,
into ``build/ablation_ssd/``), then calls each through its C entry point on
the same bf16 inputs, in turns (all variants, then all again in reverse
order), at mamba2-2.7b's prefill layer (1, 64 chunks, 128, 80 heads, 64),
N = 128, and at the same layer for S = 32,768 (256 chunks):

* ``kernel``      the committed source (tensor cores);
* ``parent``      bf16 inputs through the CUDA-core kernel, as before the
                  tensor-core route (its decay to the chunk's end formed per
                  element again): parent and change in one call;
* ``m_two_way``   M' split into bf16 hi + mid only (no ``lo`` products):
                  what the third term costs, and how many lanes of y then
                  leave the 1e-4 limit;
* ``no_exp``      the exponentials of M' replaced by an affine map: what
                  they cost (wrong results by design);
* ``no_reads``    x copies that read nothing (zero-fill): what the x traffic
                  costs (wrong results by design);
* ``no_stores``   y and states not written (each store behind a test on the
                  data that never holds, so the products stay): what the
                  writes cost (wrong results by design);
* ``states_only``, ``y_only``  one of the two products per head left out:
                  with ``kernel``, what each product and the per-block work
                  around them (staging, S = C B^T, cum) cost (wrong results
                  by design);
* ``heads4``      4 heads a block in place of 8 (S formed twice as often,
                  twice the blocks);
* ``staged_stores`` y and states written through a warp's 16 x 8 float
                  buffer in shared memory as 16-byte stores, with 4 heads a
                  block (the 4 KB of buffers fit two blocks an SM only
                  then): compare it with ``heads4``.

Each variant's time is the median of CUDA-event times (``chip_smoke``'s
``cuda_ms``); lanes over the limit are counted against ``ref.ssd_chunk_ref``
on the card at ``chip_smoke.SSD_TOL``.  Prints the card's name and power
limit, each variant's ptxas registers and spills, then one JSON line per
shape.  Measurement only: nothing here is on a path of the port.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_HEADS4 = ("constexpr int kHeads = 8;                     // heads per block, "
           "sharing S\n",
           "constexpr int kHeads = 4;                     // heads per block, "
           "sharing S\n")
_STAGED_STORE = '''// Through a warp's 16 x 8 float buffer in shared memory: each 8-column
// tile goes in from the accumulators and out as one 16-byte store a lane.
__device__ __forceinline__ void store_staged(float* buf, float* out,
                                             int64_t ld, int r, int n_rows,
                                             int col, int n_tiles, int P,
                                             const float (&acc)[kNT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = lane / 2, c4 = 4 * (lane % 2);
#pragma unroll
  for (int q = 0; q < kNT; ++q) {
    if (q >= n_tiles) break;
    *reinterpret_cast<float2*>(buf + g * 8 + 2 * t) =
        make_float2(acc[q][0], acc[q][1]);
    *reinterpret_cast<float2*>(buf + (g + 8) * 8 + 2 * t) =
        make_float2(acc[q][2], acc[q][3]);
    __syncwarp();
    const float4 v = *reinterpret_cast<const float4*>(buf + row * 8 + c4);
    const int cq = col + 8 * q + c4;
    if (r + row < n_rows && cq < P)
      *reinterpret_cast<float4*>(out + (r + row) * ld + cq) = v;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 2)
'''

# (name, old text, new text): one edit of the committed source each
_EDITS = {
    "parent": ("  if (dtype == 1) return tc::launch(a, B, s);",
               "  if (dtype == 1) return simt::launch<__nv_bfloat16>(a, B, s);"),
    "m_two_way": ("""            mma_bf16(acc[2 * np], ml, xf[0], xf[1]);
""", ""),
    "no_exp": ("m[e] = s[e] * expf(((e & 2) ? ci1 : ci0) - cj[k]) * dj[k];",
               "m[e] = s[e] * (((e & 2) ? ci1 : ci0) - cj[k] + 1.0f) * dj[k];"),
    "no_reads": ("r < Q, P - col0 - 8 * ch, vec_x, x);",
                 "false, P - col0 - 8 * ch, vec_x, x);"),
    "no_stores": ("""        *reinterpret_cast<float2*>(p) =
            make_float2(acc[q][2 * half], acc[q][2 * half + 1]);""",
                  """        if (acc[q][0] == 12345.0f) *reinterpret_cast<float2*>(p) =
            make_float2(acc[q][2 * half], acc[q][2 * half + 1]);"""),
    "states_only": ("for (int s2 = 0; s2 < 2; ++s2) {",
                    "for (int s2 = 0; s2 < 0; ++s2) {"),
    "y_only": ("sn < 2 * (warp - kWarps / 2) + 2 && sn < nN; ++sn) {",
               "sn < 2 * (warp - kWarps / 2) + 2 && sn < 0; ++sn) {"),
    "heads4": _HEADS4,
    "staged_stores": _HEADS4,
}
_EXTRA = {
    # the parent's decay to the chunk's end, one expf an element
    "parent": [("    for (int j = tid; j < Qp; j += kThreads) "
                "edec[j] = expf(cu[Q - 1] - cu[j]);\n", ""),
               ("      Xs[idx] *= edec[idx / Pp];",
                "      Xs[idx] *= expf(cu[Q - 1] - cu[idx / Pp]);")],
    "m_two_way": [("""            mma_bf16(acc[2 * np + 1], ml, xf[2], xf[3]);
""", "")],
    "no_exp": [("m[e] = keep ? s[e] * expf(arg) * dj[k] : 0.0f;",
                "m[e] = keep ? s[e] * (arg + 1.0f) * dj[k] : 0.0f;")],
    "staged_stores": [
        ("                           + 3 * kVecFloats * 4;",
         "                           + 3 * kVecFloats * 4 + kWarps * 16 * 8 * 4;"),
        ("__global__ void __launch_bounds__(kThreads, 2)\n", _STAGED_STORE),
        ("  float* wend = dts + kVecFloats;",
         "  float* stage = dts + 2 * kVecFloats + 128 * (threadIdx.x / 32);\n"
         "  float* wend = dts + kVecFloats;"),
        ("store_acc(out, P, 16 * sn + g, N, col0 + 2 * t, n8, P, acc);",
         "store_staged(stage, out, P, 16 * sn, N, col0, n8, P, acc);"),
        ("""store_acc(out, static_cast<int64_t>(a.H) * P, 16 * r + g, Q,
                     col0 + 2 * t, n8, P, acc);""",
         """store_staged(stage, out, static_cast<int64_t>(a.H) * P, 16 * r,
                        Q, col0, n8, P, acc);""")],
}
# (B, nc, Q, H, P, N): the prefill layer at S = 8192 and at S = 32,768
SHAPES = [(1, 64, 128, 80, 64, 128), (1, 256, 128, 80, 64, 128)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ssd_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_flash_ablation as fa
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref

    build_dir = ROOT / "build" / "ablation_ssd"
    fns = fa.build(fa.variant_sources(
        (_build.CSRC / "ssd_chunk.cu").read_text(), _EDITS, _EXTRA),
        build_dir, _build, kernel="ssd_chunk")
    dev = torch.device("cuda:0")
    print(cs.gpu_line(), flush=True)
    print(json.dumps({"ptxas": {
        name: [ln.strip() for ln in (build_dir / f"{name}.log").read_text()
               .splitlines() if "registers" in ln or "spill" in ln]
        for name in fns}}), flush=True)

    def call(fn, x, dt, A, Bm, Cm):
        B, nc, Q, H, P = x.shape
        N = Bm.shape[-1]
        f32 = dict(dtype=torch.float32, device=x.device)
        y = torch.empty(B, nc, Q, H, P, **f32)
        st = torch.empty(B, nc, H, N, P, **f32)
        dec = torch.empty(B, nc, H, **f32)
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), st.data_ptr(), dec.data_ptr(),
                 1, B, nc, Q, H, P, N, *x.stride()[:4], *dt.stride()[:3],
                 *Bm.stride()[:3], *Cm.stride()[:3], 0,
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, "ssd_chunk variant launch")
        return y, st, dec

    for shape in SHAPES:
        ins = cs.ssd_inputs(torch, dev, shape, torch.bfloat16, 400)
        want = ref.ssd_chunk_ref(*ins)
        row = dict(shape=list(shape), dtype="bfloat16",
                   lanes=dict(y=want[0].numel(), states=want[1].numel()))
        for name in fa.in_turns(fns):
            got = call(fns[name], *ins)
            rec = row.setdefault(name, dict(ms=[]))
            for key, g, w, (rt, at) in zip(("y", "states"), got, want,
                                           cs.SSD_TOL):
                rec[f"{key}_lanes_over"] = int(
                    ((g - w).abs() > at + rt * w.abs()).sum())
            del got
            rec["ms"].append(cs.cuda_ms(lambda: call(fns[name], *ins),
                                        warmup=3, runs=20))
        print(json.dumps(row), flush=True)
        del ins, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
