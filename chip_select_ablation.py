#!/usr/bin/env python3
"""What the fed_select redesign buys, and where its crossover lies, on one
GPU.

    python3 chip_select_ablation.py    # from the root of a checkout

Builds the committed ``src/repro_torch/kernels/csrc/fed_select.cu`` and the
parent design it replaced (``csrc/ablation/fed_select_multilaunch.cu``: a
memset and 12 to 14 dependent launches a call), one nvcc each, in
parallel, with fed_select's flags, into ``build/ablation_select/``.  Then,
in turns (every variant, then every variant again in reverse order), it
calls each through its C entry point on the same inputs (preallocated
outputs and workspace, the budget k in device memory) and takes the median
of CUDA-event times (``chip_smoke.cuda_ms``):

* ``parent``  the multi-launch chain;
* ``small``   the committed kernel forced onto its one-block path (N up to
              16,384);
* ``large``   the committed kernel forced onto its cooperative path;
* ``large_aggregated`` the cooperative path with each warp's keys of one
              bin added by one shared atomic (``__match_any_sync``) in
              place of one atomic a key: what aggregation would buy.

Each is timed two ways: the CUDA-event median around the C call (which
includes the call's host time, as the GPU waits for it) and the device
time of its kernels (all of them, for the parent), from a torch.profiler
trace of 20 calls.

At N = 100 (the main path's), 1,024 to 16,384 (around the crossover, where
both paths run) and 2^20, and with heavy ties at 8,192 and 2^20, in the
unbiased mode (mask, new_r and w) and the mask-only mode.  Each output is counted against the plain version
(``ref.fed_select_ref`` / ``ref.topk_threshold_mask``) on the card.

Beside them, for the committed kernel through its Python wrapper
(``fed_select``, unbiased, the path chosen by N): the CUDA-event time
(what ``chip_smoke.py`` reports), the host time a call takes to enqueue
(200 calls back to back, then one synchronise), and the device time of
its one kernel from a torch.profiler trace of 20 calls.  The wrapper's
time is the larger of the first two plus what the GPU waits for.

Prints the card's name and power limit, each library's ptxas report, then
one JSON line per N.  Measurement only: nothing here is on a path of the
port.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (N, heavy ties): the ties (8 score levels) put most keys of a pass in a
# few bins, where the warp-aggregated atomics should pay
CASES = [(n, False) for n in (100, 1024, 2048, 4096, 8192, 16_384, 1 << 20)]
CASES += [(8192, True), (1 << 20, True)]
MODES = {"unbiased": 1, "mask": 0}
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the parent's C entry point: no k by value, no path
_PARENT_ARGS = [_VP] * 9 + [_I, _F, _F, _I, _VP, _VP, _VP]


_PER_KEY = """      for (int j = 0; j < kItems; ++j)
        if (i0 + j < a.n && (k[j] & hmask) == prefix)
          atomicAdd(&hist[(k[j] >> shift) & 0xFFu], 1u);
"""
_AGGREGATED = """      for (int j = 0; j < kItems; ++j) {
        const bool act = i0 + j < a.n && (k[j] & hmask) == prefix;
        const uint32_t bin = (k[j] >> shift) & 0xFFu;
        const unsigned active = __ballot_sync(kFull, act);
        if (act) {
          const unsigned peers = __match_any_sync(active, bin);
          if ((threadIdx.x & 31) == __ffs(peers) - 1)
            atomicAdd(&hist[bin], static_cast<uint32_t>(__popc(peers)));
        }
      }
"""


def build(_build, build_dir: Path) -> dict:
    """{name: loaded library}: the committed source, its one-edit variant
    and the parent source."""
    build_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fed_select.cu").read_text()
    if src.count(_PER_KEY) != 1:
        raise RuntimeError("aggregated: the edited text is not in the "
                           "source exactly once")
    (build_dir / "aggregated.cu").write_text(src.replace(_PER_KEY,
                                                         _AGGREGATED))
    sources = {"kernel": _build.CSRC / "fed_select.cu",
               "aggregated": build_dir / "aggregated.cu",
               "parent": _build.CSRC / "ablation"
               / "fed_select_multilaunch.cu"}
    procs = {name: subprocess.Popen(
        _build.nvcc_command("fed_select", path, build_dir / f"{name}.so"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (build_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(build_dir / f"{name}.so"))
    for lib in (libs["kernel"], libs["aggregated"]):
        for fn, (argtypes, restype) in _build._SIGNATURES[
                "fed_select"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    parent = libs["parent"]
    parent.fed_select_launch.argtypes = _PARENT_ARGS
    parent.fed_select_launch.restype = _I
    for fn in ("fed_select_workspace_words", "fed_select_workspace_floats"):
        getattr(parent, fn).argtypes, getattr(parent, fn).restype = [_I], _I
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_select_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_flash_ablation as fa
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref

    build_dir = ROOT / "build" / "ablation_select"
    libs = build(_build, build_dir)
    new = libs["kernel"]
    dev = torch.device("cuda:0")
    print(cs.gpu_line(), flush=True)
    print(json.dumps({"ptxas": {
        name: [ln.strip() for ln in (build_dir / f"{name}.log").read_text()
               .splitlines() if "registers" in ln or "spill" in ln]
        for name in libs}}), flush=True)
    small_cap = new.fed_select_small_cap()
    ws_words = new.fed_select_workspace_words()
    ws_floats = new.fed_select_workspace_floats()
    stream = torch.cuda.current_stream().cuda_stream
    beta = 1e-3

    for n, ties in CASES:
        scores, avail, r, p, _ = (torch.from_numpy(x).to(dev)
                                  for x in cs.select_case(n, 31, q=0.2,
                                                          ties=ties))
        k_val = max(n // 10, 1)
        k = torch.full((), k_val, dtype=torch.int32, device=dev)
        mask = torch.empty(n, dtype=torch.bool, device=dev)
        new_r = torch.empty(n, dtype=torch.float32, device=dev)
        w = torch.empty(n, dtype=torch.float32, device=dev)
        parent = libs["parent"]
        ws = torch.empty(max(ws_words, parent.fed_select_workspace_words(n)),
                         dtype=torch.int32, device=dev)
        ws_f = torch.empty(max(ws_floats,
                               parent.fed_select_workspace_floats(n)),
                           dtype=torch.float32, device=dev)
        want = ref.fed_select_ref(scores, avail, k, r, p, beta)

        def call(name, mode):
            outs = (mask.data_ptr(), new_r.data_ptr() if mode else None,
                    w.data_ptr() if mode else None)
            rp = (r.data_ptr(), p.data_ptr()) if mode else (None, None)
            if name == "parent":
                err = parent.fed_select_launch(
                    scores.data_ptr(), avail.data_ptr(), k.data_ptr(), *rp,
                    None, *outs, n, beta, 1.0 - beta, mode, ws.data_ptr(),
                    ws_f.data_ptr(), stream)
            else:
                lib = libs["aggregated"] if name == "large_aggregated" \
                    else new
                err = lib.fed_select_launch(
                    scores.data_ptr(), avail.data_ptr(), k.data_ptr(), 0,
                    *rp, None, *outs, n, beta, 1.0 - beta, mode,
                    ws.data_ptr(), ws_f.data_ptr(),
                    1 if name == "small" else 2, stream)
            _build.check(err, f"fed_select {name} launch")

        names = ["parent", "large", "large_aggregated"] + (
            ["small"] if n <= small_cap else [])
        row = dict(n=n, ties=ties, k=k_val, bytes_unbiased=22 * n + 4,
                   bytes_mask=6 * n + 4,
                   bound_ms_unbiased=cs.bound_ms(22 * n + 4)[0],
                   bound_ms_mask=cs.bound_ms(6 * n + 4)[0])
        for mode_name, mode in MODES.items():
            for name in fa.in_turns(names):
                call(name, mode)
                torch.cuda.synchronize()
                rec = row.setdefault(f"{name}_{mode_name}", dict(ms=[]))
                rec["mismatch"] = int((mask != want[0]).sum()) + (
                    int((new_r.view(torch.int32) != want[1].view(torch.int32))
                        .sum()) + int((w.view(torch.int32)
                                       != want[2].view(torch.int32)).sum())
                    if mode else 0)
                rec["ms"].append(cs.cuda_ms(lambda: call(name, mode),
                                            warmup=5, runs=25))
                rec.setdefault("device_us", []).append(
                    device_us(torch, lambda: call(name, mode)))
        row["wrapper"] = wrapper_costs(torch, cs, scores, avail, k, r, p,
                                       beta)
        print(json.dumps(row), flush=True)
        del scores, avail, r, p, ws, ws_f
    return 0



def device_us(torch, fn, calls: int = 20) -> float:
    """Device time of ``fn``'s kernels (and memsets) a call, from a
    torch.profiler trace of ``calls`` calls; a trace that recorded no
    device event (the profiler's loss) is taken again, up to three
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    return sum(e.time_range.elapsed_us() for e in events) / calls


def wrapper_costs(torch, cs, scores, avail, k, r, p, beta) -> dict:
    """The committed kernel through ``fed_select``: CUDA-event ms, host us
    a call, and the device us of its kernel (profiler)."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.fed_select import fed_select

    def call():
        return fed_select(scores, avail, k, r, p, beta)

    out = dict(ms=cs.cuda_ms(call, warmup=5, runs=25))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["host_us_per_call"] = 1e6 * host / 200
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    out["device_us_per_call"] = sum(e.time_range.elapsed_us()
                                    for e in kernels) / 20
    out["device_events_per_call"] = len(kernels) / 20
    return out


if __name__ == "__main__":
    sys.exit(main())
