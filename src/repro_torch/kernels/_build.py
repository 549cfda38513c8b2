"""Build and load the port's CUDA kernels (nvcc into a plain C library,
bound with ``ctypes``).

Each ``csrc/*.cu`` file is compiled on first use by its own ``nvcc``
process (all started together) into ``build/kernels/`` at the root of the
checkout, under a name that carries a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.
Nothing is compiled at import: the CPU tests import every module without a
CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (source, extra nvcc flags).  fed_select is built without FMA
# contraction: its bit parity needs exactly one FMA (the EMA, spelled
# __fmaf_rn) and no other.
SOURCES: Dict[str, tuple] = {
    "fed_select": ("fed_select.cu", ("--fmad=false",)),
    "fed_aggregate": ("fed_aggregate.cu", ()),
    "flash_attention": ("flash_attention.cu", ()),
    "flash_attention_bwd": ("flash_attention_bwd.cu", ()),
    "ssd_chunk": ("ssd_chunk.cu", ()),
    "ssd_chunk_bwd": ("ssd_chunk_bwd.cu", ()),
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _flags(name: str) -> tuple:
    return _COMMON_FLAGS + SOURCES[name][1]


def nvcc_command(name: str, src: Path, out: Path) -> list:
    """The nvcc command that builds ``src`` with ``name``'s flags; the
    shared headers are found in ``csrc`` wherever ``src`` lies."""
    return [nvcc_path(), *_flags(name), "-I", str(CSRC), "-o", str(out),
            str(src)]


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name][0]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build() -> Dict[str, float]:
    """Compile every kernel that is not built yet, one ``nvcc`` each, all
    in parallel.  Returns {name: seconds} for what was compiled; the ptxas
    report of each build is kept beside it as ``.log``."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(name, CSRC / SOURCES[name][0], tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


_VP, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float

_SIGNATURES = {
    "fed_select": {
        "fed_select_small_max": ([], _I),
        "fed_select_small_cap": ([], _I),
        "fed_select_workspace_words": ([], _I),
        "fed_select_workspace_floats": ([], _I),
        "fed_select_launch": ([_VP] * 3 + [_I] + [_VP] * 6
                              + [_I, _F, _F, _I, _VP, _VP, _I, _VP], _I),
    },
    "fed_aggregate": {
        "fed_aggregate_f32": ([_VP, _VP, _VP, _I, _I64, _VP], _I),
        "fed_aggregate_bf16": ([_VP, _VP, _VP, _I, _I64, _VP], _I),
    },
    "flash_attention": {
        "flash_attention_launch": ([_VP] * 5 + [_I] * 7 + [_I64] * 9
                                   + [_I, _I, _F, _F, _VP], _I),
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": ([_VP] * 10 + [_I] * 7 + [_I64] * 9
                                       + [_I, _I, _F, _F, _VP], _I),
    },
    "ssd_chunk": {
        "ssd_chunk_launch": ([_VP] * 8 + [_I] * 7 + [_I64] * 14 + [_VP], _I),
    },
    "ssd_chunk_bwd": {
        "ssd_chunk_bwd_workspace_floats": ([_I] * 8, _I64),
        "ssd_chunk_bwd_launch": ([_VP] * 14 + [_I] * 7 + [_I64] * 14
                                 + [_I, _VP], _I),
    },
}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building every kernel first if
    this one is not built."""
    lib = _LIBS.get(name)
    if lib is None:
        if not library_path(name).exists():
            build()
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
