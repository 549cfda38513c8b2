"""Import and device hygiene of the port: ``repro_torch`` imports neither
JAX nor the JAX package, its entry points default to CUDA and raise
without a card, and nothing is built at import."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SLICE_MODULES = [
    "repro_torch", "repro_torch.random", "repro_torch.convert",
    "repro_torch.device", "repro_torch.registry", "repro_torch.core.keys",
    "repro_torch.core.hfun", "repro_torch.core.rates",
    "repro_torch.core.aggregation",
    "repro_torch.core.selection", "repro_torch.core.strategies",
    "repro_torch.core.availability", "repro_torch.core.fedstep",
    "repro_torch.kernels.ref", "repro_torch.kernels.fed_select",
    "repro_torch.kernels.fed_aggregate", "repro_torch.kernels._build",
    "repro_torch.sim", "repro_torch.sim.processes",
    "repro_torch.sim.budgets", "repro_torch.sim.completion",
    "repro_torch.sim.scenario", "repro_torch.sim.spec",
    "repro_torch.sim.engine", "repro_torch.sim.runner",
    "repro_torch.data", "repro_torch.models.softmax_reg",
    "repro_torch.optim", "repro_torch.configs",
    "repro_torch.configs.common", "repro_torch.configs.llama3_2_1b",
    "repro_torch.configs.mamba2_2_7b",
    "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.transformer", "repro_torch.models.ssm",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd_chunk",
    "repro_torch.launch",
    "repro_torch.launch.serve", "repro_torch.launch.steps"]


def test_import_pulls_in_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib|repro)\b"
    r"(?!_)|from\s+\.\.\.)", re.M)


def test_source_scan_finds_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    hits = [(str(f.relative_to(ROOT)), m.group(0).strip())
            for f in files for m in IMPORT_RE.finditer(f.read_text())]
    assert hits == []


def test_chip_scripts_import_no_jax_or_repro():
    """The root scripts that drive the port on the card import none of the
    JAX package either."""
    scripts = sorted(ROOT.glob("chip_*.py"))
    assert {f.name for f in scripts} >= {"chip_smoke.py",
                                         "chip_flash_ablation.py",
                                         "chip_ssd_ablation.py",
                                         "chip_select_ablation.py"}
    hits = [(f.name, m.group(0).strip())
            for f in scripts for m in IMPORT_RE.finditer(f.read_text())]
    assert hits == []


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edit of a shared header rebuilds every kernel, and nvcc finds the
    headers wherever the source it compiles lies."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["tensor_core.cuh"]
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command("ssd_chunk", tmp_path / "v.cu", tmp_path / "v.so")
    assert cmd[cmd.index("-I") + 1] == str(csrc)
    assert cmd[-1] == str(tmp_path / "v.cu")


def test_cuda_sources_exist_for_every_kernel():
    from repro_torch.kernels import _build
    for name, (src, _) in _build.SOURCES.items():
        assert (_build.CSRC / src).exists(), name
        assert "sm_90a" in " ".join(_build._flags(name))


def test_run_spec_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    from repro_torch.device import resolve_device
    from repro_torch.sim import RunSpec, run_spec
    with pytest.raises(RuntimeError, match="CUDA"):
        run_spec(RunSpec(rounds=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def _entry_points():
    """Every public function of the port that places tensors, called
    without ``device=``."""
    import numpy as np
    from repro_torch import random as jr
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.rates import init_rates
    from repro_torch.core.strategies import make_strategy
    from repro_torch.models import softmax_reg
    from repro_torch.sim.budgets import make_budget
    from repro_torch.sim.processes import make_process
    from repro_torch.sim.runner import build_task
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    llama = get_arch("llama3.2-1b").smoke_model
    mamba = get_arch("mamba2-2.7b").smoke_model
    return {
        "serve": lambda: serve("llama3.2-1b", steps=1, log_fn=None),
        "transformer.init_params": lambda: transformer.init_params(
            llama, jr.PRNGKey(0, device="cpu")),
        "init_decode_state": lambda: transformer.init_decode_state(
            llama, 1, 8),
        "serve(mamba2)": lambda: serve("mamba2-2.7b", steps=1, log_fn=None),
        "transformer.init_params(mamba2)": lambda: transformer.init_params(
            mamba, jr.PRNGKey(0, device="cpu")),
        "init_decode_state(mamba2)": lambda: transformer.init_decode_state(
            mamba, 1, 8),
        "build_task": lambda: build_task("synthetic11", 0),
        "PRNGKey": lambda: jr.PRNGKey(0),
        "make_strategy": lambda: make_strategy("f3ast", 4, np.full(4, 0.25)),
        "make_process": lambda: make_process("scarce", 4),
        "make_budget": lambda: make_budget("constant"),
        "init_rates": lambda: init_rates(4),
        "init_params": lambda: softmax_reg.init_params(
            softmax_reg.SoftmaxRegConfig(), None),
        "params_from_numpy": lambda: params_from_numpy(
            {"w": np.zeros(2, np.float32)}),
    }


@pytest.mark.parametrize("name", ["build_task", "PRNGKey", "make_strategy",
                                  "make_process", "make_budget", "init_rates",
                                  "init_params", "params_from_numpy",
                                  "serve", "transformer.init_params",
                                  "init_decode_state", "serve(mamba2)",
                                  "transformer.init_params(mamba2)",
                                  "init_decode_state(mamba2)"])
def test_entry_point_defaults_to_cuda_and_raises_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()
