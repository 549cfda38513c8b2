"""The port's training CLI, ``python -m repro_torch.launch.train``: a paper
task runs on the CPU from ``--task`` and from a ``--spec`` file, the spec it
saves is the one the JAX package's CLI builds from the same flags, the
host loop, buffered, checkpoint and poc flags run, ``--arch`` trains a
smoke config (whisper-small's encoder-decoder among them), and the flag
the port lacks (``--mesh-shape C,M``) raises ``NotImplementedError``
naming its ROADMAP.md queue 1 item before anything runs."""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sim as jsim
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]


def test_task_runs_on_the_cpu_and_saves_the_jax_spec(tmp_path):
    """``--task cifar --device cpu --rounds 2`` (the task's own data: 50
    clients of 16×16 images) in a fresh process, one intra-op thread."""
    spec_path = tmp_path / "run.spec.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--task", "cifar",
         "--device", "cpu", "--rounds", "2", "--save-spec", str(spec_path)],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    final = json.loads(out.stdout[out.stdout.index("{"):])
    assert final["device"] == "cpu" and final["round"] == 1
    assert final["n_selected"] == 10 and 0.0 <= final["test_acc"] <= 1.0
    want = jsim.RunSpec(scenario=jsim.Scenario(
        name="homedevices", availability="homedevices", task="cifar"),
        rounds=2)
    assert spec_path.read_text().strip() == want.to_json()


def test_spec_file_runs(tmp_path, capsys):
    """A RunSpec JSON written by the JAX package (shakespeare, 8 sentences
    a client, a cohort of 2) through ``--spec``, with its metrics stream."""
    sc = jsim.Scenario(name="homedevices", availability="homedevices",
                       task="shakespeare",
                       task_kwargs={"sentences_per_client": 8})
    metrics = tmp_path / "m.jsonl"
    spec = jsim.RunSpec(scenario=sc, rounds=2, clients_per_round=2,
                        metrics_path=str(metrics))
    spec.save(str(tmp_path / "s.json"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(["--spec", str(tmp_path / "s.json"), "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["round"] for r in records] == [0, 1]
    assert all(r["k_t"] == 2 and r["n_selected"] == 2 for r in records)
    assert '"engine": "device"' in capsys.readouterr().out


@pytest.mark.parametrize("flags,item", [(["--mesh-shape", "2,2"], 11)])
def test_unported_flags_raise_naming_their_item(flags, item, tmp_path,
                                                monkeypatch):
    """``--mesh-shape 2,2`` (item 11's engine half, ported) parses into
    the spec that runs and the spec file; the run itself, 4 spawned
    ranks, is ``tests/test_torch_engine_model_axis.py``'s."""
    ran = []
    monkeypatch.setattr(train, "run_spec_dist",
                        lambda spec, **kw: ran.append(spec) or
                        train.TrainResult([], {}, None, None))
    train.main(["--task", "cifar", "--device", "cpu",
                "--save-spec", str(tmp_path / "s.json")] + flags)
    assert [s.mesh_shape for s in ran] == [(2, 2)]
    assert train.RunSpec.load(str(tmp_path / "s.json")).resolved() \
        .mesh_shape == (2, 2)
    assert f"item {item}" not in train.__doc__


def test_arch_runs_two_rounds_on_the_cpu(capsys):
    """``--arch llama3.2-1b --smoke --device cpu --rounds 2``: two rounds
    of the smoke config, each with a finite loss."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                    "--rounds", "2"])
    finally:
        torch.set_num_threads(n)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[llama3.2-1b-smoke] round")]
    assert len(lines) == 2
    assert all(np.isfinite(float(ln.split("loss=")[1])) for ln in lines)


def test_audio_arch_runs_on_the_cpu(capsys):
    """``--arch whisper-small --device cpu --rounds 1``: the encoder-decoder's
    smoke config trains, its stub frames drawn as JAX's CLI draws them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(["--arch", "whisper-small", "--device", "cpu",
                    "--rounds", "1"])
    finally:
        torch.set_num_threads(n)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[whisper-small-smoke] round")]
    assert len(lines) == 1
    assert np.isfinite(float(lines[0].split("loss=")[1]))


@pytest.mark.parametrize("flags,engine", [
    (["--engine", "host"], "host"), (["--ckpt-dir", "CKPT"], "device"),
    (["--aggregation", "buffered", "--buffer-size", "3",
      "--staleness-power", "1.0", "--staleness-discount", "exponential"],
     "device"),
    (["--algo", "poc"], "host")])
def test_ported_flags_run_two_rounds(flags, engine, tmp_path, capsys):
    """The flags that raised NotImplementedError until the host loop, the
    buffered server, checkpoints and Power-of-Choice were ported: each
    runs 2 rounds of the default cell on the CPU, streams 2 JSONL records
    and reports the engine that ran (``--algo poc`` falls back to the host
    loop, as in the JAX package)."""
    flags = [str(tmp_path / "ckpt") if f == "CKPT" else f for f in flags]
    metrics = tmp_path / "m.jsonl"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train.main(["--device", "cpu", "--rounds", "2", "--metrics-jsonl",
                    str(metrics)] + flags)
    out = capsys.readouterr().out
    final = json.loads(out[out.index("{"):])
    assert final["engine"] == engine and final["device"] == "cpu"
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["round"] for r in records] == [0, 1]
    if "buffered" in flags:
        assert final["aggregation"] == "buffered"
        assert all(r["n_buffered"] <= 3 for r in records)
    if "poc" in flags:
        assert any("falling back to engine='host'" in str(w.message)
                   for w in caught)
        assert final["engine_fallback"]
    if "--ckpt-dir" in flags:
        assert os.listdir(tmp_path / "ckpt") == ["state_00000002.npz"]
