"""The main path end to end: one RunSpec JSON, written by the JAX package,
drives both packages.  For the default F3AST cell (300 rounds) the port's
CPU path gives bitwise the JAX device engine's selection and completion
masks, K_t, |avail| and final r_k, and train loss and delta norm within
1e-5; ``select_impl="pallas"`` gives the same trajectory; the per-round
JSONL records carry the same keys.
"""
import json
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.sim as jsim
import repro_torch.sim as tsim
from torch_parity import one_intra_op_thread

ROUNDS = 300
TOL = 1e-5


def _quiet(*args, **kwargs):
    pass


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("engine")
    spec_json = jsim.RunSpec(rounds=ROUNDS).to_json()
    res = {}
    jspec = jsim.RunSpec.from_json(spec_json).replace(
        metrics_path=str(out / "jax.jsonl"))
    with one_intra_op_thread():
        res["jax"] = (jsim.run_spec(jspec, log_fn=_quiet),
                      _jsonl(out / "jax.jsonl"))
        for impl in ("xla", "pallas"):
            tspec = tsim.RunSpec.from_json(spec_json).replace(
                select_impl=impl,
                metrics_path=str(out / f"torch_{impl}.jsonl"))
            res[impl] = (tsim.run_spec(tspec, device="cpu", log_fn=_quiet),
                         _jsonl(out / f"torch_{impl}.jsonl"))
    return res


def test_spec_json_round_trips_between_packages():
    for spec in (jsim.RunSpec(), jsim.RunSpec(rounds=7, seed=3,
                                              select_impl="pallas")):
        s = spec.to_json()
        assert tsim.RunSpec.from_json(s).to_json() == s


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_masks_and_rates_bitwise(runs, impl):
    jr, jl = runs["jax"]
    tr, tl = runs[impl]
    assert tr.sel_history.shape == jr.sel_history.shape == (ROUNDS, 100)
    assert tr.sel_history.tobytes() == jr.sel_history.tobytes()
    assert tr.comp_history.tobytes() == jr.comp_history.tobytes()
    assert tr.rates.dtype == jr.rates.dtype == np.float32
    assert tr.rates.tobytes() == jr.rates.tobytes()
    for key in ("k_t", "n_available", "n_selected", "n_completed"):
        assert [r[key] for r in tl] == [r[key] for r in jl], key
    assert tr.k_t.tolist() == [r["k_t"] for r in jl]
    assert tr.n_available.tolist() == [r["n_available"] for r in jl]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_losses_within_tolerance(runs, impl):
    _, jl = runs["jax"]
    tr, tl = runs[impl]
    for key in ("train_loss", "delta_norm"):
        np.testing.assert_allclose([r[key] for r in tl], [r[key] for r in jl],
                                   rtol=0, atol=TOL, err_msg=key)
    eval_rows = [(r, s) for r, s in zip(jl, tl) if "test_acc" in r]
    assert eval_rows and all("test_acc" in s for _, s in eval_rows)
    for r, s in eval_rows:
        assert abs(r["test_loss"] - s["test_loss"]) <= TOL
        assert abs(r["test_acc"] - s["test_acc"]) <= TOL
    assert np.isfinite(tr.train_loss).all()


def test_pallas_trajectory_equals_xla_on_cpu(runs):
    a, b = runs["xla"][0], runs["pallas"][0]
    assert a.sel_history.tobytes() == b.sel_history.tobytes()
    assert a.rates.tobytes() == b.rates.tobytes()
    assert a.train_loss.tobytes() == b.train_loss.tobytes()


def test_jsonl_keys_match(runs):
    _, jl = runs["jax"]
    for impl in ("xla", "pallas"):
        _, tl = runs[impl]
        assert len(tl) == len(jl) == ROUNDS
        assert [sorted(r) for r in tl] == [sorted(r) for r in jl]


def test_history_and_final_metrics(runs):
    jr, _ = runs["jax"]
    tr, _ = runs["xla"]
    assert [h["round"] for h in tr.history] == [h["round"] for h in jr.history]
    for key in ("engine", "test_acc", "n_staged_bytes",
                "selection_comm_bytes_per_round"):
        assert key in tr.final_metrics
    assert tr.final_metrics["engine"] == "device"
    assert tr.final_metrics["n_staged_bytes"] == jr.final_metrics[
        "n_staged_bytes"]
    np.testing.assert_array_equal(tr.empirical_rates, jr.empirical_rates)


@pytest.mark.parametrize("override", [dict(mesh_shape=(2, 2))])
def test_resolve_rejects_unported(override):
    """A spec valid in the JAX package resolves in the port as it does
    there: the (clients, model) mesh (item 11's engine half, ported) and
    the 1-D mesh.  Its mesh has both axes.  The production mesh of the
    step builders is ported and, as JAX's, raises ``ValueError`` naming
    the ranks it needs on one process; what is left of item 11, the
    training program over a mesh, raises naming it."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import (make_debug_mesh, make_fed_mesh,
                                         make_production_mesh)
    from repro_torch.launch.steps import build_train_step
    want = jsim.RunSpec(**override).resolved()
    spec = tsim.RunSpec.from_json(jsim.RunSpec(**override).to_json())
    assert spec.resolved().mesh_shape == want.mesh_shape == (2, 2)
    assert make_fed_mesh((1, 1)).axis_names == ("clients", "model")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(NotImplementedError, match="item 11"):
        build_train_step(get_arch("llama3.2-1b"), "train_4k",
                         make_debug_mesh())
    one_d = jsim.RunSpec(mesh_shape=(2,)).to_json()
    assert tsim.RunSpec.from_json(one_d).resolved().mesh_shape == \
        jsim.RunSpec.from_json(one_d).resolved().mesh_shape == (2,)


@pytest.mark.parametrize("override", [
    dict(strategy="fedavg"), dict(strategy="fixed_f3ast"),
    dict(strategy="fedadam"), dict(scenario="markov"),
    dict(scenario="stepk"), dict(server_opt="adam"),
    dict(completion="bernoulli"), dict(fed_mode="sequential"),
    dict(engine="host"), dict(aggregation="buffered"),
    dict(strategy="poc"), dict(ckpt_dir="ckpt")])
def test_resolve_runs_what_was_unported(override, tmp_path):
    """These specs raised NotImplementedError until the scenario axes, the
    baselines, the sequential cohort mode, the host loop, Power-of-Choice,
    the buffered server and checkpoints were ported: each resolves as in
    the JAX package and runs a few rounds with its masks, K_t and |avail|
    bitwise JAX's; r_k bitwise, or within 1e-6 on the host loop (JAX's
    runs its EMA op by op, the port JAX's compiled arithmetic)."""
    rounds = 4
    if "ckpt_dir" in override:
        override = dict(ckpt_dir=str(tmp_path / "ckpt"))
    jspec = jsim.RunSpec(rounds=rounds, eval_every=2, **override)
    jr = jspec.resolved()
    spec = tsim.RunSpec.from_json(jspec.to_json())
    tr_ = spec.resolved()
    for field in ("strategy", "server_opt", "server_lr", "completion",
                  "engine", "aggregation", "ckpt_dir"):
        assert getattr(tr_, field) == getattr(jr, field), field
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # poc's fallback
        jres = jsim.run_spec(jspec.replace(metrics_path=str(tmp_path / "j")),
                             log_fn=_quiet)
        tres = tsim.run_spec(spec.replace(metrics_path=str(tmp_path / "t")),
                             device="cpu", log_fn=_quiet)
    assert tres.final_metrics["engine"] == jres.final_metrics["engine"]
    assert tres.sel_history.tobytes() == jres.sel_history.tobytes()
    assert tres.comp_history.tobytes() == jres.comp_history.tobytes()
    if jres.final_metrics["engine"] == "host":
        np.testing.assert_allclose(tres.rates, jres.rates, rtol=0, atol=1e-6)
    else:
        assert tres.rates.tobytes() == jres.rates.tobytes()
    jl, tl = _jsonl(tmp_path / "j"), _jsonl(tmp_path / "t")
    assert [sorted(r) for r in tl] == [sorted(r) for r in jl]
    for key in ("k_t", "n_available", "n_completed", "n_buffered"):
        assert [r.get(key) for r in tl] == [r.get(key) for r in jl], key
    np.testing.assert_allclose([r["train_loss"] for r in tl],
                               [r["train_loss"] for r in jl], rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("task", ["shakespeare", "cifar"])
def test_paper_tasks_resolve(task):
    """The Shakespeare and CIFAR tasks raised NotImplementedError (item
    10) until they were ported: a spec naming either resolves in the port
    as in the JAX package, in both cohort modes, and the task's config is
    the JAX package's."""
    from repro.configs import PAPER_TASKS as JTASKS
    from repro_torch.configs import PAPER_TASKS as TTASKS
    sc = jsim.Scenario(name="homedevices", availability="homedevices",
                       task=task)
    for mode in ("parallel", "sequential"):
        jspec = jsim.RunSpec(scenario=sc, fed_mode=mode)
        spec = tsim.RunSpec.from_json(jspec.to_json())
        assert spec.resolved().to_json() == jspec.resolved().to_json()
    assert repr(TTASKS[task]) == repr(JTASKS[task])


@pytest.mark.parametrize("override,exc", [
    (dict(strategy="nope"), KeyError), (dict(scenario="nope"), KeyError),
    (dict(rounds=0), ValueError), (dict(engine="tpu"), ValueError),
    (dict(select_impl="cuda"), ValueError)])
def test_resolve_rejects_invalid_as_jax_does(override, exc):
    with pytest.raises(exc):
        jsim.RunSpec(**override).resolved()
    with pytest.raises(exc):
        tsim.RunSpec(**override).resolved()
