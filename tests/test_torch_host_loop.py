"""The host reference loop of the port (``RunSpec(engine="host")``): its
cohort batch bitwise JAX's, with and without a key; its runs held to the
JAX package's host loop (masks, completed masks, K_t and |avail| bitwise,
r_k within 1e-6 — JAX's host loop runs its EMA op by op, the port JAX's
compiled arithmetic — losses within 1e-5) and to the port's own device
engine (r_k bitwise); its JSONL records; the host-only fallback; and the
deprecated ``run_scenario`` shim."""
import json
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import repro.sim as jsim
import repro_torch.sim as tsim
from repro.data import CohortSampler as JSampler
from repro.data import FederatedData as JFed
from repro.data.synthetic import make_synthetic_federated as jmake
from repro_torch import random as tr
from repro_torch.data import CohortSampler as TSampler
from repro_torch.data import FederatedData as TFed
from repro_torch.data import make_synthetic_federated as tmake
from torch_parity import one_intra_op_thread

ROUNDS = 12
TOL = 1e-5
R_TOL = 1e-6
CELLS = {
    "scarce/f3ast": dict(), "scarce/fixed_f3ast": dict(
        strategy="fixed_f3ast",
        strategy_kwargs={"r_target": [0.05 + 0.1 * k / 99
                                      for k in range(100)]}),
    "scarce/fedavg": dict(strategy="fedavg"),
    "scarce/uniform": dict(strategy="uniform"),
    "scarce/fedadam": dict(strategy="fedadam"),
    "stepk/f3ast": dict(scenario="stepk"),
    "dropout/f3ast": dict(scenario="dropout"),
}


def _quiet(*args, **kwargs):
    pass


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each cell through JAX's host loop, the port's host loop and the
    port's device engine, on the CPU, with its JSONL stream."""
    out = tmp_path_factory.mktemp("host")
    res = {}
    with one_intra_op_thread():
        for name, kw in CELLS.items():
            spec = jsim.RunSpec(rounds=ROUNDS, engine="host", eval_every=5,
                                **kw)
            tag = name.replace("/", "_")
            j = jsim.run_spec(spec.replace(
                metrics_path=str(out / f"{tag}_jax.jsonl")), log_fn=_quiet)
            tspec = tsim.RunSpec.from_json(spec.to_json())
            t = tsim.run_spec(tspec.replace(
                metrics_path=str(out / f"{tag}_torch.jsonl")), device="cpu",
                log_fn=_quiet)
            d = tsim.run_spec(tspec.replace(engine="device"), device="cpu",
                              log_fn=_quiet)
            res[name] = (j, t, d, _jsonl(out / f"{tag}_jax.jsonl"),
                         _jsonl(out / f"{tag}_torch.jsonl"))
    return res


def _feds(n=12, spc=30):
    return (JFed(jmake(n, samples_per_client=spc, seed=3)),
            TFed(tmake(n, samples_per_client=spc, seed=3)))


def test_cohort_batch_bitwise_jax_with_and_without_key():
    jfed, tfed = _feds()
    kw = dict(cohort_size=5, local_steps=3, local_batch=4, seed=7)
    js, ts = JSampler(jfed, **kw), TSampler(tfed, **kw)
    for sel, seed in (([2, 7, 9], 0), ([11], 1), ([0, 1, 2, 3, 4], 2),
                      ([4, 8], None), ([6, 1, 3], None)):
        if seed is None:       # the legacy numpy stream, call after call
            jb, jv, ji = js.cohort_batch(sel)
            tb, tv, ti = ts.cohort_batch(sel)
        else:
            jb, jv, ji = js.cohort_batch(sel, key=jax.random.PRNGKey(seed))
            tb, tv, ti = ts.cohort_batch(sel, key=tr.PRNGKey(seed,
                                                             device="cpu"))
        assert jv.tobytes() == tv.tobytes()
        assert ji.dtype == ti.dtype and ji.tobytes() == ti.tobytes()
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].shape == tb[k].shape == (5, 3, 4) + jb[k].shape[3:]
            assert jb[k].dtype == tb[k].dtype
            assert jb[k].tobytes() == tb[k].tobytes(), (sel, k)
    assert ti.tolist() == [6, 1, 3, 6, 6]
    assert tv.tolist() == [True, True, True, False, False]


def test_cohort_batch_with_key_is_the_staged_gather():
    from repro_torch.data.pipeline import staged_cohort_batch
    _, tfed = _feds()
    ts = TSampler(tfed, cohort_size=4, local_steps=2, local_batch=3)
    key = tr.PRNGKey(5, device="cpu")
    tb, _, ids = ts.cohort_batch([3, 10], key=key)
    staged = ts.stage_device("cpu")
    want = staged_cohort_batch(staged, key, torch.from_numpy(ids).long(),
                               2, 3)
    for k in tb:
        assert tb[k].tobytes() == want[k].numpy().tobytes()
    with pytest.raises(ValueError, match="cohort_size"):
        TSampler(tfed).cohort_batch([1])


@pytest.mark.parametrize("cell", list(CELLS))
def test_host_loop_matches_jax_host_loop(runs, cell):
    j, t, _, _, _ = runs[cell]
    assert t.final_metrics["engine"] == "host"
    assert t.sel_history.tobytes() == j.sel_history.tobytes()
    assert t.comp_history.tobytes() == j.comp_history.tobytes()
    np.testing.assert_allclose(t.rates, j.rates, rtol=0, atol=R_TOL)
    np.testing.assert_allclose(t.empirical_rates, j.empirical_rates,
                               rtol=0, atol=0)
    for a, b in zip(t.history, j.history):
        assert a["round"] == b["round"]
        assert abs(a["test_loss"] - b["test_loss"]) <= TOL


@pytest.mark.parametrize("cell", list(CELLS))
def test_host_loop_matches_the_ports_device_engine(runs, cell):
    """The port has one arithmetic: its host loop's r_k is bitwise its
    device engine's (which the engine tests hold bitwise to JAX's)."""
    _, t, d, _, _ = runs[cell]
    assert d.final_metrics["engine"] == "device"
    for name in ("sel_history", "comp_history", "k_t", "n_available",
                 "rates"):
        assert getattr(t, name).tobytes() == getattr(d, name).tobytes(), name
    np.testing.assert_allclose(t.train_loss, d.train_loss, rtol=0, atol=TOL)


@pytest.mark.parametrize("cell", list(CELLS))
def test_jsonl_records_match_jax(runs, cell):
    _, t, _, jl, tl = runs[cell]
    assert len(tl) == len(jl) == ROUNDS
    assert [sorted(r) for r in tl] == [sorted(r) for r in jl]
    for key in ("scenario", "algorithm", "round", "k_t", "n_available",
                "n_selected", "n_completed"):
        assert [r[key] for r in tl] == [r[key] for r in jl], key
    for key in ("train_loss", "delta_norm"):
        np.testing.assert_allclose([r[key] for r in tl],
                                   [r[key] for r in jl], rtol=0, atol=TOL)
    assert [r["k_t"] for r in tl] == t.k_t.tolist()
    assert [r["n_available"] for r in tl] == t.n_available.tolist()
    fm = t.final_metrics
    assert fm["n_staged_bytes"] == 0
    assert fm["selection_comm_bytes_per_round"] == 0
    assert fm["device"] == "cpu" and "engine_fallback" not in fm


def test_poc_falls_back_to_the_host_loop_with_jax_words():
    spec = jsim.RunSpec(strategy="poc", rounds=3, eval_every=1)
    with pytest.warns(UserWarning, match="poc") as jw:
        jres = jsim.run_spec(spec, log_fn=_quiet)
    with pytest.warns(UserWarning, match="poc") as tw:
        tres = tsim.run_spec(tsim.RunSpec.from_json(spec.to_json()),
                             device="cpu", log_fn=_quiet)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert tres.final_metrics["engine"] == "host"
    assert tres.final_metrics["engine_fallback"] == \
        jres.final_metrics["engine_fallback"]
    assert tres.sel_history.tobytes() == jres.sel_history.tobytes()
    with pytest.raises(ValueError, match="host-only"):
        tsim.build_engine("scarce", "poc", device="cpu")


def test_run_scenario_shim_warns_and_rejects_as_jax():
    with pytest.warns(DeprecationWarning, match="deprecated"):
        res = tsim.run_scenario("scarce", "f3ast", rounds=2, eval_every=1,
                                device="cpu", log_fn=_quiet)
    assert res.sel_history.shape == (2, 100)
    # the canonical form takes a RunSpec and no extra arguments
    spec = tsim.RunSpec(rounds=2, engine="host")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        assert tsim.run_scenario(spec, device="cpu", log_fn=_quiet) \
            .final_metrics["engine"] == "host"
    for call, exc in (
            (lambda: tsim.run_scenario(spec, "fedavg", device="cpu"),
             TypeError),
            (lambda: tsim.run_scenario(device="cpu"), TypeError),
            (lambda: tsim.run_scenario("scarce", "f3ast", bogus=1,
                                       device="cpu"), TypeError),
            (lambda: tsim.run_scenario("scarce", "f3ast", mesh=2,
                                       mesh_shape=(2,), device="cpu"),
             TypeError),
            (lambda: tsim.run_scenario("scarce", "f3ast", mesh="2",
                                       device="cpu"), TypeError)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(exc):
                call()
    # the legacy scalar mesh= is the 1-D mesh_shape (the sharded engine)
    with pytest.warns(DeprecationWarning):
        assert tsim.runner._legacy_spec("scarce", "f3ast", {"mesh": 2}) \
            .resolved().mesh_shape == (2,)
    # and a 2-D mesh_shape, the (clients, model) mesh, is taken as in JAX
    with pytest.warns(DeprecationWarning):
        assert tsim.runner._legacy_spec(
            "scarce", "f3ast", {"mesh_shape": (2, 2)}).resolved() \
            .mesh_shape == (2, 2)
    # the legacy server_lr default: 1.0, which only an alias reads as unset
    with pytest.warns(DeprecationWarning):
        spec = tsim.runner._legacy_spec("scarce", "fedadam", {})
    assert spec.server_lr is None
