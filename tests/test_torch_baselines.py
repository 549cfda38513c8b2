"""The paper's baselines in the port: fixed_f3ast, fedavg, fedavg_weighted,
uniform and the fedadam alias (with the adam, adamw and yogi server
optimizers), the functional ``fedavg_select``/``uniform_select``, the
deprecated ``core.algorithms`` shim and the ``sim.sweep`` CLI, each held
to the JAX package (mirrors ``tests/test_strategies.py``,
``tests/test_parity_matrix.py`` and ``tests/test_optim.py``)."""
import dataclasses
import json
import os
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.sim as jsim
import repro_torch.sim as tsim
from repro.core import selection as jsel
from repro.core import strategies as jstrat
from repro.core.algorithms import make_algorithm as jax_make_algorithm
from repro.optim import optimizers as jopt
from repro.sim import sweep as jsweep
from repro_torch import random as tr
from repro_torch.core import algorithms as talg
from repro_torch.core import selection as tsel
from repro_torch.core import strategies as tstrat
from repro_torch.optim import optimizers as topt
from repro_torch.sim import sweep as tsweep
from torch_parity import assert_cell_parity

ROUNDS = 40
# fixed_f3ast's frozen target: a ramp around the feasible rate K/N
R_TARGET = np.linspace(0.05, 0.15, 100).tolist()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*args, **kwargs):
    pass


@pytest.mark.parametrize("scenario", ["homedevices", "dropout"])
@pytest.mark.parametrize("strategy", ["fixed_f3ast", "fedavg",
                                      "fedavg_weighted", "uniform",
                                      "fedadam"])
def test_baseline_matches_jax(scenario, strategy):
    kw = {"r_target": R_TARGET} if strategy == "fixed_f3ast" else {}
    spec = jsim.RunSpec(scenario=scenario, strategy=strategy, rounds=ROUNDS,
                        strategy_kwargs=kw).to_json()
    assert_cell_parity(spec, ROUNDS)


@pytest.mark.parametrize("base,strategy", [("uneven", "f3ast"),
                                           ("uneven", "fedavg"),
                                           ("homedevices", "fedavg_weighted"),
                                           ("dropout", "fixed_f3ast")])
def test_powerlaw_clients_match_jax(base, strategy):
    """With power-law client sizes p is not uniform, so ``uneven``'s
    availability, fedavg's log p scores and the p-weighted rules depend
    on it."""
    sc = dataclasses.asdict(jsim.get_scenario(base))
    sc.update(name=f"{base}_powerlaw",
              task_kwargs={"samples_per_client": None})
    kw = {"r_target": R_TARGET} if strategy == "fixed_f3ast" else {}
    spec = json.dumps(dict(json.loads(jsim.RunSpec(
        rounds=ROUNDS, strategy=strategy, strategy_kwargs=kw).to_json()),
        scenario=sc))
    assert_cell_parity(spec, ROUNDS)
    p = tsim.build_task("synthetic11", 0, device="cpu",
                        samples_per_client=None)[1].p
    assert np.ptp(p) > 0


def test_fedavg_log_p_is_the_folded_log():
    """The JAX engine closes over p, so XLA folds log(max(p, 1e-12)) at
    compile time, correctly rounded; its runtime ``log`` differs from that
    in some lanes, so the strategy must take the folded value."""
    rng = np.random.default_rng(0)
    p_np = rng.dirichlet(np.full(1 << 14, 0.5)).astype(np.float32)
    p_np[:3] = (0.0, 1e-13, 1e-12)
    P = jnp.asarray(p_np)
    folded = np.asarray(jax.jit(lambda: jnp.log(jnp.maximum(P, 1e-12)))())
    runtime = np.asarray(jax.jit(
        lambda a: jnp.log(jnp.maximum(a, 1e-12)))(P))
    ours = tstrat._log_p(torch.from_numpy(p_np)).numpy()
    assert ours.tobytes() == folded.tobytes()
    assert (runtime != folded).sum() > 0


def test_resolve_strategy_alias_and_lr_defaults():
    for name, opt, lr in (("fedadam", "sgd", None), ("fedavg", "adam", None),
                          ("fedavg", "yogi", 0.5), ("f3ast", "sgd", None),
                          ("FEDADAM", "sgd", 0.3)):
        assert tstrat.resolve_strategy(name, opt, lr) == \
            jstrat.resolve_strategy(name, opt, lr)


def test_poc_and_as_sharded_name_their_items():
    """``poc`` raised naming item 7 until the host loop was ported: now it
    is registered with JAX's routing flags and builds.  ``as_sharded``
    raised naming item 11 until the sharded engine was ported: now it
    builds for f3ast and, as JAX's, refuses a strategy without a
    score/finalize decomposition."""
    jentry = jstrat.get_strategy_entry("poc")
    tentry = tstrat.get_strategy_entry("poc")
    assert (tentry.host_only, tentry.needs_losses) == \
        (jentry.host_only, jentry.needs_losses) == (True, True)
    tsim.RunSpec(strategy="poc").resolved()
    s = tstrat.make_strategy("poc", 10, np.full(10, 0.1, np.float32),
                             device="cpu")
    assert s.needs_losses and s.host_only
    with pytest.raises(ValueError, match="score/finalize"):
        tstrat.as_sharded(s, axis="clients", k_max=4, n_pad=16)
    with pytest.raises(ValueError, match="score/finalize"):
        jstrat.as_sharded(jstrat.make_strategy(
            "poc", 10, np.full(10, 0.1, np.float32)), axis="clients",
            k_max=4, n_pad=16)
    s = tstrat.make_strategy("f3ast", 10, np.full(10, 0.1, np.float32),
                             device="cpu")
    assert not (s.needs_losses or s.host_only)
    assert callable(tstrat.as_sharded(s, axis="clients", k_max=4, n_pad=16))
    with pytest.raises(ValueError, match="topk_impl"):
        tstrat.as_sharded(s, axis="clients", k_max=4, n_pad=16,
                          topk_impl="bogus")


@pytest.mark.parametrize("seed", [0, 1])
def test_fedavg_and_uniform_select_match_jitted_jax(seed):
    rng = np.random.default_rng(seed)
    n = 1000
    p = rng.dirichlet(np.full(n, 0.3)).astype(np.float32)
    avail = rng.random(n) < 0.4
    k = np.int32(25)
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed, device="cpu")
    want = np.asarray(jax.jit(jsel.fedavg_select)(jk, avail, k, p))
    got = tsel.fedavg_select(tk, torch.from_numpy(avail),
                             torch.tensor(k), torch.from_numpy(p)).numpy()
    assert want.tobytes() == got.tobytes() and got.sum() == 25
    want = np.asarray(jax.jit(jsel.uniform_select)(jk, avail, k))
    got = tsel.uniform_select(tk, torch.from_numpy(avail),
                              torch.tensor(k)).numpy()
    assert want.tobytes() == got.tobytes()


@pytest.mark.parametrize("name,kw", [("adam", dict(lr=1e-2)),
                                     ("adamw", dict(lr=1e-2)),
                                     ("yogi", dict(lr=1e-2)),
                                     ("sgd", dict(lr=0.7))])
def test_server_optimizers_match_jax(name, kw):
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(60, 10)).astype(np.float32),
              "b": rng.normal(size=(10,)).astype(np.float32)}
    jo, to = jopt.make_optimizer(name, **kw), topt.make_optimizer(name, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(6):
        d = {k: (rng.normal(size=v.shape) * 0.1).astype(np.float32)
             for k, v in params.items()}
        ju, js = jo.update({k: jnp.asarray(v) for k, v in d.items()}, js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in d.items()},
                           ts, tp)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_algorithm_shim_still_selects():
    p = np.full(20, 0.05, np.float32)
    with pytest.warns(DeprecationWarning):
        algo = talg.make_algorithm("fedavg", 20, p, device="cpu")
    state = algo.init()
    avail = torch.arange(20) % 2 == 0
    mask, w, state = algo.select(state, tr.PRNGKey(0, device="cpu"), avail,
                                 torch.tensor(4, dtype=torch.int32))
    assert int(mask.sum()) == 4 and not bool((mask & ~avail).any())
    assert torch.allclose(w[mask], torch.full((4,), 0.25))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        j = jax_make_algorithm("fedavg", 20, p)
        jmask, _, _ = j.select(j.init(), jax.random.PRNGKey(0),
                               jnp.asarray(avail.numpy()), jnp.asarray(4))
    assert np.asarray(jmask).tobytes() == mask.numpy().tobytes()


def _tree(out):
    return sorted(os.listdir(out))


def test_sweep_writes_the_jax_layout(tmp_path):
    args = ["--scenarios", "homedevices,dropout", "--algorithms",
            "f3ast,fedadam", "--rounds", "3"]
    jsweep.main(args + ["--out", str(tmp_path / "jax")])
    tsweep.main(args + ["--out", str(tmp_path / "torch"), "--device", "cpu"])
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "torch")
    assert len(_tree(tmp_path / "torch")) == 2 * 2 * 2 + 1
    js = json.loads((tmp_path / "jax" / "summary.json").read_text())
    ts = json.loads((tmp_path / "torch" / "summary.json").read_text())
    assert sorted(js) == sorted(ts)
    for cell in js:
        assert set(js[cell]) - {"engine_fallback"} <= set(ts[cell]) | {
            "steady_rounds_per_s"}
        assert abs(js[cell]["test_acc"] - ts[cell]["test_acc"]) <= 1e-5
    for name in _tree(tmp_path / "jax"):
        if name.endswith(".jsonl"):
            jl = [json.loads(x) for x in
                  (tmp_path / "jax" / name).read_text().splitlines()]
            tl = [json.loads(x) for x in
                  (tmp_path / "torch" / name).read_text().splitlines()]
            assert [sorted(r) for r in jl] == [sorted(r) for r in tl]
            for key in ("k_t", "n_available", "n_selected", "n_completed"):
                assert [r[key] for r in jl] == [r[key] for r in tl], name
        if name.endswith(".spec.json"):
            jspec = jsim.RunSpec.load(str(tmp_path / "jax" / name))
            tspec = tsim.RunSpec.load(str(tmp_path / "torch" / name))
            assert jspec.replace(metrics_path=None).to_json() == \
                tspec.replace(metrics_path=None).to_json()


def test_sweep_rejects_poc_before_running_and_lists(tmp_path, capsys):
    """The sweep rejected ``poc`` (item 7) until the host loop was ported:
    now it runs it for 2 rounds (on the host loop, as the JAX sweep does),
    masks and K_t as JAX's; ``--list`` prints the JAX registry."""
    args = ["--scenarios", "scarce", "--algorithms", "f3ast,poc",
            "--rounds", "2"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # poc's fallback
        jsweep.main(args + ["--out", str(tmp_path / "jax")])
        tsweep.main(args + ["--out", str(tmp_path / "torch"), "--device",
                            "cpu"])
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "torch")
    ts = json.loads((tmp_path / "torch" / "summary.json").read_text())
    assert ts["scarce|poc"]["engine"] == "host"
    assert ts["scarce|f3ast"]["engine"] == "device"
    for name in ("scarce__f3ast.jsonl", "scarce__poc.jsonl"):
        jl, tl = ([json.loads(x) for x in (tmp_path / side / name)
                   .read_text().splitlines()] for side in ("jax", "torch"))
        for key in ("k_t", "n_available", "n_selected", "n_completed"):
            assert [r[key] for r in jl] == [r[key] for r in tl], name
    capsys.readouterr()
    tsweep.main(["--list"])
    listed = capsys.readouterr().out.split("\n")
    assert [ln.split()[0] for ln in listed if ln.strip()] == \
        jsim.list_scenarios()
