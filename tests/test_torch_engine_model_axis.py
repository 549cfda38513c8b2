"""The (clients, model) mesh of the port's sharded engine against the JAX
package's single-device device engine and the port's own 1-D mesh, as the
JAX package's ``tests/test_parity_matrix.py`` holds its mesh shapes.

On 4 gloo ranks (one spawn, one intra-op thread a rank), each run through
``run_spec(RunSpec(mesh_shape=...))`` inside the group, for every split
(4, 1), (2, 2) and (1, 4), on ``synthetic11`` cells (f3ast, fedadam with
its Adam moments split over the model axis, the ``dropout`` completion
hook on axes named ``data`` and ``tp``):

* masks, completion masks, K_t, |avail| and r_k bitwise JAX's device
  engine; train loss and delta norm within 1e-5;
* the final parameters (gathered over the model axis) bitwise the port's
  1-D run with the same clients axis: (2, 2) against (2,) (a spawn of 2
  ranks), (1, 4) against (1,) (one shard, in this process).  With at most
  2 client shards the clients-axis sum of a block is the sum of the whole
  sliced: the all-gather is exact, slicing commutes with the sum, and a
  float sum of two terms does not depend on their order;
* Shakespeare's LSTM (2 rounds, K = 4, fedadam), whose ``out_w`` the
  rules split along its dim 1: (2, 2) bitwise (2,) in the final
  parameters, so the gather and the slice along a dim past 0 are exact;
* (4,) and (4, 1) give the same bits (a model axis of one rank changes
  nothing);
* each rank stores only its blocks: a leaf the rules split keeps 1/m of
  its elements, in a storage of its own;
* the clients axis' ``exchange`` at (2, 2), whose group is not the
  default one, reaches the partner's global rank;
* ``sweep --mesh-shape 2,2`` and ``run_spec`` spawn the 4 ranks
  themselves."""
import json
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.sim as jsim
import repro_torch.sim as tsim
from repro_torch.launch.mesh import spawn_ranks

import torch_dist_workers as workers
from torch_parity import one_intra_op_thread

ROUNDS, TOL = 20, 1e-5
SPLITS = ((4, 1), (2, 2), (1, 4))
# the dropout cell names its axes otherwise: run_spec builds its meshes,
# (c,) and (1,) included, and its engine over the spec's names
CELLS = (dict(), dict(strategy="fedadam"),
         dict(scenario="dropout", clients_axis="data", model_axis="tp"))
SELECTION = ("sel", "comp", "k_t", "n_available", "rates")
FEDADAM = 1                     # the cell whose stored blocks are counted


def _lstm_spec():
    """Shakespeare's fedadam cell, cut to 2 rounds of K = 4 clients with 8
    sentences each (the LSTM's widths as the task has them)."""
    sc = tsim.Scenario(name="homedevices", availability="homedevices",
                       task="shakespeare",
                       task_kwargs={"sentences_per_client": 8})
    return tsim.RunSpec(scenario=sc, strategy="fedadam", rounds=2,
                        clients_per_round=4, eval_every=2)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def _quiet(*args, **kwargs):
    pass


def _specs():
    return [tsim.RunSpec(rounds=ROUNDS, **kw) for kw in CELLS]


@pytest.fixture(scope="module")
def runs():
    """Every run of the file: the 4-rank spawn over the three splits and
    (4,), the 2-rank spawn over (2,), (1,) in this process, and JAX's
    device engine with its per-round JSONL."""
    specs = [s.to_json() for s in _specs()]
    lstm = _lstm_spec().to_json()
    shapes4 = list(SPLITS) + [(4,)]
    with one_intra_op_thread():
        four = spawn_ranks(
            workers.model_axis_runs, 4,
            [(js, shape) for shape in shapes4 for js in specs]
            + [(lstm, (2, 2))], (specs[FEDADAM], SPLITS), threads=1)
        two = spawn_ranks(workers.model_axis_runs, 2,
                          [(js, (2,)) for js in specs] + [(lstm, (2,))],
                          threads=1)[0]["runs"]
        one = [workers._result_np(tsim.run_spec(
            s.replace(mesh_shape=(1,)), device="cpu", log_fn=_quiet))
            for s in _specs()]
    got4 = four[0]["runs"]
    n = len(specs)
    out = {shape: got4[i * n:(i + 1) * n] for i, shape in enumerate(shapes4)}
    out.update({(2,): two[:n], (1,): one,
                "lstm": {(2, 2): got4[-1], (2,): two[-1]}})
    jax_runs = []
    for s in specs:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "m.jsonl")
            res = jsim.run_spec(jsim.RunSpec.from_json(s).replace(
                metrics_path=path), log_fn=_quiet)
            with open(path) as f:
                recs = [json.loads(line) for line in f]
        jax_runs.append(dict(
            sel=res.sel_history, comp=res.comp_history, rates=res.rates,
            **{k: np.asarray([r[k] for r in recs]) for k in (
                "k_t", "n_available", "train_loss", "delta_norm")}))
    return dict(torch=out, jax=jax_runs, ranks=four)


@pytest.mark.parametrize("shape", SPLITS)
def test_split_bitwise_jax_device_engine(shape, runs):
    for i, (got, want) in enumerate(zip(runs["torch"][shape],
                                        runs["jax"])):
        assert got["final"]["engine"] == "sharded"
        assert got["sel"].shape == want["sel"].shape == (ROUNDS, 100)
        for k in SELECTION:
            assert got[k].tobytes() == want[k].astype(
                got[k].dtype).tobytes(), (shape, CELLS[i], k)
        for k in ("train_loss", "delta_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                       err_msg=f"{shape} {CELLS[i]} {k}")


@pytest.mark.parametrize("shape,one_axis", [((2, 2), (2,)), ((1, 4), (1,))])
def test_split_params_bitwise_the_1d_run(shape, one_axis, runs):
    for i, (got, ref) in enumerate(zip(runs["torch"][shape],
                                       runs["torch"][one_axis])):
        assert len(got["params"]) == len(ref["params"]) == 2
        for a, b in zip(got["params"], ref["params"]):
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), \
                (shape, CELLS[i])
        for k in SELECTION:
            assert got[k].tobytes() == ref[k].tobytes(), (shape, k)
        np.testing.assert_allclose(got["delta_norm"], ref["delta_norm"],
                                   rtol=0, atol=TOL)


def test_lstm_split_past_dim_0_params_bitwise_the_1d_run(runs):
    """At m = 2 the rules split Shakespeare's ``out_w`` (256, 90) along
    dim 1 (the stacked ``lstm`` leaves stay whole); (2, 2) gathers and
    slices it there, and its final parameters are the (2,) run's bits."""
    from repro_torch import random as tr
    from repro_torch.sharding.rules import (model_dim, model_specs,
                                            specs_up_to)
    from repro_torch.sim.runner import build_task
    from repro_torch.tree import tree_leaves_with_path

    class Mesh:
        shape = {"clients": 2, "model": 2}

    init = build_task("shakespeare", 0, device="cpu",
                      sentences_per_client=8)[2]
    params = init(tr.PRNGKey(0, device="cpu"))
    specs = specs_up_to(params, model_specs(params, Mesh()))
    dims = {"/".join(map(str, path)): model_dim(spec, "model")
            for (path, _), spec in zip(tree_leaves_with_path(params), specs)}
    assert dims["out_w"] == 1 and dims["embed"] == 0
    assert all(d is None for p, d in dims.items() if p.startswith("lstm"))
    got, ref = runs["torch"]["lstm"][(2, 2)], runs["torch"]["lstm"][(2,)]
    assert got["final"]["engine"] == ref["final"]["engine"] == "sharded"
    assert len(got["params"]) == len(ref["params"]) == len(dims)
    for a, b in zip(got["params"], ref["params"]):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    for k in SELECTION:
        assert got[k].tobytes() == ref[k].tobytes(), k
    for k in ("train_loss", "delta_norm"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL)
    assert np.isfinite(got["train_loss"]).all()


def test_size_one_model_axis_is_the_1d_mesh(runs):
    for got, ref in zip(runs["torch"][(4, 1)], runs["torch"][(4,)]):
        for k in SELECTION + ("train_loss", "delta_norm"):
            assert got[k].tobytes() == ref[k].tobytes(), k
        for a, b in zip(got["params"], ref["params"]):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shape", SPLITS)
def test_each_rank_stores_its_blocks(shape, runs):
    """fedadam's carry: b (10,) replicated, w (60, 10) split over the
    model axis, and Adam's m and v alike; each leaf in a storage of its
    own size."""
    m = shape[1]
    want = [(10, 10), (600 // m, 600 // m)] * 3
    for rank in runs["ranks"]:
        assert rank["blocks"][shape] == want, shape


def test_clients_exchange_reaches_the_global_partner(runs):
    """At (2, 2) the clients axis of global rank r = 2 i + j is {j, 2 + j}:
    its partner is 2 (1 - i) + j."""
    got = [r["exchange"] for r in runs["ranks"]]
    assert got == [2, 3, 0, 1]


def test_sweep_and_run_spec_spawn_the_mesh(tmp_path, runs):
    from repro_torch.sim import sweep
    sweep.main(["--scenarios", "scarce", "--algorithms", "f3ast",
                "--mesh-shape", "2,2", "--rounds", "3", "--device", "cpu",
                "--out", str(tmp_path)])
    recs = [json.loads(line) for line in
            (tmp_path / "scarce__f3ast.jsonl").read_text().splitlines()]
    want = runs["torch"][(2, 2)][0]
    assert [r["k_t"] for r in recs] == want["k_t"][:3].tolist()
    assert [r["n_selected"] for r in recs] == \
        want["sel"][:3].sum(1).tolist()
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["scarce|f3ast"]["engine"] == "sharded"
