"""The port's client-sharded engine (``repro_torch.sim.engine_sharded``)
against the JAX package's single-device results, as the JAX package's own
``tests/test_engine_sharded.py`` holds its sharded engine to its
single-device one.

* ``sharded_topk_mask`` (both methods) and ``sharded_cohort_ids_from_mask``
  at 2, 3 and 4 gloo ranks, with tied scores and under-full masks, bitwise
  JAX's ``_topk_mask`` and ``cohort_ids_from_mask``;
* ``run_spec(RunSpec(mesh_shape=(d,)), device="cpu")`` on the staged
  ``synthetic11`` cells at d = 2 (butterfly) and 3 (ring): f3ast under
  both ``topk_impl``s, the blockwise availability (``bernoulli``), a state
  with the client dimension (``gilbert_elliott``), a full-width score
  (``fedavg``), a completion hook (``dropout``) and another chunk size —
  masks, K_t, |avail| and r_k bitwise JAX's device engine, losses within
  1e-5;
* ``selection_comm_bytes_per_round`` equal to JAX's formula, JAX's errors,
  the (clients, model) mesh resolving (what is left of queue 1 item 11
  raising naming it), and NCCL with more ranks than cards raising.

Each world size is one spawn of its ranks (each rank one intra-op
thread), running all of its cells.  The engine on a ``SynthTask`` and
``run_spec``'s own spawn are in ``test_torch_engine_sharded_synth.py``."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.sim as jsim
from repro.core.selection import _topk_mask, cohort_ids_from_mask
from repro.sim.engine_sharded import _selection_comm_bytes as jax_comm
import jax.numpy as jnp
import repro_torch.sim as tsim
from repro_torch.launch.mesh import ClientMesh, make_fed_mesh, spawn_ranks
from repro_torch.sim import engine_sharded, runner

import torch_dist_workers as workers
from torch_parity import one_intra_op_thread

ROUNDS, TOL = 20, 1e-5
SELECTION = ("sel", "comp", "k_t", "n_available", "rates")


@pytest.fixture(autouse=True)
def _one_thread():
    """Test workers share the cores: one intra-op thread a test."""
    with one_intra_op_thread():
        yield


def _quiet(*args, **kwargs):
    pass


def _assert_bitwise_jax(spec, got, jres):
    name = f"{spec.scenario}/{spec.strategy}/{spec.topk_impl}"
    assert got["final"]["engine"] == "sharded", name
    assert got["sel"].tobytes() == jres.sel_history.tobytes(), name
    assert got["comp"].tobytes() == jres.comp_history.tobytes(), name
    assert got["rates"].tobytes() == jres.rates.tobytes(), name
    assert got["sel"].shape == jres.sel_history.shape
    assert got["final"]["test_loss"] == pytest.approx(
        jres.final_metrics["test_loss"], abs=TOL)


def _jax_streams(spec, path):
    """JAX's run with its per-round JSONL (K_t, |avail|, losses)."""
    res = jsim.run_spec(jsim.RunSpec.from_json(
        spec.replace(metrics_path=str(path)).to_json()), log_fn=_quiet)
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return res, {k: np.asarray([r[k] for r in recs]) for k in (
        "k_t", "n_available", "train_loss", "delta_norm")}


def _check_cells(specs, got, tmp_path):
    for i, (spec, g) in enumerate(zip(specs, got)):
        jres, streams = _jax_streams(spec, tmp_path / f"j{i}.jsonl")
        _assert_bitwise_jax(spec, g, jres)
        for k in ("k_t", "n_available"):
            np.testing.assert_array_equal(g[k], streams[k], err_msg=k)
        for k in ("train_loss", "delta_norm"):
            np.testing.assert_allclose(g[k], streams[k], rtol=0, atol=TOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# The distributed cut and cohort ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 3, 4])
def test_sharded_topk_and_cohort_ids_match_single_device(shards):
    n, k_max, cohort = 24 * shards, 7, 6
    rng = np.random.default_rng(shards)
    cases = []
    for _ in range(12):
        # coarse integer scores: plenty of exact ties
        scores = rng.integers(0, 5, n).astype(np.float32)
        avail = rng.random(n) < 0.4
        avail[rng.integers(n)] = True
        mask = rng.random(n) < 0.15
        cases.append((scores, avail, int(rng.integers(1, k_max + 1)), mask))
    scores = rng.integers(0, 3, n).astype(np.float32)
    sparse = np.zeros(n, bool)
    sparse[rng.choice(n, size=k_max - 2, replace=False)] = True
    under = np.zeros(n, bool)
    under[[3, n - 2]] = True                     # under-full cohort
    cases += [(scores, rng.random(n) < 0.3, 0, under),           # k = 0
              (scores, sparse, k_max, sparse),                   # k > |avail|
              (scores, np.zeros(n, bool), k_max, np.zeros(n, bool))]
    got = spawn_ranks(workers.topk_cases, shards, cases, k_max, cohort,
                      threads=1)
    for rank_rows in got:
        for (scores, avail, k, mask), row in zip(cases, rank_rows):
            want = np.asarray(_topk_mask(jnp.asarray(scores),
                                         jnp.asarray(avail),
                                         jnp.asarray(np.int32(k))))
            want_ids, want_valid = map(np.asarray, cohort_ids_from_mask(
                jnp.asarray(mask), cohort))
            for method in ("stream", "allgather"):
                np.testing.assert_array_equal(row[f"topk_{method}"], want)
                ids, valid = row[f"ids_{method}"]
                np.testing.assert_array_equal(ids, want_ids)
                np.testing.assert_array_equal(valid, want_valid)


# ---------------------------------------------------------------------------
# The engine through run_spec's rank body, against JAX's device engine
# ---------------------------------------------------------------------------

def _specs(cells):
    return [tsim.RunSpec(rounds=ROUNDS, **kw) for kw in cells]


CELLS = {
    2: [dict(), dict(topk_impl="allgather"), dict(scenario="bernoulli"),
        dict(strategy="fedavg"), dict(scenario="dropout")],
    3: [dict(), dict(topk_impl="allgather", scenario="bernoulli"),
        dict(scenario="gilbert_elliott"), dict(strategy="fedavg",
                                               scenario="bernoulli")],
}


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_run_spec_cells_bitwise_jax(shards, tmp_path):
    """Each cell on ``shards`` ranks, and the first cell again with chunks
    of 3 rounds (chunk-size independence)."""
    specs = _specs(CELLS[shards])
    specs = [s.replace(mesh_shape=(shards,)) for s in specs]
    got = spawn_ranks(workers.run_specs, shards,
                      [s.to_json() for s in specs + specs[:1]],
                      [None] * len(specs) + [3], threads=1)[0]
    _check_cells([s.replace(mesh_shape=None) for s in specs], got[:-1],
                 tmp_path)
    for k in SELECTION:
        assert got[-1][k].tobytes() == got[0][k].tobytes(), k
    np.testing.assert_allclose(got[-1]["train_loss"], got[0]["train_loss"],
                               rtol=0, atol=TOL)
    n_pad = -(-100 // (32 * shards)) * 32 * shards
    assert got[0]["final"]["selection_comm_bytes_per_round"] == jax_comm(
        d=shards, nl=n_pad // shards, k=10, topk_impl="stream", gathers=1)


# ---------------------------------------------------------------------------
# The formula, the errors
# ---------------------------------------------------------------------------

def test_selection_comm_bytes_equal_jax_formula():
    for d in (1, 2, 3, 4, 5, 8):
        for nl in (32, 64, 96, 31250, 100):
            for k in (1, 10, 100):
                for impl in ("stream", "allgather"):
                    for gathers in (1, 2):
                        kw = dict(d=d, nl=nl, k=k, topk_impl=impl,
                                  gathers=gathers)
                        assert engine_sharded._selection_comm_bytes(**kw) \
                            == jax_comm(**kw), kw


def test_jax_errors_are_kept():
    from repro_torch.sim.engine import build_engine
    with pytest.raises(ValueError, match="parallel"):
        build_engine("scarce", "f3ast", device="cpu", fed_mode="sequential",
                     mesh=ClientMesh())
    with pytest.raises(ValueError, match="pallas"):
        build_engine("scarce", "f3ast", device="cpu", select_impl="pallas",
                     mesh=ClientMesh())
    for sim, kw in ((jsim, {}), (tsim, dict(device="cpu"))):
        with pytest.raises(ValueError, match="host"):
            sim.run_spec(sim.RunSpec(rounds=2, engine="host",
                                     mesh_shape=(2,)), log_fn=_quiet, **kw)


def test_two_axis_mesh_raises_naming_item_11(tmp_path):
    """The (clients, model) mesh is ported (item 11's engine half): a 2-D
    spec resolves, a mesh of one rank has both axes and the sweep parses
    ``C,M``; a 2-D mesh of several ranks needs their process group (the
    runs are ``test_torch_engine_model_axis.py``'s).  The step builders'
    meshes are ported for serving: on one process the debug mesh is
    (1, 1) over ("data", "model") and the production meshes raise
    ``ValueError`` naming the ranks they need, as JAX's do.  What is left
    of item 11 raises naming it: the training program over a mesh and the
    families other than the dense one."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.sim import sweep
    assert tsim.RunSpec(mesh_shape=(2, 2)).resolved().mesh_shape == (2, 2)
    assert sweep._parse_mesh_shape("2,2") == (2, 2)
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        make_fed_mesh((2, 2))
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        engine_sharded.resolve_client_mesh((1, 2))
    one = engine_sharded.resolve_client_mesh((1, 1))
    assert one.axis_names == ("clients", "model") and one.size == 1
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    debug = tmesh.make_debug_mesh()
    assert debug.axis_names == ("data", "model") and debug.size == 1
    assert tmesh.data_axes(debug) == ("data",)
    assert tmesh.data_axes(one) == ()
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            tmesh.make_production_mesh(multi_pod=multi_pod)
    for fn in (lambda: steps.build_train_step(get_arch("llama3.2-1b"),
                                              "train_4k", debug),
               lambda: steps.build_prefill_step(get_arch("mixtral-8x22b"),
                                                "prefill_32k", debug)):
        with pytest.raises(NotImplementedError, match="item 11"):
            fn()
    assert not list(tmp_path.iterdir())
    assert engine_sharded.resolve_client_mesh((1,)) == ClientMesh()


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rs = tsim.RunSpec(rounds=1, mesh_shape=(2,)).resolved()
    with pytest.raises(RuntimeError, match='dist_backend="gloo"'):
        runner._run_sharded(rs, "f3ast", torch.device("cuda"), _quiet, None)
