"""The port's buffered asynchronous server (``repro_torch.sim.engine_async``),
mirroring ``tests/test_engine_async.py``: the pool primitives bitwise JAX's
on random pools with tied times and ids and at overflow; the staleness
discounts bitwise jitted JAX over s in [0, 100,000] (with a pin of where
JAX's own eager executor parts from its jitted one); both executors held
to their JAX counterparts and to each other — selection masks and every
``async_history`` field bitwise, weights included; and the spec's and the
cell construction's validation errors."""
import json
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.sim as jsim
import repro.sim.engine_async as jasync
import repro_torch.sim as tsim
import repro_torch.sim.engine_async as tasync
from torch_parity import one_intra_op_thread

ROUNDS = 12
ASYNC_FIELDS = ("buf_ids", "buf_valid", "buf_staleness", "buf_weights",
                "n_buffered", "mean_staleness", "n_overflow")
CELLS = {
    "scarce": dict(scenario="scarce"),                    # unit latency
    "scarce+deadline": dict(scenario="scarce", completion="deadline"),
    "stepk": dict(scenario="stepk"),                      # time-varying K_t
    # buffer 1 drains one arrival a step while ~10 arrive: the pool
    # overflows; and the exponential discount
    "overflow+exponential": dict(scenario="scarce", completion="deadline",
                                 buffer_size=1,
                                 staleness_discount="exponential",
                                 staleness_power=0.3),
    "power1": dict(scenario="scarce", completion="deadline",
                   staleness_power=1.0),
}
# the cells held to JAX's host executor too (the others to its device one)
BOTH = ("scarce", "scarce+deadline", "stepk")
PAIRS = [(c, "device") for c in CELLS] + [(c, "host") for c in BOTH]


def _quiet(*args, **kwargs):
    pass


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each cell through both executors of both packages, on the CPU."""
    out = tmp_path_factory.mktemp("async")
    res = {}
    with one_intra_op_thread():
        for name, kw in CELLS.items():
            kw = {"rounds": ROUNDS, **kw}
            for engine in ("device", "host"):
                spec = jsim.RunSpec(aggregation="buffered", engine=engine,
                                    eval_every=5, **kw)
                if (name, engine) not in PAIRS:
                    t = tsim.run_spec(tsim.RunSpec.from_json(spec.to_json()),
                                      device="cpu", log_fn=_quiet)
                    res[name, engine] = (None, t, None, None)
                    continue
                j = jsim.run_spec(spec.replace(
                    metrics_path=str(out / f"{name}_{engine}_j.jsonl")),
                    log_fn=_quiet)
                t = tsim.run_spec(tsim.RunSpec.from_json(spec.to_json())
                                  .replace(metrics_path=str(
                                      out / f"{name}_{engine}_t.jsonl")),
                                  device="cpu", log_fn=_quiet)
                res[name, engine] = (j, t,
                                     _jsonl(out / f"{name}_{engine}_j.jsonl"),
                                     _jsonl(out / f"{name}_{engine}_t.jsonl"))
    return res


def _assert_bitwise(a, b, *, rates=True):
    assert a.sel_history.tobytes() == b.sel_history.tobytes()
    assert a.comp_history.tobytes() == b.comp_history.tobytes()
    for f in ASYNC_FIELDS:
        x, y = np.asarray(a.async_history[f]), np.asarray(b.async_history[f])
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    if rates:
        assert a.rates.tobytes() == b.rates.tobytes()


@pytest.mark.parametrize("cell,engine", PAIRS)
def test_executor_matches_its_jax_counterpart(runs, cell, engine):
    """Masks and every async_history field bitwise JAX's same executor;
    r_k bitwise on the device executor, within 1e-6 on the host one (JAX
    runs its EMA op by op there); losses within 1e-5."""
    j, t, jl, tl = runs[cell, engine]
    assert t.final_metrics["engine"] == engine
    assert t.final_metrics["aggregation"] == "buffered"
    _assert_bitwise(j, t, rates=engine == "device")
    np.testing.assert_allclose(t.rates, j.rates, rtol=0, atol=1e-6)
    assert [sorted(r) for r in tl] == [sorted(r) for r in jl]
    for key in ("round", "k_t", "n_available", "n_selected", "n_buffered",
                "mean_staleness", "n_overflow"):
        assert [r[key] for r in tl] == [r[key] for r in jl], key
    np.testing.assert_allclose([r["train_loss"] for r in tl],
                               [r["train_loss"] for r in jl], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_two_executors_agree_bitwise(runs, cell):
    """The port's host and device executors: masks, async_history, r_k and
    the streams bitwise — one arithmetic, one discount spelling."""
    dev, host = runs[cell, "device"][1], runs[cell, "host"][1]
    _assert_bitwise(dev, host)
    for name in ("k_t", "n_available"):
        assert getattr(dev, name).tobytes() == getattr(host, name).tobytes()
    np.testing.assert_allclose(dev.train_loss, host.train_loss, rtol=0,
                               atol=1e-5)
    ah = dev.async_history
    assert (ah["n_buffered"] == ah["buf_valid"].sum(axis=1)).all()
    sums = ah["buf_weights"].sum(axis=1)
    occupied = ah["n_buffered"] > 0
    np.testing.assert_allclose(sums[occupied], 1.0, atol=1e-6)
    np.testing.assert_array_equal(sums[~occupied], 0.0)
    if cell == "overflow+exponential":
        assert ah["n_overflow"].sum() > 0 and (ah["n_buffered"] <= 1).all()


def _mk(rows, n_clients, pad_to):
    rows = list(rows) + [(np.inf, n_clients, 0, False)] * (pad_to - len(rows))
    t, c, r, v = (np.asarray(x) for x in zip(*rows))
    return (jasync.ArrivalPool(time=jnp.asarray(t, jnp.float32),
                               cid=jnp.asarray(c, jnp.int32),
                               round=jnp.asarray(r, jnp.int32),
                               valid=jnp.asarray(v, bool)),
            tasync.ArrivalPool(time=torch.from_numpy(t.astype(np.float32)),
                               cid=torch.from_numpy(c.astype(np.int32)),
                               round=torch.from_numpy(r.astype(np.int32)),
                               valid=torch.from_numpy(v.astype(bool))))


def _same(jpool, tpool):
    for a, b in zip(jpool, tpool):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.tobytes() == \
            b.numpy().tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_insert_and_flush_bitwise_jax(seed):
    """Random pools of heavily tied times, ids and rounds, capacity 7 (so
    many inserts overflow): insert and flush bitwise jitted JAX's."""
    rng = np.random.default_rng(seed)
    n, cap = 9, 7
    overflowed = 0
    jinsert = jax.jit(jasync.pool_insert)
    jflush = jax.jit(jasync.pool_flush, static_argnums=(1, 3))
    for trial in range(40):
        k_old, k_new = int(rng.integers(0, cap + 1)), int(rng.integers(1, 6))

        def rows(k):
            return [(float(rng.integers(0, 3)), int(rng.integers(0, n)),
                     int(rng.integers(0, 3)), True) for _ in range(k)]

        jpool, tpool = _mk(sorted(rows(k_old)), n, cap)
        jnew, tnew = _mk(rows(k_new), n, k_new)
        (jgot, jover), (tgot, tover) = (jinsert(jpool, jnew),
                                        tasync.pool_insert(tpool, tnew))
        _same(jgot, tgot)
        assert int(jover) == int(tover)
        overflowed += int(tover) > 0
        m, t = int(rng.integers(1, 5)), int(rng.integers(3, 8))
        jout = jflush(jgot, m, t, n)
        tout = tasync.pool_flush(tgot, m, t, n)
        _same(jout[0], tout[0])
        for a, b in zip(jout[1:], tout[1:]):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert overflowed > 0


def test_pool_edges_as_jax():
    n = 11
    pool = tasync.empty_pool(6, n)
    assert torch.isinf(pool.time).all() and (pool.cid == n).all()
    rest, ids, valid, stale = tasync.pool_flush(pool, 3, 2, n)
    assert ids.tolist() == [n - 1] * 3 and not valid.any()
    assert stale.tolist() == [0, 0, 0]
    _, tpool = _mk([(1.0, 4, 0, True), (2.0, 7, 1, True)], n, 8)
    rest, ids, valid, stale = tasync.pool_flush(tpool, 4, 5, n)
    assert ids.tolist() == [4, 7, 4, 4]
    assert stale.tolist() == [5, 4, 0, 0] and not rest.valid.any()
    assert tasync.default_pool_slots(5, 10) == 45
    assert tasync.default_pool_slots(1, 1) == 5


S = np.arange(100_001, dtype=np.float32)


@pytest.mark.parametrize("discount,power", [
    ("polynomial", 0.3), ("polynomial", 0.5), ("polynomial", 1.0),
    ("polynomial", 2.0), ("exponential", 0.3), ("exponential", 1.0)])
def test_discounts_bitwise_jitted_jax(discount, power):
    """Each discount over s in [0, 100,000] bitwise ``jax.jit`` of JAX's
    (the power a constant, as in JAX's device executor); and the
    normalised weights of random buffers of M <= 16 slots bitwise jitted
    ``staleness_weights`` (the sum left to right)."""
    jfn, tfn = (jasync.STALENESS_DISCOUNTS[discount],
                tasync.STALENESS_DISCOUNTS[discount])
    want = np.asarray(jax.jit(lambda s: jfn(s, power))(S))
    got = tfn(torch.from_numpy(S), power).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    rng = np.random.default_rng(int(power * 10))
    jw = jax.jit(lambda s, v: jasync.staleness_weights(s, v, power,
                                                       discount))
    for _ in range(50):
        m = int(rng.integers(1, 17))
        stale = rng.integers(0, 100_001, m).astype(np.int32)
        valid = rng.random(m) < 0.8
        a = np.asarray(jw(stale, valid))
        b = tasync.staleness_weights(torch.from_numpy(stale),
                                     torch.from_numpy(valid), power,
                                     discount).numpy()
        assert a.tobytes() == b.tobytes(), (stale, valid)


def test_jax_eager_discount_parts_from_jitted_at_power_one():
    """At p = 1.0 jit rewrites ``x ** -1.0`` into ``1 / x`` while JAX's
    eager host executor calls ``powf``: over s in [0, 100,000] they part
    in 55 values, first at s = 952 (jax 0.9.0, XLA:CPU), none below it.
    The port has the jitted spelling on both executors; at p = 0.5 and 2
    JAX's two agree."""
    fn = jasync.STALENESS_DISCOUNTS["polynomial"]
    jit = np.asarray(jax.jit(lambda s: fn(s, 1.0))(S))
    eager = np.asarray(fn(jnp.asarray(S), 1.0))
    differ = np.flatnonzero(jit != eager)
    assert len(differ) == 55 and differ[0] == 952
    got = tasync.STALENESS_DISCOUNTS["polynomial"](torch.from_numpy(S), 1.0)
    assert got.numpy().tobytes() == jit.tobytes()
    for p in (0.5, 2.0):
        assert np.asarray(jax.jit(lambda s: fn(s, p))(S)).tobytes() == \
            np.asarray(fn(jnp.asarray(S), p)).tobytes()


def test_staleness_weights_semantics():
    w = tasync.staleness_weights([0, 2, 5, 9], [True, True, False, True],
                                 power=0.5).numpy()
    assert w[2] == 0.0 and abs(w.sum() - 1.0) <= 1e-6
    assert w[0] > w[1] > w[3]
    assert (tasync.staleness_weights([0, 0, 0], [False] * 3, 0.5).numpy()
            == 0).all()
    with pytest.raises(KeyError, match="nope.*known"):
        tasync.staleness_weights([0], [True], power=0.5, discount="nope")


@pytest.mark.parametrize("overrides,exc,match", [
    (dict(aggregation="bogus"), ValueError, "aggregation"),
    (dict(aggregation="buffered", buffer_size=0), ValueError, "buffer_size"),
    (dict(aggregation="buffered", staleness_power=-1.0), ValueError,
     "staleness_power"),
    (dict(aggregation="buffered", staleness_discount="nope"), KeyError,
     "staleness discount"),
    (dict(aggregation="buffered", mesh_shape=(0,)), ValueError,
     "client-sharded")])
def test_spec_rejects_bad_async_fields_as_jax(overrides, exc, match):
    for sim in (jsim, tsim):
        with pytest.raises(exc, match=match):
            sim.RunSpec(**overrides).resolved()


def test_cell_construction_rejects_as_jax():
    """A host-only strategy, a completion process without latencies and an
    unknown executor fail before anything runs, as in JAX."""
    for kw, match in ((dict(strategy="poc"), "host-only"),
                      (dict(completion="bernoulli"), "latency-capable")):
        spec = tsim.RunSpec(rounds=2, aggregation="buffered", **kw)
        with pytest.raises(ValueError, match=match):
            jsim.run_spec(jsim.RunSpec.from_json(spec.to_json()),
                          log_fn=_quiet)
        with pytest.raises(ValueError, match=match):
            tsim.run_spec(spec, device="cpu", log_fn=_quiet)
    with pytest.raises(ValueError, match="engine"):
        tasync.run_scenario_buffered("scarce", "f3ast", device="cpu",
                                     rounds=2, engine="sharded")


def test_registered_discount_plugs_into_a_run():
    tsim.register_staleness_discount("unit_test_flat",
                                     lambda s, p: s * 0.0 + 1.0)
    try:
        res = tsim.run_spec(tsim.RunSpec(
            rounds=6, aggregation="buffered",
            staleness_discount="unit_test_flat"), device="cpu",
            log_fn=_quiet)
    finally:
        del tsim.STALENESS_DISCOUNTS["unit_test_flat"]
    ah = res.async_history
    row = int(np.argmax(ah["n_buffered"] > 1))
    k = int(ah["n_buffered"][row])
    np.testing.assert_allclose(ah["buf_weights"][row][ah["buf_valid"][row]],
                               np.full(k, 1.0 / k), atol=1e-6)


def test_sweep_aggregation_axis_as_jax(tmp_path):
    """The sweep's ``--aggregations`` and ``--engine`` axes write JAX's
    layout, the buffered cells' records with the async fields."""
    args = ["--scenarios", "scarce", "--algorithms", "f3ast",
            "--aggregations", "sync,buffered", "--engine", "host",
            "--rounds", "3"]
    from repro.sim import sweep as jsweep
    from repro_torch.sim import sweep as tsweep
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsweep.main(args + ["--out", str(tmp_path / "jax")])
        tsweep.main(args + ["--out", str(tmp_path / "torch"), "--device",
                            "cpu"])
    import os
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "torch"))
    ts = json.loads((tmp_path / "torch" / "summary.json").read_text())
    assert set(ts) == {"scarce|f3ast|sync", "scarce|f3ast|buffered"}
    assert ts["scarce|f3ast|buffered"]["engine"] == "host"
    recs = _jsonl(tmp_path / "torch" / "scarce__f3ast__buffered.jsonl")
    jrecs = _jsonl(tmp_path / "jax" / "scarce__f3ast__buffered.jsonl")
    assert [sorted(r) for r in recs] == [sorted(r) for r in jrecs]
    for key in ("n_buffered", "mean_staleness", "n_overflow", "k_t"):
        assert [r[key] for r in recs] == [r[key] for r in jrecs], key
