"""The port's public core and sim API against the JAX package's.

``tools/api_surface.json`` is the JAX package's manifest of ``repro.core``
(58 names) and ``repro.sim`` (47); it is read here, never written.  Each
name must import from ``repro_torch.core`` / ``repro_torch.sim``, be of
the manifest's kind, and take the manifest's parameters, up to one added
``device`` keyword after the named parameters (None: CUDA).

Beside it, the port's side of ``tests/test_hfun.py``,
``tests/test_selection.py`` and ``tests/test_rates_aggregation.py`` for the
functions of the API that nothing else in the port calls, against the JAX
package on the same numpy inputs:
* ``f3ast_select``, ``fixed_policy_select`` and ``empirical_rate``
  bitwise (masks and a float32 mean of 0/1 values, whose sum is exact);
* ``h_value`` within 1e-6 relative (a float32 sum, whose order XLA:CPU
  does not fix) and ``weighted_aggregate`` within 1e-6 (float32 sums).
"""
import importlib
import importlib.util
import inspect
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.launch.mesh import ClientMesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "tools" / "api_surface.json").read_text())
PORT = {"repro.core": tcore, "repro.sim": tsim}
CASES = [(mod, name) for mod in sorted(MANIFEST)
         for name in sorted(MANIFEST[mod])]


def _surface_tool():
    """``tools/check_api_surface.py``, the manifest's own reader of
    signatures (imported from its path, not run)."""
    spec = importlib.util.spec_from_file_location(
        "check_api_surface", ROOT / "tools" / "check_api_surface.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _surface_tool()


def _kind(obj) -> str:
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "function"
    return type(obj).__name__


def _without_device(shape: str) -> str:
    """A signature shape less a ``device=?`` parameter, and less a ``*``
    that no keyword-only parameter follows any more."""
    parts = [p for p in shape[1:-1].split(", ") if p and p != "device=?"]
    if parts and parts[-1] == "*":
        parts.pop()
    if len(parts) >= 2 and parts[-2] == "*" and parts[-1].startswith("**"):
        del parts[-2]
    return "(" + ", ".join(parts) + ")"


def test_manifest_lists_105_names():
    assert {m: len(v) for m, v in MANIFEST.items()} == {"repro.core": 58,
                                                        "repro.sim": 47}


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m}.{n}" for m, n in CASES])
def test_name_imports_with_its_kind_and_signature(mod, name):
    entry = MANIFEST[mod][name]
    obj = getattr(importlib.import_module(PORT[mod].__name__), name)
    assert _kind(obj) == entry["kind"]
    if "signature" in entry:
        port = TOOL.signature_shape(obj)
        if "device=?" in port:
            # the one parameter the port may add: the last named one
            named = [p for p in port[1:-1].split(", ")
                     if p != "*" and not p.startswith("**")]
            assert named[-1] == "device=?", port
        assert _without_device(port) == entry["signature"]


def test_without_device_drops_only_the_added_keyword():
    assert _without_device("(a, b=?, *, device=?)") == "(a, b=?)"
    assert _without_device("(a, *, device=?, **kw)") == "(a, **kw)"
    assert _without_device("(a, device=?, **kw)") == "(a, **kw)"
    assert _without_device("(*, a, device=?)") == "(*, a)"
    assert _without_device("(a, *, b=?)") == "(a, *, b=?)"


# ---------------------------------------------------------------------------
# hfun: H(r), Eq. 3
# ---------------------------------------------------------------------------


def _problem(n, seed, ties=False):
    """(avail, k, p, r) as numpy: p on the simplex, r in [2·R_MIN, 1]; with
    ``ties`` p uniform and r from three values, so utilities tie in
    groups."""
    rng = np.random.default_rng(seed)
    avail = rng.random(n) < 0.6
    avail[rng.integers(n)] = True
    k = int(rng.integers(1, n + 1))
    if ties:
        p = np.full(n, 1.0 / n, np.float32)
        r = rng.choice(np.asarray([0.05, 0.2, 0.5], np.float32), n)
    else:
        p = rng.dirichlet(np.ones(n)).astype(np.float32)
        r = rng.uniform(2e-3, 1.0, n).astype(np.float32)
    return avail, k, p, r.astype(np.float32)


@pytest.mark.parametrize("n", [7, 100, 1000])
@pytest.mark.parametrize("pos_corr", [False, True])
def test_h_value_within_1e6_of_jax(n, pos_corr):
    _, _, p, r = _problem(n, n)
    r[: n // 10] = 1e-4                       # below R_MIN: clipped
    want = float(jax.jit(jcore.h_value, static_argnums=2)(
        jnp.asarray(r), jnp.asarray(p), pos_corr))
    got = tcore.h_value(torch.from_numpy(r), torch.from_numpy(p), pos_corr)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * abs(want)


def test_h_value_variants():
    p, r = torch.tensor([0.5, 0.5]), torch.tensor([0.5, 0.25])
    assert float(tcore.h_value(r, p, True)) == 1.0 + 2.0      # p / r
    assert float(tcore.h_value(r, p, False)) == 0.5 + 1.0     # p² / r


@pytest.mark.parametrize("pos_corr", [False, True])
def test_h_grad_is_the_gradient_of_h_value(pos_corr):
    for n in range(2, 13):
        _, _, p, r = _problem(n, 100 + n)
        pt = torch.from_numpy(p)
        auto = torch.func.grad(
            lambda rr: tcore.h_value(rr, pt, pos_corr))(torch.from_numpy(r))
        closed = tcore.h_grad(torch.from_numpy(r), pt, pos_corr)
        np.testing.assert_allclose(closed.numpy(), auto.numpy(), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# selection: Alg. 1 line 4, Alg. 2
# ---------------------------------------------------------------------------

_J_F3AST = jax.jit(jcore.f3ast_select, static_argnums=4)
_J_FIXED = jax.jit(jcore.fixed_policy_select, static_argnums=4)


@pytest.mark.parametrize("n", [7, 100, 1000])
@pytest.mark.parametrize("with_key", [False, True], ids=["nokey", "key"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
def test_f3ast_select_bitwise_jitted_jax(n, with_key, ties):
    for seed in range(3):
        avail, k, p, r = _problem(n, 10 * n + seed, ties=ties)
        jkey = jax.random.PRNGKey(seed) if with_key else None
        tkey = jr.PRNGKey(seed, device="cpu") if with_key else None
        for pos_corr in (False, True):
            want = np.asarray(_J_F3AST(jnp.asarray(avail), jnp.asarray(k),
                                       jnp.asarray(p), jnp.asarray(r),
                                       pos_corr, jkey))
            got = tcore.f3ast_select(torch.from_numpy(avail), k,
                                     torch.from_numpy(p),
                                     torch.from_numpy(r), pos_corr, tkey)
            assert got.dtype == torch.bool
            assert got.numpy().tobytes() == want.tobytes()
            assert got.sum() == min(k, avail.sum())
            assert not (got.numpy() & ~avail).any()


@pytest.mark.parametrize("n", [7, 100, 1000])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
def test_fixed_policy_select_bitwise_jitted_jax(n, ties):
    for seed in range(3):
        avail, k, p, r = _problem(n, 20 * n + seed, ties=ties)
        for pos_corr in (False, True):
            want = np.asarray(_J_FIXED(jnp.asarray(avail), jnp.asarray(k),
                                       jnp.asarray(p), jnp.asarray(r),
                                       pos_corr))
            got = tcore.fixed_policy_select(
                torch.from_numpy(avail), k, torch.from_numpy(p),
                torch.from_numpy(r), pos_corr)
            assert got.numpy().tobytes() == want.tobytes()


def test_f3ast_greedy_is_argmax_over_feasible_sets():
    """Eq. 4: the greedy top-K is the brute-force argmax of −∇H(r)·1_S,
    since the objective is additive (exhaustive at small N)."""
    for seed in range(20):
        avail, k, p, r = _problem(10, 1000 + seed)
        mask = tcore.f3ast_select(torch.from_numpy(avail), k,
                                  torch.from_numpy(p),
                                  torch.from_numpy(r)).numpy()
        util = tcore.marginal_utility(torch.from_numpy(r),
                                      torch.from_numpy(p), False).numpy()
        ids = np.flatnonzero(avail)
        best = max(util[list(s)].sum()
                   for s in itertools.combinations(ids, min(k, len(ids))))
        assert util[mask].sum() >= best - 1e-5


def test_f3ast_key_breaks_a_full_tie_away_from_low_ids():
    """Every utility equal: without a key the cut takes the lowest ids,
    with one it takes JAX's random K."""
    n, k = 100, 10
    avail = np.ones(n, bool)
    p, r = np.full(n, 0.01, np.float32), np.full(n, 0.1, np.float32)
    plain = tcore.f3ast_select(torch.from_numpy(avail), k,
                               torch.from_numpy(p), torch.from_numpy(r))
    assert np.flatnonzero(plain.numpy()).tolist() == list(range(k))
    keyed = tcore.f3ast_select(torch.from_numpy(avail), k,
                               torch.from_numpy(p), torch.from_numpy(r),
                               key=jr.PRNGKey(4, device="cpu"))
    want = np.asarray(_J_F3AST(jnp.asarray(avail), jnp.asarray(k),
                               jnp.asarray(p), jnp.asarray(r), False,
                               jax.random.PRNGKey(4)))
    assert keyed.numpy().tobytes() == want.tobytes()
    assert np.flatnonzero(want).tolist() != list(range(k))


# ---------------------------------------------------------------------------
# rates and aggregation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 3, 7, 49, 300, 1000])
def test_empirical_rate_bitwise_jax(t):
    hist = np.random.default_rng(t).random((t, 257)) < 0.3
    got = tcore.empirical_rate(torch.from_numpy(hist))
    assert got.dtype == torch.float32
    for fn in (jcore.empirical_rate, jax.jit(jcore.empirical_rate)):
        want = np.asarray(fn(jnp.asarray(hist)))
        assert got.numpy().tobytes() == want.tobytes()


def test_empirical_rate_small_history():
    hist = torch.tensor([[1, 0], [1, 1], [0, 1], [1, 0]], dtype=torch.bool)
    assert tcore.empirical_rate(hist).tolist() == [0.75, 0.5]


def _tree(rng, k):
    """A nested tree of float32 and bfloat16 (K, ...) leaves, as numpy
    float32 values (the bf16 ones exactly representable)."""
    def bf16(shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()
    return {"dense": {"w": rng.normal(size=(k, 6, 5)).astype(np.float32),
                      "b": bf16((k, 5))},
            "blocks": [{"scale": bf16((k, 3, 4))},
                       {"scale": rng.normal(size=(k, 7)).astype(np.float32)}]}


BF16_LEAVES = {("dense", "b"), ("blocks", 0, "scale")}


def _cast(tree, path, to_leaf):
    if isinstance(tree, dict):
        return {n: _cast(v, path + (n,), to_leaf) for n, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, path + (i,), to_leaf) for i, v in enumerate(tree)]
    return to_leaf(tree, path in BF16_LEAVES)


def _leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("k", [1, 4, 10])
def test_weighted_aggregate_within_1e6_of_jax(k):
    rng = np.random.default_rng(k)
    tree = _tree(rng, k)
    w = rng.uniform(0, 1, k).astype(np.float32)
    jt = _cast(tree, (), lambda x, b: jnp.asarray(
        x, jnp.bfloat16 if b else jnp.float32))
    tt = _cast(tree, (), lambda x, b: torch.from_numpy(x).to(
        torch.bfloat16 if b else torch.float32))
    want = jax.jit(jcore.weighted_aggregate)(jt, jnp.asarray(w))
    got = tcore.weighted_aggregate(tt, torch.from_numpy(w))
    assert tcore.weighted_aggregate is tcore.aggregation.weighted_aggregate
    for g, x in zip(_leaves(got), _leaves(want)):
        assert g.dtype == (torch.bfloat16 if x.dtype == jnp.bfloat16
                           else torch.float32)
        assert tuple(g.shape) == x.shape
        err = np.abs(g.float().numpy() - np.asarray(x, np.float32)).max()
        assert err <= 1e-6


def test_weighted_aggregate_matches_numpy():
    for k, d in itertools.product((2, 5, 10), (1, 3, 5)):
        rng = np.random.default_rng(k * 100 + d)
        deltas = {"a": rng.normal(size=(k, d)).astype(np.float32),
                  "b": rng.normal(size=(k, d, 2)).astype(np.float32)}
        w = rng.uniform(0, 1, k).astype(np.float32)
        out = tcore.weighted_aggregate(
            {m: torch.from_numpy(x) for m, x in deltas.items()},
            torch.from_numpy(w))
        for m, x in deltas.items():
            want = (x * w.reshape((-1,) + (1,) * (x.ndim - 1))).sum(0)
            np.testing.assert_allclose(out[m].numpy(), want, rtol=2e-5,
                                       atol=2e-5)


def test_streaming_aggregate_init_takes_dtype():
    like = {"w": torch.ones(3, 2), "b": [torch.ones(4)]}
    for dtype in (torch.float32, torch.bfloat16):
        acc = tcore.streaming_aggregate_init(like, dtype)
        assert [x.dtype for x in jax.tree.leaves(acc)] == [dtype] * 2
        assert all(not x.any() for x in jax.tree.leaves(acc))
    assert tcore.streaming_aggregate_init(like)["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# availability registry
# ---------------------------------------------------------------------------


def test_availability_registry_is_jax():
    assert sorted(tcore.AVAILABILITY_REGISTRY) == sorted(
        jcore.AVAILABILITY_REGISTRY)
    for name, cls in tcore.AVAILABILITY_REGISTRY.items():
        assert cls.__name__ == jcore.AVAILABILITY_REGISTRY[name].__name__


@pytest.mark.parametrize("name", sorted(jcore.AVAILABILITY_REGISTRY))
def test_make_availability_draws_jax_masks(name):
    n = 50
    p = np.random.default_rng(0).dirichlet(np.ones(n)).astype(np.float32)
    jm = jcore.make_availability(name, n, p=p)
    tm = tcore.make_availability(name.upper(), n, p=p, device="cpu")
    assert type(tm).__name__ == type(jm).__name__
    # jitted with t traced, as the engines run it (XLA folds the constants
    # of SmartPhones' sine otherwise than an eager call rounds them)
    probs = jax.jit(jm.probs)
    for t in (0, 5):
        assert (tm.probs(t).numpy().tobytes()
                == np.asarray(probs(jnp.int32(t)), np.float32).tobytes())
    if name == "markov":
        jst, tst = jm.init_state(), tm.init_state()
        for t in range(5):
            jst, jmask = jm.step(jax.random.PRNGKey(t), jst)
            tst, tmask = tm.step(jr.PRNGKey(t, device="cpu"), tst)
            assert tmask.numpy().tobytes() == np.asarray(jmask).tobytes()
        return
    sample = jax.jit(jm.sample)
    for t in range(5):
        want = np.asarray(sample(jax.random.PRNGKey(t), jnp.int32(t)))
        got = tm.sample(jr.PRNGKey(t, device="cpu"), t)
        assert got.numpy().tobytes() == want.tobytes()


def test_make_availability_rejects_as_jax_does():
    with pytest.raises(KeyError) as jerr:
        jcore.make_availability("no-such-model", 4)
    with pytest.raises(KeyError) as terr:
        tcore.make_availability("no-such-model", 4, device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(AssertionError, match="needs client data fractions"):
        jcore.make_availability("uneven", 4)
    with pytest.raises(AssertionError, match="needs client data fractions"):
        tcore.make_availability("uneven", 4, device="cpu")


# ---------------------------------------------------------------------------
# the round's and the engines' parameters
# ---------------------------------------------------------------------------


def _round_inputs():
    from repro_torch.models import softmax_reg
    from repro_torch.optim import make_optimizer
    cfg = softmax_reg.SoftmaxRegConfig(dim=12, n_classes=5)
    params = softmax_reg.init_params(cfg, jr.PRNGKey(0, device="cpu"),
                                     device="cpu")
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.normal(size=(4, 3, 6, 12))
                                   .astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 5, (4, 3, 6))
                                   .astype(np.int32))}
    w = torch.from_numpy(rng.uniform(0, 1, 4).astype(np.float32))
    opt = make_optimizer("sgd", lr=1.0)
    return (lambda p, b: softmax_reg.loss_fn(cfg, p, b)), opt, params, \
        batch, w


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_make_fed_round_remat_gives_the_same_round(mode):
    loss, opt, params, batch, w = _round_inputs()
    outs = []
    for remat in (False, True):
        rnd = tcore.make_fed_round(loss, opt, mode=mode, remat=remat)
        new, _, m = rnd(params, opt.init(params), batch, w, 0.1)
        outs.append((new, m))
    for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(outs[1])):
        assert torch.equal(a, b)


def test_make_fed_round_acc_dtype_is_the_accumulator():
    loss, opt, params, batch, w = _round_inputs()
    ref, _, _ = tcore.make_fed_round(loss, opt, mode="sequential")(
        params, opt.init(params), batch, w, 0.1)
    got, _, _ = tcore.make_fed_round(loss, opt, mode="sequential",
                                     acc_dtype=torch.bfloat16)(
        params, opt.init(params), batch, w, 0.1)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        assert b.dtype == a.dtype
        err = float((a - b).abs().max())
        assert 0.0 < err <= 2e-2 * float(a.abs().max())


@pytest.mark.parametrize("kw", [dict(model_axis="model"),
                                dict(param_specs={}),
                                dict(param_shardings={})])
def test_make_fed_round_model_axis_raises_naming_item_11(kw):
    """The model axis is ported (item 11's engine half): it needs the
    sharded round's ``cohort_axis`` (a ``ValueError`` without it, as the
    model axis and its specs go together); ``param_shardings=``, the
    sequential mode's FSDP carries, still raises naming item 11."""
    loss, opt, *_ = _round_inputs()
    if "param_shardings" in kw:
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            tcore.make_fed_round(loss, opt, **kw)
        return
    with pytest.raises(ValueError, match="cohort_axis"):
        tcore.make_fed_round(loss, opt, **kw)
    with pytest.raises(ValueError, match="model_axis"):
        tcore.make_fed_round(loss, opt, cohort_axis=ClientMesh(),
                             cohort_slots=4, **kw)


def test_engines_model_axis_raises_naming_item_11():
    """A (c, m) mesh builds without raising item 11: with no process
    group only a mesh of one rank can be made, as for the 1-D mesh, and a
    model axis the mesh lacks is JAX's ``ValueError``."""
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        tsim.build_engine("scarce", mesh=(1, 2), device="cpu")
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        tsim.run_scenario_device("scarce", mesh=(2, 2), rounds=1,
                                 device="cpu")
    with pytest.raises(ValueError, match="no 'model' axis"):
        tsim.ShardedEngine(mesh=ClientMesh(), model_axis="model",
                           avail_model=None, budget=None, strategy=None,
                           staged=None, fed_round=None, init_params=None,
                           opt=None, client_lr=0.1, local_steps=1,
                           local_batch=1, n_clients=4, device="cpu")
    engine, _ = tsim.build_engine("scarce", mesh=(1, 1), device="cpu")
    assert engine.model_axis == "model"
    assert engine.mesh.axis_names == ("clients", "model")


def test_build_engine_resolves_a_shard_count_as_jax_does():
    """``mesh=1`` is a one-shard client mesh over ``clients_axis``, as
    JAX's ``resolve_client_mesh`` takes it."""
    engine, _ = tsim.build_engine("scarce", mesh=1, device="cpu")
    assert isinstance(engine, tsim.ShardedEngine)
    assert engine.mesh.size == 1 and engine.axis == "clients"
    engine, _ = tsim.build_engine("scarce", device="cpu")
    assert isinstance(engine, tsim.DeviceEngine)
