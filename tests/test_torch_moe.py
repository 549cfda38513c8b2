"""The port's moe family against the JAX package, on the CPU: mixtral-8x22b
(SWA 16 at smoke width) and grok-1-314b (soft-cap 30), each 2 layers, d 256,
8/2 heads, hd 32, 4 experts top-2, vocab 512, float32.

* ``layers.init_moe`` byte for byte JAX's (float32 and bfloat16, two
  seeds, a stack of keys; d 64, f 128, 8 experts), and ``init_params`` of
  both smoke configs.
* ``layers.top_k`` bitwise ``lax.top_k`` on random, all-tied and partly
  tied rows.  ``torch.topk`` orders ties otherwise, and a padded routing
  group's zero rows are exact ties: the padded case below shows its
  load-balancing loss leaving JAX's.
* ``layers.moe_block``: y within 1e-5, ``lb_loss`` within 1e-6, the gate
  indices and every token's buffer slot (so the kept set) equal to JAX's,
  which are read from its ``lax.top_k`` and ``one_hot`` calls: one group
  (S < G), several (S a multiple of G), a padded last group, and
  capacity drops.
* The whole model: ``forward`` logits within 1e-4 and ``lb_loss`` within
  1e-6, ``prefill``, 24 teacher-forced ``decode_step``s against JAX's
  (mixtral's 16-slot ring cache wraps), decode against forward by the
  median rule of ``tests/test_models_consistency.py`` (capacity drops
  differ between the batched and the one-token path).
* ``loss_fn`` (CE + 0.01 * lb_loss) and its gradient within 1e-5 of
  ``jax.grad``, with per-layer remat on and off: the checkpoint carries
  the layer's lb_loss as its second output.
* ``launch.serve`` on the CPU.

Weights are JAX's, carried across with ``convert.params_from_numpy``;
inputs come from numpy with a seed.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad_and_value  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import get_model_api as jget_model_api  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import get_model_api  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MOE = ["mixtral-8x22b", "grok-1-314b"]
SMOKE_J = jconfigs.get_arch("mixtral-8x22b").smoke_model


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg):
    return tL.ModelConfig(**{f: getattr(jcfg, f)
                             for f in tL.ModelConfig.__dataclass_fields__})


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _max_err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _tokens(vocab, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return (jnp.asarray(toks, jnp.int32),
            torch.from_numpy(toks.astype(np.int32)))


@functools.lru_cache(maxsize=None)
def _smoke_params(arch):
    jp = jT.init_params(jconfigs.get_arch(arch).smoke_model,
                        jax.random.PRNGKey(1))
    return jp, _to_torch(jp)


def _same_bytes(jtree, ttree):
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jtree))
    tl = jax.tree_util.tree_leaves_with_path(params_to_numpy(ttree))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert a.tobytes() == b.tobytes(), path


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_bitwise(dtype, seed):
    """One key, and a stack of two (the stacked layers' vmapped draw); the
    router stays float32 in a bfloat16 model."""
    jcfg = SMOKE_J.replace(d_model=64, d_ff=128, n_experts=8, dtype=dtype)
    key = jax.random.PRNGKey(seed)
    p = tL.init_moe(jr.PRNGKey(seed, device="cpu"), _tcfg(jcfg))
    _same_bytes(jL.init_moe(key, jcfg), p)
    assert p["router"].dtype == torch.float32
    assert p["w1"].dtype == _tcfg(jcfg).torch_dtype
    keys = jax.random.split(key, 2)
    _same_bytes(jax.vmap(lambda k: jL.init_moe(k, jcfg))(keys),
                tL.init_moe(jr.split(jr.PRNGKey(seed, device="cpu"), 2),
                            _tcfg(jcfg)))


@functools.lru_cache(maxsize=None)
def _served_params(arch):
    """The port's smoke weights ``launch.serve`` draws at seed 0."""
    return tserve.serve_params(arch, 0, device="cpu")


@pytest.mark.parametrize("arch", MOE)
def test_init_params_bitwise(arch):
    """``serve``'s draw: the first of the seed key's three."""
    jcfg = jconfigs.get_arch(arch).smoke_model
    key = jax.random.split(jax.random.PRNGKey(0), 3)[0]
    _same_bytes(jT.init_params(jcfg, key), _served_params(arch))


# ---------------------------------------------------------------------------
# top_k
# ---------------------------------------------------------------------------


def _rows(kind):
    rng = np.random.default_rng(7)
    if kind == "random":
        return rng.random((5, 3, 8)).astype(np.float32)
    if kind == "all_tied":
        return np.full((3, 8), 0.125, np.float32)
    # ties among the largest, among the middle and at zero
    x = np.array([[0.1, 0.3, 0.3, 0.3, 0, 0, 0, 0],
                  [0.2, 0.2, 0.05, 0.2, 0.2, 0.05, 0.1, 0],
                  [0, 0, 0, 0, 0, 0, 0, 1],
                  [0.5, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05, 0]], np.float32)
    return np.concatenate([x, np.round(rng.random((6, 8)) * 4) / 4]
                          ).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("kind", ["random", "all_tied", "partly_tied"])
def test_top_k_is_lax_top_k(kind, k):
    x = _rows(kind)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = tL.top_k(torch.from_numpy(x), k)
    assert ti.numpy().tobytes() == np.asarray(ji, np.int64).tobytes()
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()


def test_torch_topk_orders_ties_otherwise():
    """The trap ``top_k`` avoids: on a row of equal values ``torch.topk``
    does not return the lowest indices, ``lax.top_k`` does."""
    x = _rows("all_tied")
    _, ji = jax.lax.top_k(jnp.asarray(x), 2)
    assert (np.asarray(ji) == [0, 1]).all()
    assert not (torch.topk(torch.from_numpy(x), 2).indices.numpy()
                == np.asarray(ji)).all()


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

# (name, config changes, S): G = min(moe_group_size, S)
BLOCK_CASES = {
    "one_group": ({}, 40),                        # S < G: G = S
    "groups": (dict(moe_group_size=16), 48),      # 3 full groups
    "padded": (dict(moe_group_size=8), 30),       # 4 groups, 2 zero rows
    "drops": (dict(capacity_factor=0.5), 40),     # cap 10 of 80 choices
}


def _jax_moe_recorded(jp, x, jcfg, monkeypatch):
    """JAX's moe_block, run op by op, with what its ``lax.top_k`` and
    ``one_hot`` calls returned and were given: (y, aux, gate_idx, slot)."""
    seen = {"top_k": [], "one_hot": []}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def rec_top_k(x, k, **kw):
        out = top_k(x, k, **kw)
        seen["top_k"].append(out)
        return out

    def rec_one_hot(x, n, **kw):
        seen["one_hot"].append(x)
        return one_hot(x, n, **kw)
    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)
    y, aux = jL.moe_block(jp, jnp.asarray(x), jcfg)
    monkeypatch.undo()
    (_, gate_idx), = seen["top_k"]
    _, slot = seen["one_hot"]             # the choices', then the slots'
    return y, aux, np.asarray(gate_idx), np.asarray(slot)


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_moe_block_matches_jax(case, monkeypatch):
    changes, S = BLOCK_CASES[case]
    jcfg = SMOKE_J.replace(**changes)
    tcfg = _tcfg(jcfg)
    jp = jL.init_moe(jax.random.PRNGKey(4), jcfg)
    x = np.random.default_rng(5).normal(size=(2, S, jcfg.d_model)).astype(
        np.float32)
    jy, jaux, jidx, jslot = _jax_moe_recorded(jp, x, jcfg, monkeypatch)
    tp, tx = _to_torch(jp), torch.from_numpy(x)
    ty, taux = tL.moe_block(tp, tx, tcfg)
    r = tL.moe_routing(tp, tx, tcfg)
    np.testing.assert_array_equal(r.idx.numpy(), jidx)
    np.testing.assert_array_equal(r.slot.numpy(), jslot)
    assert ty.shape == (2, S, jcfg.d_model) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(taux["lb_loss"]) - float(jaux["lb_loss"])) <= 1e-6
    kept = int(r.keep.sum())
    n_groups = r.slot.shape[1]
    if case == "drops":
        assert r.cap == 10 and kept < 2 * S * jcfg.moe_top_k
    if case == "padded":
        assert n_groups == 4 and r.xg[:, -1, -2:].abs().max() == 0
        # the zero rows are exact ties: lax.top_k (and top_k) send them to
        # experts 0 and 1, torch.topk elsewhere, which moves lb_loss
        assert (jidx[:, -1, -2:] == [0, 1]).all()
        with monkeypatch.context() as m:
            m.setattr(tL, "top_k",
                      lambda v, k: torch.topk(v, k))
            _, topk_aux = tL.moe_block(tp, tx, tcfg)
        assert abs(float(topk_aux["lb_loss"])
                   - float(jaux["lb_loss"])) > 1e-4


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_forward_and_prefill_match_jax(arch):
    jcfg = jconfigs.get_arch(arch).smoke_model
    jp, tp = _smoke_params(arch)
    tcfg = tconfigs.get_arch(arch).smoke_model
    jt, tt = _tokens(jcfg.vocab, 2, 40, 3)
    jlog, jaux = jT.forward(jcfg, jp, {"tokens": jt})
    tlog, taux = tT.forward(tcfg, tp, {"tokens": tt})
    assert tlog.shape == (2, 40, jcfg.vocab)
    assert _max_err(tlog, jlog) <= 1e-4
    assert taux["lb_loss"].dtype == torch.float32
    assert abs(float(taux["lb_loss"]) - float(jaux["lb_loss"])) <= 1e-6
    tpre = tT.prefill(tcfg, tp, {"tokens": tt})
    assert tpre.shape == (2, 1, jcfg.vocab)
    assert _max_err(tpre, jT.prefill(jcfg, jp, {"tokens": jt})) <= 1e-4


@pytest.mark.parametrize("arch", MOE)
def test_decode_steps_match_jax_and_forward(arch):
    """24 teacher-forced steps against JAX's (logits 1e-4, caches 1e-5);
    mixtral's window of 16 makes a 16-slot ring that wraps at step 17.
    Against the port's own forward: the median rule."""
    jcfg = jconfigs.get_arch(arch).smoke_model
    tcfg = tconfigs.get_arch(arch).smoke_model
    jp, tp = _smoke_params(arch)
    S = 24
    jt, tt = _tokens(jcfg.vocab, 2, S, 4)
    jstate = jT.init_decode_state(jcfg, 2, S)
    tstate = tT.init_decode_state(tcfg, 2, S, device="cpu")
    ring = tcfg.sliding_window
    assert tstate["caches"]["k"].shape[2] == (ring or S)
    jstep = jax.jit(lambda p, s, t: jT.decode_step(jcfg, p, s, t))
    steps = []
    for i in range(S):
        jlog, jstate = jstep(jp, jstate, jt[:, i:i + 1])
        tlog, tstate = tT.decode_step(tcfg, tp, tstate, tt[:, i:i + 1])
        assert _max_err(tlog, jlog) <= 1e-4
        for n in ("k", "v"):
            assert _max_err(tstate["caches"][n], jstate["caches"][n]) <= 1e-5
        steps.append(_np(tlog)[:, 0])
    full, _ = tT.forward(tcfg, tp, {"tokens": tt})
    assert np.median(np.abs(np.stack(steps, 1) - _np(full))) < 0.1


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_fn_and_grad_match_jax(arch, remat):
    jcfg = jconfigs.get_arch(arch).smoke_model.replace(remat=remat)
    tcfg = tconfigs.get_arch(arch).smoke_model.replace(remat=remat)
    jp, tp = _smoke_params(arch)
    jt, tt = _tokens(jcfg.vocab, 2, 24, 6)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        jget_model_api(jcfg).loss_fn))(jp, {"tokens": jt})
    tgrad, tloss = grad_and_value(get_model_api(tcfg).loss_fn)(
        tp, {"tokens": tt})
    # the load-balancing term is in both
    _, jaux = jT.forward(jcfg, jp, {"tokens": jt})
    assert float(jaux["lb_loss"]) > 1.0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    jleaves, tleaves = jax.tree.leaves(jgrad), tree_leaves(tgrad)
    assert len(jleaves) == len(tleaves)
    for g, w in zip(tleaves, jleaves):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   rtol=1e-5, atol=1e-5)
    # the router's gradient comes from the gates and the lb term
    assert float(tgrad["blocks"]["moe"]["router"].abs().max()) > 0


# ---------------------------------------------------------------------------
# entry points on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_serve_runs_on_the_cpu(arch):
    """``serve``'s prompt is JAX's; its greedy tokens are in the vocabulary.
    (``run_arch_smoke``, which ``launch.train --arch`` runs, is held to
    JAX's in ``tests/test_torch_arch_train.py``.)"""
    vocab = jconfigs.get_arch(arch).smoke_model.vocab
    _, _, jk = jax.random.split(jax.random.PRNGKey(0), 3)
    want = np.asarray(jax.random.randint(jk, (4, 16), 0, vocab))
    res = tserve.serve(arch, steps=3, device="cpu", log_fn=lambda *a: None,
                       params=_served_params(arch))
    assert res.prompt.tobytes() == want.tobytes()
    assert res.tokens.shape == (4, 3)
    assert ((res.tokens >= 0) & (res.tokens < vocab)).all()
