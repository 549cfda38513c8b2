"""The port's hybrid family against the JAX package, on the CPU:
recurrentgemma-2b's smoke config (5 layers = one (rec, rec, attn) group and
a tail of 2 recurrent blocks, d 128, 4 query heads on 1 KV head, hd 32,
local attention window 16, lru_width 128, vocab 512, float32).

* ``init_params`` of the smoke config byte for byte JAX's (two seeds,
  float32 and bfloat16; ``lam`` within an ulp): JAX's key tree (per group,
  then the tail) and leaf names.
* The whole model at n_layers 5, 6 and 4 (tails of 2, 0 and 1):
  ``forward`` and ``prefill`` logits within 1e-5, 24 teacher-forced
  ``decode_step``s against JAX's (the 16-slot ring wraps at step 17) and
  against the port's forward (max |err| < 2e-3, the non-moe rule of
  ``tests/test_models_consistency.py``); the attention takes
  ``sliding_window`` even with ``long_context_window`` set.
* ``loss_fn`` and its gradient within 1e-5 of ``jax.grad``, with remat
  (one checkpoint a group, the tail unchecked) on and off.
* The full config's 2,894,574,080 parameters, counted on shapes alone.
* ``launch.serve`` on the CPU, with ``max_len`` past the window (a ring).

The RG-LRU block alone is held in ``tests/test_torch_rglru.py``.  Weights
are JAX's, carried across with ``convert.params_from_numpy``; inputs come
from numpy with a seed.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad_and_value  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch.specs import count_params  # noqa: E402
from repro.models import get_model_api as jget_model_api  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import get_model_api  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "recurrentgemma-2b"
SMOKE_J = jconfigs.get_arch(ARCH).smoke_model
SMOKE_T = tconfigs.get_arch(ARCH).smoke_model
FULL_PARAMS = 2_894_574_080
# (n_layers, tail): one group and a tail of 2, two groups, one and 1
LAYOUTS = [(5, 2), (6, 0), (4, 1)]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _max_err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _same_bytes(jtree, ttree):
    """Every leaf's bytes equal; ``lam`` within an ulp."""
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jtree))
    tl = jax.tree_util.tree_leaves_with_path(params_to_numpy(ttree))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if jax.tree_util.keystr(path).endswith("['lam']"):
            assert _ulps(a, b) <= 1, path
        else:
            assert a.tobytes() == b.tobytes(), path


def _layout(n_layers):
    return (SMOKE_J.replace(n_layers=n_layers),
            SMOKE_T.replace(n_layers=n_layers))


@functools.lru_cache(maxsize=None)
def _params(n_layers):
    jcfg, _ = _layout(n_layers)
    jp = jT.init_params(jcfg, jax.random.PRNGKey(1))
    return jp, _to_torch(jp)


def _tokens(vocab, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return (jnp.asarray(toks, jnp.int32),
            torch.from_numpy(toks.astype(np.int32)))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_bitwise(dtype, seed):
    """The groups' tree (``"0_rec"``, ``"1_rec"``, ``"2_attn"``, one key a
    group split per block) and the tail's (``split(keys[3], 2)``)."""
    jcfg, tcfg = SMOKE_J.replace(dtype=dtype), SMOKE_T.replace(dtype=dtype)
    p = tT.init_params(tcfg, jr.PRNGKey(seed, device="cpu"), device="cpu")
    _same_bytes(jT.init_params(jcfg, jax.random.PRNGKey(seed)), p)
    assert sorted(p["groups"]) == ["0_rec", "1_rec", "2_attn"]
    assert p["groups"]["0_rec"]["rglru"]["wx"].shape == (1, 128, 128)
    assert p["tail"]["mlp"]["w1"].shape == (2, 128, 256)


def test_full_config_counts_jax_parameters():
    cfg = tconfigs.get_arch(ARCH).model
    with tL.shapes_only():
        p = tT.init_params(cfg, jr.PRNGKey(0, device="cpu"), device="cpu")
    n = sum(t.numel() for t in tree_leaves(p))
    assert n == count_params(jconfigs.get_arch(ARCH).model) == FULL_PARAMS


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_layers,tail", LAYOUTS)
def test_forward_and_prefill_match_jax(n_layers, tail):
    jcfg, tcfg = _layout(n_layers)
    jp, tp = _params(n_layers)
    assert tT._hybrid_layout(tcfg) == (("rec", "rec", "attn"),
                                       n_layers // 3, tail)
    assert ("tail" in tp) == bool(tail)
    jt, tt = _tokens(jcfg.vocab, 2, 40, 3)
    jlog, _ = jT.forward(jcfg, jp, {"tokens": jt})
    tlog, taux = tT.forward(tcfg, tp, {"tokens": tt})
    assert tlog.shape == (2, 40, jcfg.vocab)
    assert _max_err(tlog, jlog) <= 1e-5
    assert float(taux["lb_loss"]) == 0.0
    tpre = tT.prefill(tcfg, tp, {"tokens": tt})
    assert tpre.shape == (2, 1, jcfg.vocab)
    assert _max_err(tpre, jT.prefill(jcfg, jp, {"tokens": jt})) <= 1e-5


def test_attention_takes_the_sliding_window_not_the_long_context_one():
    """The hybrid's attention blocks take ``cfg.sliding_window`` even when
    ``long_context_window`` is set (the dense path's ``_window`` would
    take the latter), as JAX's do."""
    jcfg = SMOKE_J.replace(long_context_window=4)
    tcfg = SMOKE_T.replace(long_context_window=4)
    jp, tp = _params(5)
    jt, tt = _tokens(jcfg.vocab, 1, 40, 8)
    want = jT.forward(jcfg, jp, {"tokens": jt})[0]
    got = tT.forward(tcfg, tp, {"tokens": tt})[0]
    assert _max_err(got, want) <= 1e-5
    assert _max_err(got, tT.forward(SMOKE_T, tp, {"tokens": tt})[0]) == 0.0


@pytest.mark.parametrize("n_layers,tail", LAYOUTS)
def test_decode_steps_match_jax_and_forward(n_layers, tail):
    """24 teacher-forced steps against JAX's (logits 1e-4, states 1e-5);
    the window of 16 makes a 16-slot ring that wraps at step 17.  Against
    the port's own forward: max |err| < 2e-3."""
    jcfg, tcfg = _layout(n_layers)
    jp, tp = _params(n_layers)
    S = 24
    jt, tt = _tokens(jcfg.vocab, 2, S, 4)
    jstate = jT.init_decode_state(jcfg, 2, S)
    tstate = tT.init_decode_state(tcfg, 2, S, device="cpu")
    assert jax.tree.map(np.shape, jstate) == jax.tree.map(
        lambda t: tuple(t.shape), tstate)
    assert tstate["groups"]["2_attn"]["k"].shape[2] == tcfg.sliding_window
    jstep = jax.jit(lambda p, s, t: jT.decode_step(jcfg, p, s, t))
    steps = []
    for i in range(S):
        jlog, jstate = jstep(jp, jstate, jt[:, i:i + 1])
        tlog, tstate = tT.decode_step(tcfg, tp, tstate, tt[:, i:i + 1])
        assert _max_err(tlog, jlog) <= 1e-4
        jl, tl = jax.tree.leaves(jstate), tree_leaves(tstate)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert _max_err(a, b) <= 1e-5
        steps.append(_np(tlog)[:, 0])
    assert int(tstate["index"]) == S
    full, _ = tT.forward(tcfg, tp, {"tokens": tt})
    assert np.abs(np.stack(steps, 1) - _np(full)).max() < 2e-3


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_fn_and_grad_match_jax(remat):
    jcfg = SMOKE_J.replace(remat=remat)
    tcfg = SMOKE_T.replace(remat=remat)
    jp, tp = _params(5)
    jt, tt = _tokens(jcfg.vocab, 2, 24, 6)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        jget_model_api(jcfg).loss_fn))(jp, {"tokens": jt})
    tgrad, tloss = grad_and_value(get_model_api(tcfg).loss_fn)(
        tp, {"tokens": tt})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    jleaves, tleaves = jax.tree.leaves(jgrad), tree_leaves(tgrad)
    assert len(jleaves) == len(tleaves)
    for g, w in zip(tleaves, jleaves):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   rtol=1e-5, atol=1e-5)
    assert float(tgrad["tail"]["rglru"]["lam"].abs().max()) > 0


# ---------------------------------------------------------------------------
# entry points on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len", [128, 16], ids=["cache", "ring"])
def test_serve_runs_on_the_cpu(max_len):
    """``serve``'s weights and prompt are JAX's; its greedy tokens are in
    the vocabulary.  At ``max_len`` 16 the attention caches are rings of
    the window's 16 slots, which the 16 + 8 steps wrap."""
    vocab = SMOKE_J.vocab
    k_params, _, jk = jax.random.split(jax.random.PRNGKey(0), 3)
    want = np.asarray(jax.random.randint(jk, (4, 16), 0, vocab))
    params = tserve.serve_params(ARCH, 0, device="cpu")
    _same_bytes(jT.init_params(SMOKE_J, k_params), params)
    res = tserve.serve(ARCH, steps=8, max_len=max_len, device="cpu",
                       log_fn=lambda *a: None, params=params)
    assert res.prompt.tobytes() == want.tobytes()
    assert res.tokens.shape == (4, 8)
    assert ((res.tokens >= 0) & (res.tokens < vocab)).all()
