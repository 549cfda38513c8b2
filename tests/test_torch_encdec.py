"""The port's audio family (``models/encdec.py``) against the JAX package,
on the CPU: whisper-small's smoke config (2 + 2 layers, d 128, 4 heads on
4 KV heads, hd 32, d_ff 256, vocab 512, 32 stub frames, float32).

* ``init_params`` byte for byte JAX's (two seeds, float32 and bfloat16):
  ``split(key, 5)``, the blocks' keys vmapped, ``dec_pos`` (4096, d) times
  0.01.
* ``_sinusoid`` within an ulp of JAX's compiled one at the smoke and the
  full width (1,500 x 768, where XLA's x * (1 / 768) and glibc's ``powf``
  and ``sinf`` matter).
* ``encode``, ``forward`` (decoder positions taken, and past 4,096 not
  taken), ``prefill_logits`` and ``loss_fn`` with its gradient within
  1e-5 of JAX's.
* ``prefill`` (the cross K/V) and 20 teacher-forced ``decode_step``s
  within 1e-5 of JAX's, and within 2e-3 of the port's forward.
* The cross-attention sees the encoder (``tests/test_models_consistency.py``).
* The full config's 241,206,528 parameters, counted on shapes alone.
* ``launch.serve`` on the CPU (JAX's weights, frames and prompt).

``run_arch_smoke("whisper-small")`` is held against JAX's in
``tests/test_torch_arch_train.py``.  Weights are JAX's, carried across
with ``convert.params_from_numpy``; inputs come from numpy with a seed.
"""
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad_and_value  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch.specs import count_params  # noqa: E402
from repro.models import encdec as jE  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import encdec as tE  # noqa: E402
from repro_torch.models import get_model_api  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "whisper-small"
SMOKE_J = jconfigs.get_arch(ARCH).smoke_model
SMOKE_T = tconfigs.get_arch(ARCH).smoke_model
FULL_PARAMS = 241_206_528
TOL = 1e-5


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


def _same_bytes(jtree, ttree):
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jtree))
    tl = jax.tree_util.tree_leaves_with_path(params_to_numpy(ttree))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert a.tobytes() == b.tobytes(), path


@functools.lru_cache(maxsize=None)
def _params():
    jp = jE.init_params(SMOKE_J, jax.random.PRNGKey(1))
    return jp, _to_torch(jp)


def _batch(B, S, seed, enc_seq=SMOKE_J.enc_seq):
    """(JAX's batch, the port's): S tokens and enc_seq stub frames."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, SMOKE_J.vocab, (B, S)).astype(np.int32),
         "frames": rng.normal(size=(B, enc_seq, SMOKE_J.d_model))
         .astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# ---------------------------------------------------------------------------
# init and positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_bitwise(dtype, seed):
    jcfg, tcfg = SMOKE_J.replace(dtype=dtype), SMOKE_T.replace(dtype=dtype)
    p = tE.init_params(tcfg, jr.PRNGKey(seed, device="cpu"), device="cpu")
    _same_bytes(jE.init_params(jcfg, jax.random.PRNGKey(seed)), p)
    assert p["dec_pos"].shape == (tE.DEC_POS, SMOKE_J.d_model)
    assert p["enc_blocks"]["attn"]["wq"].shape[0] == SMOKE_J.n_enc_layers
    assert "w3" not in p["dec_blocks"]["mlp"]         # gelu: not gated


@pytest.mark.parametrize("seq,d", [(32, 128), (1500, 768)])
def test_sinusoid_within_an_ulp_of_jax(seq, d):
    want = np.asarray(jax.jit(lambda: jE._sinusoid(seq, d))())
    got = tE._sinusoid(seq, d, "cpu").numpy()
    assert got.shape == want.shape == (seq, d)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= 1


def test_full_config_counts_jax_parameters():
    """Counted on shapes alone (``launch.specs.count_params``: the drawn
    leaves empty on the meta device) in about a second."""
    t0 = time.perf_counter()
    n = tspecs.count_params(tconfigs.get_arch(ARCH).model)
    assert time.perf_counter() - t0 < 20.0
    assert n == count_params(jconfigs.get_arch(ARCH).model) == FULL_PARAMS


def test_get_model_api_dispatches_audio_to_encdec():
    api = get_model_api(SMOKE_T)
    assert api.module is tE
    _, tp = _params()
    _, tb = _batch(2, 9, 2)
    logits, aux = api.forward(tp, tb)
    assert float(aux["lb_loss"]) == 0.0
    # prefill unembeds the last row alone: a one-row product, which the CPU
    # BLAS may sum in another order than the full one
    assert _max_err(api.prefill(tp, tb), logits[:, -1:]) < 1e-5
    with pytest.raises(KeyError, match="audio"):
        tT.init_params(SMOKE_T, jr.PRNGKey(0, device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def test_encode_matches_jax():
    jp, tp = _params()
    jb, tb = _batch(2, 8, 3)
    want = jax.jit(lambda p, f: jE.encode(SMOKE_J, p, f))(jp, jb["frames"])
    got = tE.encode(SMOKE_T, tp, tb["frames"])
    assert got.shape == (2, SMOKE_J.enc_seq, SMOKE_J.d_model)
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("S", (24, 4100))
def test_forward_and_prefill_logits_match_jax(S):
    """S = 4,100 is past the 4,096 decoder positions: JAX's branch that
    adds none (at one decoder layer, to keep it short)."""
    jp, tp = _params()
    jcfg, tcfg = SMOKE_J, SMOKE_T
    if S > tE.DEC_POS:
        jcfg, tcfg = SMOKE_J.replace(n_layers=1), SMOKE_T.replace(n_layers=1)
        jp = dict(jp, dec_blocks=jax.tree.map(lambda x: x[:1],
                                              jp["dec_blocks"]))
        tp = _to_torch(jp)
    jb, tb = _batch(1, S, 4)
    jlog, _ = jax.jit(lambda p, b: jE.forward(jcfg, p, b))(jp, jb)
    tlog, _ = tE.forward(tcfg, tp, tb)
    assert tlog.shape == (1, S, SMOKE_J.vocab)
    assert _max_err(tlog, jlog) <= TOL
    assert _max_err(tE.prefill_logits(tcfg, tp, tb), jlog[:, -1:]) <= TOL


def test_loss_fn_and_grad_match_jax():
    jp, tp = _params()
    jb, tb = _batch(2, 24, 6)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jE.loss_fn(SMOKE_J, p, b)))(jp, jb)
    tgrad, tloss = grad_and_value(get_model_api(SMOKE_T).loss_fn)(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL,
                               atol=TOL)
    jleaves, tleaves = jax.tree.leaves(jgrad), tree_leaves(tgrad)
    assert len(jleaves) == len(tleaves)
    for g, w in zip(tleaves, jleaves):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   rtol=TOL, atol=TOL)
    # the encoder learns through the cross-attention
    assert float(tgrad["enc_blocks"]["attn"]["wq"].abs().max()) > 0


def test_prefill_and_decode_match_jax_and_forward():
    jp, tp = _params()
    S = 20
    jb, tb = _batch(2, S, 7)
    jstate = jE.prefill(SMOKE_J, jp, jb, jE.init_decode_state(SMOKE_J, 2, S))
    tstate = tE.prefill(SMOKE_T, tp, tb,
                        tE.init_decode_state(SMOKE_T, 2, S, device="cpu"))
    for n in ("cross_k", "cross_v"):
        assert _max_err(tstate[n], jstate[n]) <= TOL
    jstep = jax.jit(lambda p, s, t: jE.decode_step(SMOKE_J, p, s, t))
    jt, tt = jb["tokens"], tb["tokens"]
    steps = []
    for i in range(S):
        jlog, jstate = jstep(jp, jstate, jt[:, i:i + 1])
        tlog, tstate = tE.decode_step(SMOKE_T, tp, tstate, tt[:, i:i + 1])
        assert _max_err(tlog, jlog) <= TOL
        for n in ("self_k", "self_v"):
            assert _max_err(tstate[n], jstate[n]) <= TOL
        steps.append(_np(tlog)[:, 0])
    assert int(tstate["index"]) == S
    full, _ = tE.forward(SMOKE_T, tp, tb)
    assert np.abs(np.stack(steps, 1) - _np(full)).max() < 2e-3


def test_cross_attention_sees_the_encoder():
    _, tp = _params()
    _, tb = _batch(1, 8, 8)
    other = dict(tb, frames=torch.from_numpy(np.random.default_rng(9).normal(
        size=tb["frames"].shape).astype(np.float32)))
    l1, _ = tE.forward(SMOKE_T, tp, tb)
    l2, _ = tE.forward(SMOKE_T, tp, other)
    assert not np.allclose(_np(l1), _np(l2), atol=1e-4)


# ---------------------------------------------------------------------------
# entry points on the CPU
# ---------------------------------------------------------------------------


def test_serve_runs_on_the_cpu():
    """``serve``'s weights, frames and prompt are JAX's (its three keys);
    its greedy tokens are in the vocabulary."""
    vocab = SMOKE_J.vocab
    k_params, k_frames, jk = jax.random.split(jax.random.PRNGKey(0), 3)
    want = np.asarray(jax.random.randint(jk, (4, 16), 0, vocab))
    params = tserve.serve_params(ARCH, 0, device="cpu")
    _same_bytes(jE.init_params(SMOKE_J, k_params), params)
    frames = jax.random.normal(k_frames, (4, SMOKE_J.enc_seq,
                                          SMOKE_J.d_model))
    tkey = jr.split(jr.PRNGKey(0, device="cpu"), 3)[1]
    got = jr.normal(tkey, (4, SMOKE_J.enc_seq, SMOKE_J.d_model))
    assert got.numpy().tobytes() == np.asarray(frames).tobytes()
    res = tserve.serve(ARCH, steps=8, device="cpu", log_fn=lambda *a: None,
                       params=params)
    assert res.prompt.tobytes() == want.tobytes()
    assert res.tokens.shape == (4, 8)
    assert ((res.tokens >= 0) & (res.tokens < vocab)).all()
