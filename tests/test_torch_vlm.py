"""The port's vlm family against the JAX package, on the CPU: llava-next-34b's
smoke config (2 layers, d 256, 8 query heads on 2 KV heads, hd 32, vocab
512, 16 patch embeddings of width 64 prepended to the text, float32).

* ``init_params`` byte for byte JAX's (two seeds, float32 and bfloat16),
  the projector among them: w1 scaled by 1/sqrt(vit_dim), w2 divided by
  sqrt(d_model), from ``split(keys[4], 2)``.
* ``forward`` (logits over the patches and the text, the text mask) and
  ``prefill`` within 1e-5.
* ``loss_fn`` and its gradient within 1e-5 of ``jax.grad``, with and
  without ``loss_mask`` and remat: the image prefix is dropped before the
  CE, so the loss is the text's alone.
* Decode is text only, as in JAX's ``serve``: 20 teacher-forced steps
  against JAX's (logits 1e-4, caches 1e-5) and against the port's forward
  of the same text with no patches (max |err| < 2e-3).
* The full config's 34,447,637,504 parameters, counted on shapes alone.
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

ARCH = "llava-next-34b"
SMOKE_J = jconfigs.get_arch(ARCH).smoke_model
SMOKE_T = tconfigs.get_arch(ARCH).smoke_model
FULL_PARAMS = 34_447_637_504


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
    jp = jT.init_params(SMOKE_J, jax.random.PRNGKey(1))
    return jp, _to_torch(jp)


def _batch(B, T, seed, n_patches=SMOKE_J.n_patches, loss_mask=False):
    """(JAX's batch, the port's): T text tokens and n_patches patches."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, SMOKE_J.vocab, (B, T)).astype(np.int32),
         "patch_embeds": rng.normal(size=(B, n_patches, SMOKE_J.vit_dim))
         .astype(np.float32)}
    if loss_mask:
        b["loss_mask"] = rng.random((B, T)) < 0.7
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_bitwise(dtype, seed):
    jcfg, tcfg = SMOKE_J.replace(dtype=dtype), SMOKE_T.replace(dtype=dtype)
    p = tT.init_params(tcfg, jr.PRNGKey(seed, device="cpu"), device="cpu")
    _same_bytes(jT.init_params(jcfg, jax.random.PRNGKey(seed)), p)
    assert p["projector"]["w1"].shape == (SMOKE_J.vit_dim, SMOKE_J.d_model)


def test_full_config_counts_jax_parameters():
    cfg = tconfigs.get_arch(ARCH).model
    with tL.shapes_only():
        p = tT.init_params(cfg, jr.PRNGKey(0, device="cpu"), device="cpu")
    n = sum(t.numel() for t in tree_leaves(p))
    assert n == count_params(jconfigs.get_arch(ARCH).model) == FULL_PARAMS


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def test_forward_and_prefill_match_jax():
    jp, tp = _params()
    jb, tb = _batch(2, 40, 3)
    P = SMOKE_J.n_patches
    jlog, jaux = jT.forward(SMOKE_J, jp, jb)
    tlog, taux = tT.forward(SMOKE_T, tp, tb)
    assert tlog.shape == (2, P + 40, SMOKE_J.vocab)
    assert _max_err(tlog, jlog) <= 1e-5
    assert taux["text_mask"].numpy().tobytes() \
        == np.asarray(jaux["text_mask"]).tobytes()
    tmask = taux["text_mask"]
    assert not tmask[:, :P].any() and tmask[:, P:].all()
    tpre = tT.prefill(SMOKE_T, tp, tb)
    assert tpre.shape == (2, 1, SMOKE_J.vocab)
    assert _max_err(tpre, jT.prefill(SMOKE_J, jp, jb)) <= 1e-5


@pytest.mark.parametrize("remat,loss_mask", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_loss_fn_and_grad_match_jax(remat, loss_mask):
    jcfg = SMOKE_J.replace(remat=remat)
    tcfg = SMOKE_T.replace(remat=remat)
    jp, tp = _params()
    jb, tb = _batch(2, 24, 6, loss_mask=loss_mask)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        jget_model_api(jcfg).loss_fn))(jp, jb)
    tgrad, tloss = grad_and_value(get_model_api(tcfg).loss_fn)(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    jleaves, tleaves = jax.tree.leaves(jgrad), tree_leaves(tgrad)
    assert len(jleaves) == len(tleaves)
    for g, w in zip(tleaves, jleaves):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   rtol=1e-5, atol=1e-5)
    # the projector learns through the text positions' attention
    assert float(tgrad["projector"]["w1"].abs().max()) > 0


def test_loss_is_the_texts_alone():
    """The loss over patches + text equals the CE of the text positions'
    next-token logits (forward's, the prefix sliced off), and a prefix of
    other patches moves it."""
    _, tp = _params()
    _, tb = _batch(2, 24, 7)
    logits, _ = tT.forward(SMOKE_T, tp, tb)
    P = SMOKE_J.n_patches
    lp = torch.log_softmax(logits[:, P:-1].double(), dim=-1)
    want = -lp.gather(-1, tb["tokens"][:, 1:, None].long()).mean()
    got = tT.loss_fn(SMOKE_T, tp, tb)
    assert abs(float(got) - float(want)) <= 1e-5
    other = dict(tb, patch_embeds=tb["patch_embeds"] * 2.0)
    assert abs(float(tT.loss_fn(SMOKE_T, tp, other)) - float(got)) > 1e-4


def test_decode_is_text_only_and_matches_jax_and_forward():
    jp, tp = _params()
    S = 20
    jb, tb = _batch(2, S, 4)
    jt, tt = jb["tokens"], tb["tokens"]
    jstate = jT.init_decode_state(SMOKE_J, 2, S)
    tstate = tT.init_decode_state(SMOKE_T, 2, S, device="cpu")
    jstep = jax.jit(lambda p, s, t: jT.decode_step(SMOKE_J, p, s, t))
    steps = []
    for i in range(S):
        jlog, jstate = jstep(jp, jstate, jt[:, i:i + 1])
        tlog, tstate = tT.decode_step(SMOKE_T, tp, tstate, tt[:, i:i + 1])
        assert _max_err(tlog, jlog) <= 1e-4
        for n in ("k", "v"):
            assert _max_err(tstate["caches"][n], jstate["caches"][n]) <= 1e-5
        steps.append(_np(tlog)[:, 0])
    _, text_only = _batch(2, S, 4, n_patches=0)
    full, _ = tT.forward(SMOKE_T, tp, text_only)
    assert full.shape == (2, S, SMOKE_J.vocab)
    assert np.abs(np.stack(steps, 1) - _np(full)).max() < 2e-3


# ---------------------------------------------------------------------------
# entry points on the CPU
# ---------------------------------------------------------------------------


def test_serve_runs_on_the_cpu():
    """``serve``'s weights and prompt are JAX's; its greedy tokens are in
    the vocabulary."""
    vocab = SMOKE_J.vocab
    k_params, _, jk = jax.random.split(jax.random.PRNGKey(0), 3)
    want = np.asarray(jax.random.randint(jk, (4, 16), 0, vocab))
    params = tserve.serve_params(ARCH, 0, device="cpu")
    _same_bytes(jT.init_params(SMOKE_J, k_params), params)
    res = tserve.serve(ARCH, steps=8, device="cpu", log_fn=lambda *a: None,
                       params=params)
    assert res.prompt.tobytes() == want.tobytes()
    assert res.tokens.shape == (4, 8)
    assert ((res.tokens >= 0) & (res.tokens < vocab)).all()
