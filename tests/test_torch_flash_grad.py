"""The gradient of the port's attention against JAX's on the same
numpy-seeded inputs.

``ref.sdpa_lse`` (the plain forward that also returns each row's
log-sum-exp) and ``ref.sdpa_bwd`` (the plain FlashAttention-2 backward)
against ``repro.models.layers.sdpa`` and ``jax.vjp`` of it: the dense path
with GQA groups 1, 4 and 5 under causal, window and soft-cap masks, and
the chunked online-softmax path at S = 3072 with one KV head, all within
1e-5 in float32.  Then ``kernels.flash_attention`` as a differentiable,
``vmap``-able op: its gradient is ``sdpa_bwd``'s, under ``vmap`` over a
cohort axis it is each client's alone, without a recorded gradient it is
``ref.sdpa`` bit for bit, and on the CPU it launches no kernel.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, vmap  # noqa: E402
from torch_parity import one_intra_op_thread  # noqa: E402

from repro.models import layers as jL  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd)

TOL = 1e-5
MODES = {"causal": dict(causal=True, window=0, softcap=0.0),
         "window": dict(causal=True, window=7, softcap=0.0),
         "softcap": dict(causal=True, window=0, softcap=5.0),
         "full": dict(causal=False, window=0, softcap=0.0)}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def _inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    do = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    return q, k, v, do


def _jax_lse(q, k, mode):
    """Row log-sum-exp of JAX's masked scores (the dense path's
    logits), (B, H, Sq)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = jnp.asarray(q).reshape(B, S, KV, H // KV, hd)
    s = jnp.einsum("bqkgh,bskh->bkgqs", qg, jnp.asarray(k)) \
        / jnp.sqrt(hd).astype(jnp.float32)
    if mode["softcap"] > 0:
        s = mode["softcap"] * jnp.tanh(s / mode["softcap"])
    i, j = jnp.arange(S)[:, None], jnp.arange(S)[None, :]
    keep = jnp.ones((S, S), bool)
    if mode["causal"]:
        keep &= j <= i
    if mode["window"] > 0:
        keep &= j > i - mode["window"]
    s = jnp.where(keep, s, -1e30)
    return jax.nn.logsumexp(s, axis=-1).reshape(B, H, S)


@functools.partial(jax.jit, static_argnames=("causal", "window",
                                             "softcap"))
def _jax_vjp(q, k, v, do, *, causal, window, softcap):
    """JAX's sdpa and its vjp of ``do``, jitted (one compile a shape)."""
    out, pull = jax.vjp(lambda a, b, c: jL.sdpa(a, b, c, causal=causal,
                                               window=window,
                                               softcap=softcap), q, k, v)
    return out, pull(do)


def _check(shape, mode, seed):
    q, k, v, do = _inputs(*shape, seed)
    m = MODES[mode]
    out, want = _jax_vjp(*map(jnp.asarray, (q, k, v, do)), **m)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.sdpa_lse(tq, tk, tv, **m)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=TOL,
                               atol=TOL)
    got = ref.sdpa_bwd(tq, tk, tv, o, lse, tdo, **m)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    return q, k, lse


@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("mode", ["causal", "window", "softcap", "full"])
def test_plain_forward_and_backward_match_jax_dense(G, mode):
    q, k, lse = _check((2, 40, 2 * G, 2, 16), mode, 10 * G)
    want = _jax_lse(q, k, MODES[mode])
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("mode", ["causal", "window"])
def test_plain_backward_matches_jax_chunked(mode):
    """S = 3072: 3072^2 scores take the chunked online-softmax path in
    both packages (one KV head, a group of 2 query heads)."""
    assert 3072 * 3072 > ref._CHUNKED_THRESHOLD
    _check((1, 3072, 2, 1, 16), mode, 3)


def test_flash_attention_grad_is_the_plain_backward():
    q, k, v, do = map(torch.from_numpy, _inputs(1, 33, 8, 2, 16, 5))
    m = MODES["softcap"]
    gq, gk, gv = grad(lambda a, b, c: (flash_attention(a, b, c, **m)
                                       * do).sum(), argnums=(0, 1, 2))(q, k, v)
    o, lse = ref.sdpa_lse(q, k, v, **m)
    for g, w in zip((gq, gk, gv), flash_attention_bwd(q, k, v, o, lse, do,
                                                      **m)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_flash_attention_vmap_matches_a_loop_over_clients():
    """``vmap(grad)`` over a cohort of 3: the Function folds the cohort
    into the batch, and each client's gradient is its own."""
    K = 3
    rng = np.random.default_rng(11)
    q, k, v, w = (torch.from_numpy(rng.normal(size=(K, 2, 24, n, 16))
                                   .astype(np.float32))
                  for n in (8, 2, 2, 8))
    m = MODES["window"]

    def loss(a, b, c, wt):
        return (flash_attention(a, b, c, **m) * wt).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v, w)
    for i in range(K):
        want = grad(loss, argnums=(0, 1, 2))(q[i], k[i], v[i], w[i])
        for g, x in zip(got, want):
            torch.testing.assert_close(g[i], x, rtol=TOL, atol=TOL)


def test_flash_attention_without_grad_is_sdpa_and_launches_nothing():
    q, k, v, _ = map(torch.from_numpy, _inputs(2, 30, 4, 2, 16, 9))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = flash_attention(q, k, v, causal=True)
    assert torch.equal(out, ref.sdpa(q, k, v, causal=True))
    with torch.no_grad():
        out = vmap(lambda a: flash_attention(a, k, v))(q[None])[0]
    assert torch.equal(out, ref.sdpa(q, k, v, causal=True))
    assert (flash_attention.launches, flash_attention_bwd.launches) == before
