"""The port's chunked cross-entropies (``repro_torch.models.losses``)
against the JAX package's on the same numpy-seeded inputs: the value and
the gradient (``torch.func.grad`` against ``jax.grad``) within 1e-6, with
a ragged T that the chunk pads and with masks; the per-chunk checkpoint
under ``vmap`` against a loop over the mapped axis."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, vmap  # noqa: E402
from torch_parity import one_intra_op_thread  # noqa: E402

from repro.models import losses as jl  # noqa: E402
from repro_torch.models import losses as tl  # noqa: E402

TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def _inputs(B, T, d, V, seed, p_mask=0.8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    proj = (rng.normal(size=(d, V)) / np.sqrt(d)).astype(np.float32)
    tgt = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = rng.random((B, T)) < p_mask
    return x, proj, tgt, mask


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,T,d,V,chunk", [
    (2, 16, 8, 50, 4), (1, 33, 4, 11, 8), (3, 64, 16, 100, 32),
    (2, 37, 16, 200, 16)])
def test_fused_unembed_xent_value_and_grad_match_jax(B, T, d, V, chunk):
    x, proj, tgt, mask = _inputs(B, T, d, V, B * T)
    jx, jp = jnp.asarray(x), jnp.asarray(proj)
    jt, jm = jnp.asarray(tgt), jnp.asarray(mask)
    tx, tp = torch.from_numpy(x), torch.from_numpy(proj)
    tt, tm = torch.from_numpy(tgt), torch.from_numpy(mask)

    def jloss(a, b):
        return jl.fused_unembed_xent(a, b, jt, jm, chunk=chunk)

    def tloss(a, b):
        return tl.fused_unembed_xent(a, b, tt, tm, chunk=chunk)

    _close(tloss(tx, tp), jloss(jx, jp))
    for g, want in zip(grad(tloss, argnums=(0, 1))(tx, tp),
                       jax.grad(jloss, argnums=(0, 1))(jx, jp)):
        _close(g, want)


@pytest.mark.parametrize("B,T,V,chunk", [(2, 20, 30, 8), (1, 33, 11, 8),
                                         (3, 64, 100, 32)])
def test_chunked_softmax_xent_value_and_grad_match_jax(B, T, V, chunk):
    rng = np.random.default_rng(T)
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    tgt = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = rng.random((B, T)) < 0.7
    jt, jm = jnp.asarray(tgt), jnp.asarray(mask)
    tt, tm = torch.from_numpy(tgt), torch.from_numpy(mask)

    def jloss(lg):
        return jl.chunked_softmax_xent(lg, jt, jm, chunk=chunk)

    def tloss(lg):
        return tl.chunked_softmax_xent(lg, tt, tm, chunk=chunk)

    _close(tloss(torch.from_numpy(logits)), jloss(jnp.asarray(logits)))
    _close(grad(tloss)(torch.from_numpy(logits)),
           jax.grad(jloss)(jnp.asarray(logits)))


def test_all_masked_is_zero():
    x, proj = torch.ones(1, 8, 4), torch.ones(4, 7)
    tgt = torch.zeros(1, 8, dtype=torch.int32)
    mask = torch.zeros(1, 8, dtype=torch.bool)
    assert float(tl.fused_unembed_xent(x, proj, tgt, mask, chunk=4)) == 0.0
    assert float(tl.chunked_softmax_xent(x @ proj, tgt, mask,
                                         chunk=4)) == 0.0


def test_fused_grad_under_vmap_matches_a_loop():
    """The checkpointed chunks under ``vmap(grad)`` over a cohort axis:
    each client's gradient is the one it gets alone."""
    K, B, T, d, V = 3, 2, 21, 8, 40
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(K, B, T, d)).astype(np.float32))
    proj = torch.from_numpy(rng.normal(size=(d, V)).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, V, (K, B, T)).astype(np.int32))
    mask = torch.from_numpy(rng.random((K, B, T)) < 0.8)

    def loss(p, a, t, m):
        return tl.fused_unembed_xent(a, p, t, m, chunk=8)

    got = vmap(grad(loss), in_dims=(None, 0, 0, 0))(proj, x, tgt, mask)
    for k in range(K):
        want = grad(loss)(proj, x[k], tgt[k], mask[k])
        torch.testing.assert_close(got[k], want, rtol=TOL, atol=TOL)
