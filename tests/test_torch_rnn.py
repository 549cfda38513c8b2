"""The Shakespeare task's LSTM against the JAX package's on the CPU, from
the same carried weights: forward, loss, accuracy and ``grad`` at a small
size (hidden 16, seq 12) and at the task config (Table 6: hidden 256,
seq 80) within 1e-5 (measured ≤ 5.4e-8 on logits, 4.8e-7 on the loss)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch.func import grad

from repro.models import rnn as jrnn
from repro_torch.convert import params_from_numpy
from repro_torch.models import rnn as trnn
from repro_torch.tree import tree_leaves

TOL = 1e-5
SMALL_LSTM = dict(vocab=20, embed_dim=8, hidden=16, n_layers=2, seq_len=12)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Several test workers share the cores, so each test runs on one
    intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _max_leaf_diff(jtree, ttree):
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)))


@pytest.mark.parametrize("cfg", ["small", "task"])
def test_lstm_forward_loss_grad_match_jax(cfg):
    kw = SMALL_LSTM if cfg == "small" else {}
    jcfg, tcfg = jrnn.LstmConfig(**kw), trnn.LstmConfig(**kw)
    jp = jrnn.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab, (4, jcfg.seq_len)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    np.testing.assert_allclose(
        trnn.forward(tcfg, tp, tb["tokens"]).numpy(),
        np.asarray(jax.jit(lambda p, t: jrnn.forward(jcfg, p, t))(
            jp, jb["tokens"])), rtol=0, atol=TOL)
    assert abs(float(trnn.loss_fn(tcfg, tp, tb))
               - float(jrnn.loss_fn(jcfg, jp, jb))) <= TOL
    assert float(trnn.accuracy(tcfg, tp, tb)) == \
        float(jrnn.accuracy(jcfg, jp, jb))
    jg = jax.jit(jax.grad(lambda p, b: jrnn.loss_fn(jcfg, p, b)))(jp, jb)
    tg = grad(lambda p: trnn.loss_fn(tcfg, p, tb))(tp)
    assert _max_leaf_diff(jg, tg) <= TOL
