"""The CIFAR task's ResNet against the JAX package's on the CPU, from the
same carried weights: forward, loss and ``grad`` at a small size (width
8, stages (1, 1, 1, 1), 8×8 and 7×7 images) within 1e-5 (measured ≤
1.7e-6 on logits of magnitude 3); ``group_norm``; and XLA's SAME padding,
which ``F.conv2d(padding=1)`` does not give for a stride-2 convolution
of an even input.  (The first ResNet gradient JAX compiles in a process
takes ~20 s.)
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch.func import grad

from repro.models import resnet as jresnet
from repro_torch.convert import params_from_numpy
from repro_torch.models import resnet as tresnet
from repro_torch.tree import tree_leaves

TOL = 1e-5
SMALL_RESNET = dict(n_classes=5, width=8, stages=(1, 1, 1, 1))


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


@pytest.mark.parametrize("img", [8, 7])
def test_resnet_forward_loss_grad_match_jax(img):
    """8×8: every stride-2 block sees an even input (SAME pads (0, 1));
    7×7: odd inputs (pads (1, 1))."""
    jcfg = jresnet.ResNetConfig(**SMALL_RESNET)
    tcfg = tresnet.ResNetConfig(**SMALL_RESNET)
    jp, strides = jresnet.init_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, img, img, 3)).astype(np.float32)
    y = rng.integers(0, 5, 6).astype(np.int32)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    np.testing.assert_allclose(
        tresnet.forward(tcfg, tp, strides, tb["x"]).numpy(),
        np.asarray(jax.jit(lambda p, x: jresnet.forward(
            jcfg, p, strides, x))(jp, jb["x"])), rtol=0, atol=TOL)
    jloss = jresnet.make_loss_fn(jcfg, strides)
    tloss = tresnet.make_loss_fn(tcfg, strides)
    assert abs(float(tloss(tp, tb)) - float(jloss(jp, jb))) <= TOL
    assert float(tresnet.accuracy(tcfg, tp, strides, tb)) == \
        float(jresnet.accuracy(jcfg, jp, strides, jb))
    assert _max_leaf_diff(jax.jit(jax.grad(jloss))(jp, jb),
                          grad(tloss)(tp, tb)) <= TOL


@pytest.mark.parametrize("size,k,stride", [(16, 3, 2), (16, 1, 2),
                                           (15, 3, 2), (16, 3, 1)])
def test_conv_pads_as_xla_same(size, k, stride):
    rng = np.random.default_rng(size + k)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
    want = np.asarray(jresnet._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tresnet._conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_symmetric_padding_is_not_xla_same():
    """The trap ``_conv`` avoids: at stride 2 on an even input,
    ``padding=1`` shifts every output window by one pixel."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    want = np.asarray(jresnet._conv(jnp.asarray(x), jnp.asarray(w), 2))
    sym = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
    assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 1.0


@pytest.mark.parametrize("channels,groups", [(16, 8), (12, 8), (3, 8)])
def test_group_norm_matches_jax(channels, groups):
    """12 channels take 6 groups and 3 take 3: g steps down until it
    divides C.  Population variance, as JAX's."""
    rng = np.random.default_rng(channels)
    x = (3.0 + rng.normal(size=(2, 5, 5, channels))).astype(np.float32)
    scale = rng.normal(size=channels).astype(np.float32)
    bias = rng.normal(size=channels).astype(np.float32)
    want = np.asarray(jresnet.group_norm(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias), groups))
    got = tresnet.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias), groups)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
