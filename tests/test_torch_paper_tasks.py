"""The paper's Shakespeare and CIFAR tasks' data and parameters against
the JAX package on the CPU (the models' forward and grad are in
``test_torch_paper_models.py``):

* ``data.partition`` and the two stand-in data makers: bitwise, at two
  seeds (numpy, copied op for op);
* ``rnn.init_params`` and ``resnet.init_params``: every drawn leaf bitwise
  JAX's eager draw (the JAX engine draws eagerly), at two seeds, on the
  task configs and a small config, and the ResNet's static strides.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.configs import PAPER_TASKS as JTASKS
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.models import resnet as jresnet
from repro.models import rnn as jrnn
from repro_torch import random as tr
from repro_torch.convert import params_to_numpy
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.models import resnet as tresnet
from repro_torch.models import rnn as trnn
from repro_torch.tree import tree_leaves

SEEDS = (0, 7)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The draws are many small eager ops; several test workers share the
    cores, so each runs on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_arrays(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _same_clients(jclients, tclients):
    assert len(jclients) == len(tclients)
    for j, t in zip(jclients, tclients):
        for split in ("train", "test"):
            jd, td = getattr(j, split), getattr(t, split)
            assert sorted(jd) == sorted(td)
            assert all(_same_arrays(jd[k], td[k]) for k in jd)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_clients,alpha", [(50, 0.1), (200, 0.001)])
def test_dirichlet_partition_bitwise(seed, n_clients, alpha):
    """(200, 0.001) misses min_size in all 20 draws and takes the
    deterministic repair loop."""
    labels = np.repeat(np.arange(20), 30).astype(np.int32)
    want = jpart.dirichlet_partition(labels, n_clients, alpha, seed=seed)
    got = tpart.dirichlet_partition(labels, n_clients, alpha, seed=seed)
    assert len(want) == len(got) == n_clients
    assert all(_same_arrays(w, g) for w, g in zip(want, got))
    assert _same_arrays(jpart.client_fractions(want),
                        tpart.client_fractions(got))


@pytest.mark.parametrize("seed", SEEDS)
def test_size_skewed_partition_bitwise(seed):
    want = jpart.size_skewed_partition(5000, 100, seed=seed)
    got = tpart.size_skewed_partition(5000, 100, seed=seed)
    assert all(_same_arrays(w, g) for w, g in zip(want, got))


@pytest.mark.parametrize("seed", SEEDS)
def test_char_lm_maker_bitwise(seed):
    kw = dict(n_clients=6, sentences_per_client=12, seed=seed)
    _same_clients(jsyn.make_char_lm_federated(**kw),
                  tsyn.make_char_lm_federated(**kw))


@pytest.mark.parametrize("seed", SEEDS)
def test_vision_maker_bitwise(seed):
    kw = dict(n_clients=10, img=8, per_class=20, seed=seed)
    _same_clients(jsyn.make_vision_federated(**kw),
                  tsyn.make_vision_federated(**kw))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

SMALL_LSTM = dict(vocab=20, embed_dim=8, hidden=16, n_layers=2, seq_len=12)
SMALL_RESNET = dict(n_classes=5, width=8, stages=(1, 1, 1, 1))


def _assert_leaves_bitwise(jparams, tparams):
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = tree_leaves(params_to_numpy(tparams))
    assert len(jl) == len(tl)
    for (path, want), got in zip(jl, tl):
        assert _same_arrays(np.asarray(want), got), \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cfg", ["task", "small"])
def test_rnn_init_params_bitwise(seed, cfg):
    kw = {} if cfg == "task" else SMALL_LSTM
    jcfg = (JTASKS["shakespeare"].model_cfg if cfg == "task"
            else jrnn.LstmConfig(**kw))
    tcfg = trnn.LstmConfig(**dataclasses.asdict(jcfg))
    _assert_leaves_bitwise(jrnn.init_params(jcfg, jax.random.PRNGKey(seed)),
                           trnn.init_params(tcfg, tr.PRNGKey(seed, "cpu"),
                                            "cpu"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cfg", ["task", "small"])
def test_resnet_init_params_bitwise(seed, cfg):
    jcfg = (JTASKS["cifar"].model_cfg if cfg == "task"
            else jresnet.ResNetConfig(**SMALL_RESNET))
    tcfg = tresnet.ResNetConfig(**dataclasses.asdict(jcfg))
    jparams, jstrides = jresnet.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams, tstrides = tresnet.init_params(tcfg, tr.PRNGKey(seed, "cpu"),
                                            "cpu")
    assert tstrides == jstrides == tresnet.block_strides(tcfg)
    _assert_leaves_bitwise(jparams, tparams)


def test_parameter_counts():
    """Table 6's LSTM and the task ResNet, leaf for leaf as JAX's; the
    full ResNet-18 (``ResNetConfig()``) counted from JAX's shapes."""
    counts = {}
    for name, cfg, init in (
            ("lstm", trnn.LstmConfig(), trnn.init_params),
            ("resnet", tresnet.ResNetConfig(**dataclasses.asdict(
                JTASKS["cifar"].model_cfg)),
             lambda c, k, d: tresnet.init_params(c, k, d)[0])):
        counts[name] = sum(x.numel() for x in tree_leaves(
            init(cfg, tr.PRNGKey(0, "cpu"), "cpu")))
    assert counts == {"lstm": 820_522, "resnet": 310_116}
    full = jax.eval_shape(lambda k: jresnet.init_params(
        jresnet.ResNetConfig(), k)[0], jax.random.PRNGKey(0))
    assert sum(np.prod(x.shape) for x in jax.tree.leaves(full)) == \
        11_220_132
