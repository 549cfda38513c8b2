"""Checkpoints of the port (``repro_torch.checkpoint``): save, restore and
``latest_step``; a file written by either package loads in the other bit
for bit; the key sets of the three paper tasks' parameter trees are the
JAX package's; and the host loop and the device engine checkpoint at JAX's
cadence (every 100 rounds; every chunk) with JAX's contents."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import repro.sim as jsim
import repro_torch.sim as tsim
from repro.checkpoint import ckpt as jckpt
from repro.configs import PAPER_TASKS as JTASKS
from repro.models import resnet as jresnet
from repro.models import rnn as jrnn
from repro.models import softmax_reg as jsoftmax
from repro_torch import random as tr
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs import PAPER_TASKS as TTASKS
from repro_torch.convert import params_to_numpy
from repro_torch.models import resnet as tresnet
from repro_torch.models import rnn as trnn
from repro_torch.models import softmax_reg as tsoftmax
from repro_torch.tree import tree_leaves
from torch_parity import one_intra_op_thread


@pytest.fixture(autouse=True)
def _one_thread():
    """The runs of both packages (the task cells' rounds) on one intra-op
    thread: test workers share the cores."""
    with one_intra_op_thread():
        yield


def _quiet(*args, **kwargs):
    pass


def _task_params(task: str, seed: int = 0):
    """(JAX's, the port's) initial parameters of a paper task's model, on
    the CPU — bitwise the same trees."""
    jcfg, tcfg = JTASKS[task].model_cfg, TTASKS[task].model_cfg
    jkey, tkey = jax.random.PRNGKey(seed), tr.PRNGKey(seed, device="cpu")
    if task == "synthetic11":
        return (jsoftmax.init_params(jcfg, jkey),
                tsoftmax.init_params(tcfg, tkey, device="cpu"))
    if task == "shakespeare":
        return (jrnn.init_params(jcfg, jkey),
                trnn.init_params(tcfg, tkey, device="cpu"))
    return (jresnet.init_params(jcfg, jkey)[0],
            tresnet.init_params(tcfg, tkey, "cpu")[0])


def test_save_restore_and_latest_step(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "blocks": [{"b": torch.ones(2)},
                                  {"b": torch.zeros(2)}]},
            "rates": np.asarray([0.1, 0.9], np.float32),
            "step": torch.tensor(7, dtype=torch.int32)}
    d = str(tmp_path)
    assert latest_step(d) is None
    assert latest_step(str(tmp_path / "missing")) is None
    path = save_checkpoint(d, 7, tree)
    assert os.path.basename(path) == "state_00000007.npz"
    save_checkpoint(d, 12, tree)
    assert latest_step(d) == 12
    assert sorted(os.listdir(d)) == ["state_00000007.npz",
                                     "state_00000012.npz"]   # no .tmp left
    with np.load(path) as data:
        assert sorted(data.files) == ["params|blocks|0|b",
                                      "params|blocks|1|b", "params|w",
                                      "rates", "step"]
    like = {"params": {"w": torch.zeros(2, 3, dtype=torch.float64),
                       "blocks": [{"b": torch.empty(2)},
                                  {"b": torch.empty(2)}]},
            "rates": np.zeros(2, np.float32),
            "step": torch.tensor(0, dtype=torch.int32)}
    back = restore_checkpoint(path, like)
    assert back["params"]["w"].dtype == torch.float64   # like's dtype
    np.testing.assert_array_equal(back["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert back["params"]["blocks"][0]["b"].tolist() == [1.0, 1.0]
    assert isinstance(back["rates"], np.ndarray)
    assert back["rates"].tobytes() == tree["rates"].tobytes()
    assert int(back["step"]) == 7
    # a bare leaf saves under _root; a shape mismatch fails
    p2 = save_checkpoint(d, 1, torch.ones(3), tag="bare")
    with np.load(p2) as data:
        assert data.files == ["_root"]
    with pytest.raises(AssertionError):
        restore_checkpoint(p2, torch.ones(4))


@pytest.mark.parametrize("task", ["synthetic11", "shakespeare", "cifar"])
def test_checkpoints_cross_between_packages(task, tmp_path):
    """Keys equal to JAX's for each task's parameter tree (the ResNet's
    nested lists and the LSTM's included); a port-written file restores
    bitwise through JAX's ``restore_checkpoint`` and a JAX-written one
    through the port's."""
    jparams, tparams = _task_params(task)
    rates = np.linspace(0.05, 0.15, 7, dtype=np.float32)
    jtree = {"params": jparams, "rates": rates}
    ttree = {"params": tparams, "rates": rates}
    assert sorted(_flatten(ttree)) == sorted(jckpt._flatten(jtree))
    tpath = save_checkpoint(str(tmp_path / "torch"), 100, ttree)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 100, jtree)
    from_torch = jckpt.restore_checkpoint(tpath, jtree)
    from_jax = restore_checkpoint(jpath, ttree)
    want = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    for got in ([np.asarray(x) for x in jax.tree.leaves(from_torch)],
                tree_leaves(params_to_numpy(from_jax["params"]))
                + [from_jax["rates"]]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _ckpts(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("engine,rounds,files", [
    ("host", 100, ["state_00000100.npz"]),
    ("device", 25, ["state_00000010.npz", "state_00000020.npz",
                    "state_00000025.npz"])])
def test_checkpoint_cadence_matches_jax(engine, rounds, files, tmp_path):
    """The host loop saves every 100 rounds, the device engine at each
    chunk's end, as JAX's do; the last file's rates as JAX's (bitwise on
    the device engine, within 1e-6 on the host loop, which JAX runs op by
    op) and its parameters within 1e-5."""
    spec = jsim.RunSpec(rounds=rounds, engine=engine, eval_every=10)
    jres = jsim.run_spec(spec.replace(ckpt_dir=str(tmp_path / "jax")),
                         log_fn=_quiet)
    tres = tsim.run_spec(tsim.RunSpec.from_json(spec.to_json()).replace(
        ckpt_dir=str(tmp_path / "torch")), device="cpu", log_fn=_quiet)
    assert _ckpts(tmp_path / "jax") == _ckpts(tmp_path / "torch") == files
    with np.load(tmp_path / "jax" / files[-1]) as j, \
            np.load(tmp_path / "torch" / files[-1]) as t:
        assert sorted(j.files) == sorted(t.files)
        if engine == "device":
            assert j["rates"].tobytes() == t["rates"].tobytes()
        np.testing.assert_allclose(t["rates"], j["rates"], rtol=0, atol=1e-6)
        for k in j.files:
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-5)
        # the file holds the run's final r_k
        assert t["rates"].tobytes() == tres.rates.tobytes()
    assert jres.sel_history.tobytes() == tres.sel_history.tobytes()
