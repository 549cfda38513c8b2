"""The model zoo's federated round against the JAX package, on the CPU.

* Configs: ``FedExec``, ``INPUT_SHAPES["train_4k"]`` and each
  arch's ``fed=`` and long-context fields are JAX's field for field, and
  so is ``model_for_shape`` at every shape (the decode shapes' are held
  further in ``tests/test_torch_decode_shapes.py``).
* ``launch.specs``: ``count_params`` of the ten full configs and
  ``param_specs`` of the smoke configs are JAX's, and so are the batch
  specs (a vlm's ``patch_embeds`` and shortened text, whisper's
  ``frames`` among them).
* ``loss_fn`` (fused unembedding CE, per-layer remat) and its gradient for
  the smoke configs of llama3.2-1b, qwen3-8b, qwen3-14b, gemma-7b and
  mamba2-2.7b, from JAX's weights, within 1e-5.
* ``run_arch_smoke`` (llama3.2-1b, mamba2-2.7b, mixtral-8x22b,
  grok-1-314b, recurrentgemma-2b, llava-next-34b and whisper-small: their
  patch embeddings and frames drawn from the round's fifth key, bitwise
  JAX's): 3 rounds on the CPU
  against JAX's, masks bitwise and
  losses within 1e-5 relative.  The losses depart by ~2e-7 relative after
  Adam's first server step, which moves coordinates whose Δ is within
  rounding of 0 by up to ±lr (ROADMAP.md queue 3, "FedAdam's first server
  step amplifies rounding").
* ``build_train_step``: llama3.2-1b and mamba2-2.7b (smoke widths) run one
  round against JAX's ``make_fed_round`` with ``cfg.remat`` and Adam, and
  every family builds for CUDA (the ssm family's gradient is the
  ssd_chunk_bwd kernel there; ``tests/test_torch_ssd_grad.py`` holds its
  plain version, which runs here).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad_and_value  # noqa: E402
from torch_parity import one_intra_op_thread  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.launch.train as jtrain  # noqa: E402
from repro.configs.common import FedExec as JFedExec  # noqa: E402
from repro.core.fedstep import make_fed_round as jmake_fed_round  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import get_model_api as jget_model_api  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.common import FedExec  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import get_model_api  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ["llama3.2-1b", "qwen3-8b", "qwen3-14b", "gemma-7b", "mamba2-2.7b"]
# the moe, hybrid, vlm and audio archs: their loss_fn and gradient are
# held in test_torch_moe.py, test_torch_hybrid.py, test_torch_vlm.py and
# test_torch_encdec.py
MOE = ["mixtral-8x22b", "grok-1-314b"]
HYBRID_VLM = ["recurrentgemma-2b", "llava-next-34b"]
AUDIO = ["whisper-small"]
TOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + MOE + HYBRID_VLM + AUDIO)
def test_fed_exec_and_train_shape_field_for_field(arch):
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert dataclasses.asdict(tspec.fed) == dataclasses.asdict(jspec.fed)
    for f in ("long_context", "long_context_window"):
        assert getattr(tspec, f) == getattr(jspec, f)
    assert (tconfigs.INPUT_SHAPES["train_4k"]
            == jconfigs.INPUT_SHAPES["train_4k"])
    assert (dataclasses.asdict(tspec.model_for_shape("train_4k"))
            == dataclasses.asdict(jspec.model_for_shape("train_4k")))
    assert tspec.fed.local_batch_for(256) == jspec.fed.local_batch_for(256)
    assert tspec.supported_shapes() == jspec.supported_shapes()
    for shape in ("decode_32k", "long_500k"):
        want = jspec.model_for_shape(shape)
        got = tspec.model_for_shape(shape)
        assert (None if got is None else dataclasses.asdict(got)) \
            == (None if want is None else dataclasses.asdict(want))


def test_fed_exec_defaults_are_jax():
    for mode, k in (("parallel", 32), ("sequential", 8)):
        assert (dataclasses.asdict(FedExec(mode, k))
                == dataclasses.asdict(JFedExec(mode, k)))
    assert [f.name for f in dataclasses.fields(FedExec)] \
        == [f.name for f in dataclasses.fields(JFedExec)]


@pytest.mark.parametrize("arch", ARCHS + MOE + HYBRID_VLM + AUDIO)
def test_specs_match_jax(arch):
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert (tspecs.count_params(tspec.model)
            == jspecs.count_params(jspec.model))
    want = [(tuple(x.shape), str(x.dtype))
            for x in jax.tree.leaves(jspecs.param_specs(jspec.smoke_model))]
    got = [(tuple(x.shape), str(x.dtype).split(".")[-1])
           for x in jax.tree.leaves(
               tspecs.param_specs(tspec.smoke_model),
               is_leaf=lambda x: isinstance(x, tspecs.ShapeDtype))]
    assert got == want
    for fn, shape in ((tspecs.cohort_batch_specs, "train_4k"),
                      (tspecs.prefill_batch_specs, "prefill_32k")):
        jb = getattr(jspecs, fn.__name__)(jspec, shape)
        tb = fn(tspec, shape)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()} \
            == {k: (v.shape, str(v.dtype).split(".")[-1])
                for k, v in tb.items()}


# ---------------------------------------------------------------------------
# loss_fn and its gradient
# ---------------------------------------------------------------------------


def _loss_case(arch, remat, loss_mask):
    jcfg = jconfigs.get_arch(arch).smoke_model.replace(remat=remat)
    tcfg = tconfigs.get_arch(arch).smoke_model.replace(remat=remat)
    jparams = jget_model_api(jcfg).init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if loss_mask:
        m = rng.random((2, 24)) < 0.7
        jb["loss_mask"], tb["loss_mask"] = jnp.asarray(m), torch.from_numpy(m)
    return jcfg, tcfg, jparams, jb, tb


@pytest.mark.parametrize("arch,remat,loss_mask", [
    *[(a, False, False) for a in ARCHS],
    ("llama3.2-1b", True, True), ("mamba2-2.7b", True, False)])
def test_loss_fn_and_grad_match_jax(arch, remat, loss_mask):
    jcfg, tcfg, jparams, jb, tb = _loss_case(arch, remat, loss_mask)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        jget_model_api(jcfg).loss_fn))(jparams, jb)
    tgrad, tloss = grad_and_value(get_model_api(tcfg).loss_fn)(
        _to_torch(jparams), tb)
    _close(tloss, jloss)
    jleaves, tleaves = jax.tree.leaves(jgrad), tree_leaves(tgrad)
    assert len(jleaves) == len(tleaves)
    for g, w in zip(tleaves, jleaves):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


# ---------------------------------------------------------------------------
# the round: run_arch_smoke and build_train_step
# ---------------------------------------------------------------------------


def _recording(make_strategy, masks):
    """``make_strategy`` whose strategies record each selection mask."""
    def make(*a, **kw):
        s = make_strategy(*a, **kw)

        def select(*args):
            mask, w, state = s.select(*args)
            masks.append(np.asarray(mask.cpu() if torch.is_tensor(mask)
                                    else mask))
            return mask, w, state
        return s._replace(select=select)
    return make


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b", *MOE,
                                  *HYBRID_VLM, *AUDIO])
def test_run_arch_smoke_matches_jax(arch, monkeypatch):
    jmasks, tmasks = [], []
    monkeypatch.setattr(jtrain, "make_strategy",
                        _recording(jtrain.make_strategy, jmasks))
    monkeypatch.setattr(ttrain, "make_strategy",
                        _recording(ttrain.make_strategy, tmasks))
    want = jtrain.run_arch_smoke(arch, rounds=3, log_fn=lambda *a: None)
    got = ttrain.run_arch_smoke(arch, rounds=3, log_fn=lambda *a: None,
                                device="cpu")
    assert len(tmasks) == len(jmasks) == 3
    for a, b in zip(tmasks, jmasks):
        assert a.tobytes() == b.tobytes()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b"])
def test_build_train_step_matches_jax_round(arch):
    """The round ``build_train_step`` builds (the arch's FedExec: parallel,
    remat per layer, Adam at 1e-3) at the smoke widths, one round of
    K = 2, E = 2, B = 1, S = 16 against JAX's ``make_fed_round`` of the
    same; the loss and the norms of Δ and of the gradients."""
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    tsmoke = dataclasses.replace(tspec, model=tspec.smoke_model)
    fed_round, opt, shapes = build_train_step(tsmoke, "train_4k")
    K, E, B, S = tspec.fed.cohort_size, tspec.fed.local_steps, 8, 4096
    assert shapes == {"tokens": ((K, E, B, S), torch.int32)}
    jcfg = jspec.smoke_model.replace(remat=jspec.fed.remat)
    japi = jget_model_api(jcfg)
    jopt = jmake_optimizer("adam", lr=1e-3)
    jround = jax.jit(jmake_fed_round(japi.loss_fn, jopt, mode="parallel"))
    jparams = japi.init_params(jax.random.PRNGKey(5))
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, (2, 2, 1, 16)).astype(np.int32)
    w = np.array([0.7, 0.3], np.float32)
    _, _, jm = jround(jparams, jopt.init(jparams),
                      {"tokens": jnp.asarray(toks)}, jnp.asarray(w),
                      jnp.asarray(1e-2, jnp.float32))
    tparams = _to_torch(jparams)
    _, _, tm = fed_round(tparams, opt.init(tparams),
                         {"tokens": torch.from_numpy(toks)},
                         torch.from_numpy(w), 1e-2)
    for f in ("loss", "delta_norm", "grad_norm"):
        _close(getattr(tm, f), getattr(jm, f))


def test_ssm_training_builds_for_cuda():
    """mamba2-2.7b's round builds at full size with nothing allocated
    (the batch is shapes only), and ``run_arch_smoke`` on CUDA gets as far
    as asking for the card: no refusal names a ROADMAP item."""
    fed_round, opt, shapes = build_train_step(
        tconfigs.get_arch("mamba2-2.7b"), "train_4k")
    assert callable(fed_round) and hasattr(opt, "init")
    assert tuple(shapes["tokens"].shape) == (32, 2, 8, 4096)
    assert shapes["tokens"].dtype == torch.int32
    if torch.cuda.is_available():
        pytest.skip("a card is present: run_arch_smoke would train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run_arch_smoke("mamba2-2.7b", device="cuda")
