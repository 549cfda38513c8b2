"""The decode input shapes (``decode_32k``, ``long_500k``) against the JAX
package, on the CPU.

* ``INPUT_SHAPES``, ``ArchSpec.model_for_shape`` and ``supported_shapes``
  are JAX's for all ten archs and four shapes: ``long_500k`` takes the
  full model (native), the ``long_context_window`` variant (swa_variant)
  or nothing (whisper-small skips it).
* ``launch.specs.decode_tok_specs`` and ``decode_state_specs`` equal
  ``jax.eval_shape``'s shapes and dtypes, leaf for leaf, for every (arch,
  decode shape) that JAX supports, at the full configs (nothing is
  allocated: the state is built under ``FakeTensorMode``).
* ``launch.steps.build_decode_step`` at the smoke configs: the state made
  from its shapes (zeros) and stepped 24 tokens against JAX's
  ``decode_step`` of the same config, logits and state within 1e-5 —
  llama3.2-1b at both shapes (at ``long_500k`` a window of 8, so the ring
  of 8 slots wraps three times), mamba2-2.7b and recurrentgemma-2b
  (native), mixtral-8x22b (native: its window of 16, a ring that wraps)
  and whisper-small (its cross K/V from ``encdec.prefill``).  The shapes
  are cut to 24 tokens and batch 2 for the CPU.
* ``build_step`` dispatches by kind; a skipped shape raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import get_model_api as jget_model_api  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import common as tcommon  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import get_model_api  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = sorted(jconfigs.ARCHS)
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DECODE = ("decode_32k", "long_500k")
TOL = 1e-5
STEPS, BATCH = 24, 2


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    """[(path, shape, dtype name)] of a JAX tree or the port's ShapeDtype
    tree, in JAX's order."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", s, d) for k in sorted(tree)
                for p, s, d in _leaves(tree[k])]
    return [("", tuple(tree.shape), str(tree.dtype).split(".")[-1])]


def test_input_shapes_are_jax():
    assert tconfigs.INPUT_SHAPES == jconfigs.INPUT_SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_model_for_shape_and_supported_shapes_match_jax(arch):
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for shape in SHAPES:
        want, got = jspec.model_for_shape(shape), tspec.model_for_shape(shape)
        assert (got is None) == (want is None), shape
        if want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want), shape
    assert tspec.supported_shapes() == jspec.supported_shapes()
    with pytest.raises(KeyError):
        tspec.model_for_shape("no_such_shape")


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ARCHS for s in DECODE
    if jconfigs.get_arch(a).model_for_shape(s) is not None])
def test_decode_specs_match_eval_shape(arch, shape):
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    want = jspecs.decode_state_specs(jspec, shape)
    got = tspecs.decode_state_specs(tspec, shape)
    assert _leaves(got) == _leaves(want)
    tok, jtok = tspecs.decode_tok_specs(tspec, shape), \
        jspecs.decode_tok_specs(jspec, shape)
    assert (tok.shape, str(tok.dtype).split(".")[-1]) \
        == (tuple(jtok.shape), str(jtok.dtype))


def test_skipped_shape_and_wrong_kinds_raise():
    whisper = tconfigs.get_arch("whisper-small")
    with pytest.raises(ValueError, match="skips 'long_500k'"):
        tsteps.build_decode_step(whisper, "long_500k")
    with pytest.raises(ValueError, match="build_prefill_step"):
        tsteps.build_decode_step(whisper, "prefill_32k")
    with pytest.raises(ValueError, match="build_decode_step"):
        tsteps.build_prefill_step(whisper, "decode_32k")


def test_build_step_dispatches_by_kind():
    spec = tconfigs.get_arch("llama3.2-1b")
    _, opt, shapes = tsteps.build_step(spec, "train_4k")
    assert shapes["tokens"].shape == (32, 2, 8, 4096) and hasattr(opt, "init")
    _, shapes = tsteps.build_step(spec, "prefill_32k")
    assert shapes["tokens"].shape == (32, 32768)
    _, state, tok = tsteps.build_step(spec, "long_500k")
    assert tok.shape == (1, 1)
    # the swa_variant's ring of long_context_window (8,192) slots
    assert state["caches"]["k"].shape == (16, 1, 8192, 8, 64)


# ---------------------------------------------------------------------------
# build_decode_step's step against JAX's decode_step
# ---------------------------------------------------------------------------

# (arch, shape, long_context_window): llama's swa_variant cut to a window
# of 8 at long_500k, so its ring wraps within the 24 steps
STEP_CASES = [("llama3.2-1b", "decode_32k", None),
              ("llama3.2-1b", "long_500k", 8),
              ("mamba2-2.7b", "long_500k", None),
              ("recurrentgemma-2b", "long_500k", None),
              ("mixtral-8x22b", "long_500k", None),
              ("whisper-small", "decode_32k", None)]


def _smoke_spec(pkg, arch, window):
    spec = pkg.get_arch(arch)
    spec = dataclasses.replace(spec, model=spec.smoke_model)
    if window:
        spec = dataclasses.replace(spec, long_context_window=window)
    return spec


def _zeros(shapes):
    if isinstance(shapes, dict):
        return {k: _zeros(v) for k, v in shapes.items()}
    return torch.zeros(shapes.shape, dtype=shapes.dtype)


@pytest.mark.parametrize("arch,shape,window", STEP_CASES)
def test_build_decode_step_matches_jax(arch, shape, window, monkeypatch):
    cut = dict(tconfigs.INPUT_SHAPES[shape], seq_len=STEPS,
               global_batch=BATCH)
    monkeypatch.setitem(tcommon.INPUT_SHAPES, shape, cut)
    tspec = _smoke_spec(tconfigs, arch, window)
    jspec = _smoke_spec(jconfigs, arch, window)
    step, state_shapes, tok_shape = tsteps.build_decode_step(tspec, shape)
    assert tok_shape.shape == (BATCH, 1)
    jcfg = jspec.model_for_shape(shape)
    japi = jget_model_api(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(2))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jstate = japi.init_decode_state(BATCH, STEPS)
    tstate = _zeros(state_shapes)
    assert _leaves(tstate) == _leaves(jstate)
    rng = np.random.default_rng(len(arch) + STEPS)
    if jcfg.family == "audio":
        frames = rng.normal(size=(BATCH, jcfg.enc_seq, jcfg.d_model)
                            ).astype(np.float32)
        jstate = japi.module.prefill(jcfg, jparams,
                                     {"frames": jnp.asarray(frames)}, jstate)
        tcfg = tspec.model_for_shape(shape)
        tstate = get_model_api(tcfg).module.prefill(
            tcfg, tparams, {"frames": torch.from_numpy(frames)}, tstate)
    toks = rng.integers(0, jcfg.vocab, (BATCH, STEPS)).astype(np.int32)
    jstep = jax.jit(japi.decode_step)
    for i in range(STEPS):
        jlog, jstate = jstep(jparams, jstate, jnp.asarray(toks[:, i:i + 1]))
        tlog, tstate = step(tparams, tstate,
                            torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=TOL, atol=TOL)
    assert int(tstate["index"]) == STEPS
    for g, w in zip(tree_leaves(tstate), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=TOL,
                                   atol=TOL)
