"""The port's dense model zoo against the JAX package at the smoke configs
of its four dense archs: llama3.2-1b (2 layers, d 256, 8/2 heads, hd 32,
vocab 512, f32), qwen3-8b (the same widths with qk_norm), qwen3-14b
(d 320, 10/2 heads: a group of 5, qk_norm) and gemma-7b (d 256, 4/4
heads, hd 64, GeGLU, tied embeddings).  Configs, ``init_params``, the
whole model (``forward``, ``prefill``, 16 teacher-forced ``decode_step``s,
a sliding-window ring-buffer config), the ``serve`` prompt and
``convert`` round trips for each arch; the layers, the prefill step and
the deferred parts at llama's.  The full configs' parameter counts are
JAX's, counted on shapes alone.  The weights are JAX's, carried across
with ``repro_torch.convert``; inputs come from numpy with a seed.

Limits: 1e-4 on logits and 1e-5 on the KV cache in float32 (matmul
summation order differs between XLA's and torch's CPU kernels).  In
bfloat16 the logits are held to 2e-2 of their largest magnitude: at
max |logit| 4.44 the port is 0.0425 from JAX (0.96% of the scale), and
JAX is 0.0435 from itself between its jitted and its op-by-op
(``jax.disable_jit``) run of the same forward, because XLA's fusions drop
bf16 roundings that an eager run makes.  No eager spelling can meet 2e-2
absolute; the activations are spelled op for op as jax.nn spells them, so
that each op alone rounds as JAX's does.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch.specs import count_params  # noqa: E402
from repro.models import get_model_api as jget_model_api  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.models import get_model_api  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

JSPEC = jconfigs.get_arch("llama3.2-1b")
TSPEC = tconfigs.get_arch("llama3.2-1b")
SMOKE_J = JSPEC.smoke_model
SMOKE_T = TSPEC.smoke_model
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the JAX package's dense archs, all ported
DENSE = ["llama3.2-1b", "qwen3-8b", "qwen3-14b", "gemma-7b"]
# and its moe archs (tests/test_torch_moe.py holds their model)
MOE = ["mixtral-8x22b", "grok-1-314b"]
# JAX's parameter counts of the full configs
FULL_PARAMS = {"llama3.2-1b": 1_235_814_400, "qwen3-8b": 8_190_735_360,
               "qwen3-14b": 14_768_307_200, "gemma-7b": 8_537_680_896,
               "mixtral-8x22b": 140_630_071_296,
               "grok-1-314b": 316_489_340_928}


def _logits_close(got, want, dtype):
    """float32: |err| <= 1e-4; bfloat16: |err| <= 2e-2 * max|want|."""
    scale = 1.0 if dtype == "float32" else float(np.abs(_np(want)).max())
    assert _max_err(got, want) <= LOGIT_TOL[dtype] * scale


def _tcfg(jcfg):
    """The port's ModelConfig with every field of a JAX one."""
    return tL.ModelConfig(**dataclasses.asdict(jcfg))


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x)
                      else np.asarray(x, np.float32), np.float32)


def _max_err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _tokens(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    return (jnp.asarray(toks, jnp.int32),
            torch.from_numpy(toks.astype(np.int32)))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Each test on one intra-op thread.  The parameter draws are ~1,000
    small elementwise ops a chunk; with torch's default threads, test
    workers that share the cores spend most of their time in those ops'
    thread barriers (one draw test took minutes in a six-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _smoke_params(arch):
    """JAX's seed-0 parameters of ``arch``'s smoke config, and the port's
    copy of them."""
    jp = jT.init_params(jconfigs.get_arch(arch).smoke_model,
                        jax.random.PRNGKey(0))
    return jp, _to_torch(jp)


@pytest.fixture(scope="module")
def smoke_params():
    return _smoke_params("llama3.2-1b")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_configs_equal_field_by_field(arch):
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for attr in ("model", "smoke_model"):
        assert (dataclasses.asdict(getattr(tspec, attr))
                == dataclasses.asdict(getattr(jspec, attr)))
    for f in ("arch_id", "source", "notes"):
        assert getattr(tspec, f) == getattr(jspec, f)
    # the four input shapes are JAX's, and so is each shape's model (at
    # long_500k: the full model, or the long_context_window variant)
    assert tconfigs.INPUT_SHAPES == jconfigs.INPUT_SHAPES
    for shape in tconfigs.INPUT_SHAPES:
        assert (dataclasses.asdict(tspec.model_for_shape(shape))
                == dataclasses.asdict(jspec.model_for_shape(shape)))
    # the defaults of the dataclass too
    assert dataclasses.asdict(tL.ModelConfig()) == dataclasses.asdict(
        jL.ModelConfig())
    assert tspec.model.torch_dtype == torch.bfloat16


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_full_config_counts_jax_parameters(arch):
    """The full config's tree, counted on shapes alone: under
    ``shapes_only`` every drawn leaf is made empty on the meta device
    instead of drawn (the norms, zeros, are small), and JAX's count comes
    from ``eval_shape``."""
    cfg = tconfigs.get_arch(arch).model
    with tL.shapes_only():
        p = tT.init_params(cfg, jr.PRNGKey(0, device="cpu"), device="cpu")
    n = sum(t.numel() for t in jax.tree.leaves(p))
    assert n == count_params(jconfigs.get_arch(arch).model) \
        == FULL_PARAMS[arch]


def test_deferred_archs_raise_naming_their_item():
    """Nothing is deferred any more: every arch of the JAX package
    resolves, whisper-small (the last, the audio family) among them, to
    its JAX config field for field; an unknown name raises KeyError."""
    assert tconfigs.DEFERRED_ARCHS == ()
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    for arch in jconfigs.ARCHS:
        assert (dataclasses.asdict(tconfigs.get_arch(arch).model)
                == dataclasses.asdict(jconfigs.get_arch(arch).model))
    with pytest.raises(KeyError):
        tconfigs.get_arch("no-such-arch")


@pytest.mark.parametrize("arch", ["whisper-small"])
def test_other_families_raise_before_anything_is_built(arch):
    """The audio family is ``encdec``'s: ``get_model_api`` dispatches it
    there, and the decoder-only ``transformer`` refuses it before anything
    is drawn."""
    cfg = _tcfg(jconfigs.get_arch(arch).smoke_model)
    assert tT.DEFERRED_FAMILIES == ()
    assert get_model_api(cfg).module.__name__ == "repro_torch.models.encdec"
    with pytest.raises(KeyError, match="family 'audio'"):
        tT.init_params(cfg, jr.PRNGKey(0, device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32) * 3
    scale = rng.normal(size=256).astype(np.float32) * 0.1
    want = jL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = tL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    assert _max_err(got, want) < 1e-5


@pytest.mark.parametrize("hd", [32, 64])
def test_rotary_matches_jax_at_long_positions(hd):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(1, 8192, 2, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8192), (1, 8192)).astype(np.int32)
    want = jL.rotary(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    got = tL.rotary(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    # frequencies and angles are JAX's bit for bit; cos and sin differ by
    # at most an ulp or so between the two libraries
    assert _max_err(got, want) < 1e-5


def test_attention_block_matches_jax(smoke_params):
    jp, tp = smoke_params
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 48, SMOKE_J.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(48), (2, 48)).astype(np.int32)
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"])["attn"]
    tblk = tT._layer(tp["blocks"], 0)["attn"]
    for window in (0, 8):
        want = jL.attention_block(jblk, jnp.asarray(x), SMOKE_J,
                                  jnp.asarray(pos), window=window)
        got = tL.attention_block(tblk, torch.from_numpy(x), SMOKE_T,
                                 torch.from_numpy(pos), window=window)
        assert _max_err(got, want) < 1e-5


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_mlp_block_matches_jax(mlp):
    jcfg = SMOKE_J.replace(mlp=mlp)
    jp = jL.init_mlp(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(2).normal(
        size=(2, 7, jcfg.d_model)).astype(np.float32)
    want = jL.mlp_block(jp, jnp.asarray(x), jcfg)
    got = tL.mlp_block(_to_torch(jp), torch.from_numpy(x), _tcfg(jcfg))
    assert _max_err(got, want) < 1e-5


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("arch", DENSE)
def test_init_params_has_jax_shapes_dtypes_and_scales(arch, seed):
    """Every leaf, drawn or not, is JAX's byte for byte: the same key tree
    and XLA's normal (float32, and bfloat16 with an untied unembed)."""
    smoke = jconfigs.get_arch(arch).smoke_model
    for jcfg in (smoke, smoke.replace(dtype="bfloat16",
                                      tie_embeddings=False)):
        jp = jax.tree.map(np.asarray,
                          jT.init_params(jcfg, jax.random.PRNGKey(seed)))
        tp = params_to_numpy(tT.init_params(_tcfg(jcfg),
                                            jr.PRNGKey(seed, device="cpu"),
                                            device="cpu"))
        jl = jax.tree_util.tree_leaves_with_path(jp)
        tl = jax.tree_util.tree_leaves_with_path(tp)
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, a), (_, b) in zip(jl, tl):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_prefill_match_jax(arch, dtype):
    jcfg = jconfigs.get_arch(arch).smoke_model.replace(dtype=dtype)
    jp = jT.init_params(jcfg, jax.random.PRNGKey(1))
    tp, tcfg = _to_torch(jp), _tcfg(jcfg)
    jt, tt = _tokens(jcfg, 2, 40, 3)
    jlog, _ = jT.forward(jcfg, jp, {"tokens": jt})
    tlog, aux = tT.forward(tcfg, tp, {"tokens": tt})
    assert tlog.dtype == tcfg.torch_dtype and tlog.shape == (2, 40, 512)
    assert aux["text_mask"].all()
    _logits_close(tlog, jlog, dtype)
    jpre = jT.prefill(jcfg, jp, {"tokens": jt})
    tpre = tT.prefill(tcfg, tp, {"tokens": tt})
    assert tpre.shape == (2, 1, 512)
    _logits_close(tpre, jpre, dtype)


def _decode_both(jcfg, jp, tp, steps, max_len):
    """Teacher-forced decode in both packages; yields per-step
    (j_logits, t_logits, j_state, t_state)."""
    tcfg = _tcfg(jcfg)
    jt, tt = _tokens(jcfg, 2, steps, 4)
    jstate = jT.init_decode_state(jcfg, 2, max_len)
    tstate = tT.init_decode_state(tcfg, 2, max_len, device="cpu")
    jstep = jax.jit(lambda p, s, t: jT.decode_step(jcfg, p, s, t))
    for i in range(steps):
        jlog, jstate = jstep(jp, jstate, jt[:, i:i + 1])
        tlog, tstate = tT.decode_step(tcfg, tp, tstate, tt[:, i:i + 1])
        yield jlog, tlog, jstate, tstate


@pytest.mark.parametrize("window", [0, 8], ids=["full", "ring8"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_jax(arch, window):
    """16 teacher-forced steps; with window 8 and max_len 16 the cache is
    an 8-slot ring buffer that wraps twice."""
    smoke = jconfigs.get_arch(arch).smoke_model
    if window:
        jcfg = smoke.replace(sliding_window=window)
        jp = jT.init_params(jcfg, jax.random.PRNGKey(2))
        tp = _to_torch(jp)
    else:
        jcfg, (jp, tp) = smoke, _smoke_params(arch)
    for jlog, tlog, jst, tst in _decode_both(jcfg, jp, tp, 16, 16):
        assert _max_err(tlog, jlog) < 1e-4
        assert int(tst["index"]) == int(jst["index"])
        for n in ("k", "v"):
            assert tst["caches"][n].shape == jst["caches"][n].shape
            assert _max_err(tst["caches"][n], jst["caches"][n]) < 1e-5
    if window:
        assert tst["caches"]["k"].shape[2] == window


def test_window_forward_matches_jax():
    jcfg = SMOKE_J.replace(sliding_window=8)
    jp = jT.init_params(jcfg, jax.random.PRNGKey(5))
    jt, tt = _tokens(jcfg, 1, 32, 6)
    jlog, _ = jT.forward(jcfg, jp, {"tokens": jt})
    tlog, _ = tT.forward(_tcfg(jcfg), _to_torch(jp), {"tokens": tt})
    assert _max_err(tlog, jlog) < 1e-4


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_decode(arch):
    """prefill's last logits == stepping the prompt through decode_step."""
    _, tp = _smoke_params(arch)
    smoke = tconfigs.get_arch(arch).smoke_model
    _, tt = _tokens(smoke, 1, 24, 7)
    pre = tT.prefill(smoke, tp, {"tokens": tt})
    st = tT.init_decode_state(smoke, 1, 24, device="cpu")
    for i in range(24):
        lg, st = tT.decode_step(smoke, tp, st, tt[:, i:i + 1])
    assert _max_err(lg, pre) < 2e-3


def test_prefill_step_matches_jax(smoke_params):
    jp, tp = smoke_params
    arch = dataclasses.replace(TSPEC, model=SMOKE_T)
    prefill, shapes = build_prefill_step(arch, "prefill_32k")
    assert shapes == {"tokens": ((32, 32768), torch.int32)}
    jt, tt = _tokens(SMOKE_J, 2, 20, 8)
    want = jT.prefill(SMOKE_J, jp, {"tokens": jt})
    assert _max_err(prefill(tp, {"tokens": tt}), want) < 1e-4
    with pytest.raises(ValueError, match="build_decode_step"):
        build_prefill_step(arch, "decode_32k")


def test_get_model_api_matches_module(smoke_params):
    _, tp = smoke_params
    api = get_model_api(SMOKE_T)
    _, tt = _tokens(SMOKE_J, 1, 8, 9)
    log, _ = api.forward(tp, {"tokens": tt})
    # prefill unembeds the last row alone: a one-row product, which the CPU
    # BLAS may sum in another order than the full one
    assert _max_err(api.prefill(tp, {"tokens": tt}), log[:, -1:]) < 1e-5
    japi = jget_model_api(SMOKE_J)
    assert {"init_params", "forward", "init_decode_state",
            "decode_step"} <= set(vars(api)) & set(vars(japi))


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", DENSE)
def test_serve_prompt_is_jax_prompt(arch, seed):
    vocab = jconfigs.get_arch(arch).smoke_model.vocab
    _, _, jk = jax.random.split(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.randint(jk, (4, 16), 0, vocab))
    res = tserve.serve(arch, steps=3, seed=seed, device="cpu",
                       log_fn=lambda *a: None)
    assert res.prompt.dtype == want.dtype
    assert res.prompt.tobytes() == want.tobytes()
    assert res.tokens.shape == (4, 3)
    assert ((res.tokens >= 0) & (res.tokens < vocab)).all()


def test_serve_launches_no_flash_kernel():
    before = flash_attention.launches
    tserve.serve("llama3.2-1b", steps=2, device="cpu", log_fn=lambda *a: None)
    assert flash_attention.launches == before


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", DENSE)
def test_convert_round_trip_nested_byte_for_byte(arch, dtype):
    smoke = jconfigs.get_arch(arch).smoke_model
    jp = jT.init_params(smoke.replace(dtype=jnp.dtype(dtype).name),
                        jax.random.PRNGKey(4))
    src = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(params_from_numpy(src, device="cpu"))
    src_l = jax.tree_util.tree_leaves_with_path(src)
    back_l = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in src_l] == [p for p, _ in back_l]
    for (path, a), (_, b) in zip(src_l, back_l):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    t = params_from_numpy(src, device="cpu")
    assert t["blocks"]["attn"]["wq"].shape[0] == smoke.n_layers
    if smoke.qk_norm:
        assert t["blocks"]["attn"]["q_norm"].shape == (smoke.n_layers,
                                                       smoke.head_dim)
    if dtype == jnp.bfloat16:
        assert t["embed"].dtype == torch.bfloat16
        assert back["embed"].dtype == ml_dtypes.bfloat16
