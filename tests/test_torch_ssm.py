"""The port's Mamba-2 slice against the JAX package: the plain ``ssd_chunk``
(the kernel's CPU path) against the Pallas kernel in interpret mode and
``ref.ssd_chunk_ref``; the composed ``ssd`` against ``ops.ssd`` (the kernel
route) and the model's ``_ssd_chunked``; the convolutions, the mixer and
its decode step; the whole mamba2-2.7b smoke model (``forward``,
``prefill``, 16 ``decode_step``s); configs, parameters, ``convert`` and
``serve``.  The weights are JAX's, carried across with
``repro_torch.convert``; inputs come from numpy with a seed.

Limits: the kernel tests' 1e-4 (decays 1e-5 relative, 1e-6 absolute) on
the SSD pieces, the sequential recurrence's 1e-3, and 1e-4 on float32
logits (matmul and exp/log1p round differently in XLA's and torch's CPU
kernels).  In bfloat16 the logits are held to 2e-2 of their largest
magnitude, for the reason ``tests/test_torch_transformer.py`` gives: XLA's
fusions drop bf16 roundings that an eager run makes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk as jssd_chunk  # noqa: E402
from repro.launch.specs import count_params  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import ssm as jS  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd, ssd_chunk  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.models import get_model_api  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import ssm as tS  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

JSPEC = jconfigs.get_arch("mamba2-2.7b")
TSPEC = tconfigs.get_arch("mamba2-2.7b")
SMOKE_J = JSPEC.smoke_model
SMOKE_T = TSPEC.smoke_model
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (B, S, H, P, N, chunk): tests/test_kernels.py::test_ssd_chunk_allclose
SSD_SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
              (1, 256, 2, 64, 128, 128)]
# the ssm case of tests/test_models_consistency.py
SSM_CASE = tL.ModelConfig(name="ssm", family="ssm", n_layers=2, d_model=64,
                          vocab=100, ssm_state=16, ssm_head_dim=16,
                          ssm_chunk=8)


def _tcfg(jcfg):
    return tL.ModelConfig(**dataclasses.asdict(jcfg))


def _jcfg(tcfg):
    return jL.ModelConfig(**dataclasses.asdict(tcfg))


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x)
                      else np.asarray(x, np.float32), np.float32)


def _max_err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _logits_close(got, want, dtype):
    scale = 1.0 if dtype == "float32" else float(np.abs(_np(want)).max())
    assert _max_err(got, want) <= LOGIT_TOL[dtype] * scale


def _ssd_inputs(B, S, H, N, P, seed):
    """The JAX kernel tests' recipe: x, B, C ~ N(0, 1), dt = softplus(N(0,
    1)), A = -exp(0.3 N(0, 1))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(B, S, H)), 0).astype(np.float32)
    A = (-np.exp(0.3 * rng.normal(size=H))).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _chunked(arrays, B, S, H, N, P, chunk):
    nc = S // chunk
    x, dt, A, Bm, Cm = arrays
    return (x.reshape(B, nc, chunk, H, P), dt.reshape(B, nc, chunk, H), A,
            Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N))


def _tokens(vocab, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
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


@pytest.fixture(scope="module")
def smoke_params():
    jp = jT.init_params(SMOKE_J, jax.random.PRNGKey(0))
    return jp, _to_torch(jp)


# ---------------------------------------------------------------------------
# the SSD pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_chunk_plain_matches_jax_kernel(B, S, H, P, N, chunk):
    arrs = _chunked(_ssd_inputs(B, S, H, N, P, S + H), B, S, H, N, P, chunk)
    jin = [jnp.asarray(a) for a in arrs]
    tin = [torch.from_numpy(a) for a in arrs]
    kernel = jssd_chunk(*jin, interpret=True)
    oracle = jref.ssd_chunk_ref(*jin)
    before = ssd_chunk.launches
    for got in (tref.ssd_chunk_ref(*tin), ssd_chunk(*tin)):
        for want in (kernel, oracle):
            _close(got[0], want[0], 1e-4)            # y_intra
            _close(got[1], want[1], 1e-4)            # states
            np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5,
                                       atol=1e-6)    # decays
        assert [tuple(t.shape) for t in got] == [tuple(np.shape(w))
                                                 for w in kernel]
        assert all(t.dtype == torch.float32 for t in got)
    assert ssd_chunk.launches == before          # the CPU path launches none


def test_ssd_matches_jax_routes_and_the_recurrence():
    """The JAX test's shape: the port's ssd against ops.ssd (Pallas kernel
    in interpret mode + lax.scan), the model's _ssd_chunked and the
    sequential recurrence."""
    B, S, H, P, N, chunk = 2, 64, 3, 16, 8, 16
    arrs = _ssd_inputs(B, S, H, N, P, 9)
    jin = [jnp.asarray(a) for a in arrs]
    got = ssd(*[torch.from_numpy(a) for a in arrs], chunk)
    _close(got, jops.ssd(*jin, chunk=chunk, use_kernel=True), 1e-4)
    _close(got, jS._ssd_chunked(*jin, chunk), 1e-4)
    _close(tref.ssd_ref(*[torch.from_numpy(a) for a in arrs], chunk), got,
           1e-4)
    x, dt, A, Bm, Cm = (a.astype(np.float64) for a in arrs)
    h = np.zeros((B, H, N, P))
    ys = []
    for t in range(S):
        dec = np.exp(dt[:, t] * A[None, :])
        h = h * dec[..., None, None] + np.einsum("bh,bn,bhp->bhnp", dt[:, t],
                                                 Bm[:, t], x[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", Cm[:, t], h))
    _close(got, np.stack(ys, 1), 1e-3)


def test_ssd_bf16_matches_jax():
    """bf16 x, Bm, Cm: float32 inside both, one rounding of y to bf16, so
    the two agree within one bf16 step (2^-7 of the value) plus float32
    summation order."""
    B, S, H, P, N, chunk = 2, 64, 4, 32, 16, 16
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, N, P, 11)
    bf = [a.astype(ml_dtypes.bfloat16) for a in (x, Bm, Cm)]
    want = jops.ssd(jnp.asarray(bf[0]), jnp.asarray(dt), jnp.asarray(A),
                    jnp.asarray(bf[1]), jnp.asarray(bf[2]), chunk=chunk,
                    use_kernel=True)
    tb = params_from_numpy({"x": bf[0], "b": bf[1], "c": bf[2]},
                           device="cpu")
    got = ssd(tb["x"], torch.from_numpy(dt), torch.from_numpy(A), tb["b"],
              tb["c"], chunk)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    diff = np.abs(_np(got) - _np(want))
    assert (diff <= 2.0 ** -7 * np.abs(_np(want)) + 1e-4).all()


def test_ssd_rejects_a_ragged_sequence():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _ssd_inputs(1, 24, 2, 8, 16, 0))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(x, dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tref.ssd_ref(x, dt, A, Bm, Cm, 16)


def test_ssd_chunk_raises_off_cpu_and_cuda():
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to("meta") for a in _chunked(
        _ssd_inputs(1, 16, 2, 8, 16, 0), 1, 16, 2, 8, 16, 8))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        ssd_chunk(x, dt, A, Bm, Cm)


def test_ssd_chunk_reads_a_strided_x_on_the_cpu():
    """x as the model passes it: a view of a wider (B, S, conv_dim) row."""
    B, S, H, P, N, chunk = 1, 32, 4, 16, 8, 8
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, N, P, 5)
    wide = np.concatenate([x.reshape(B, S, H * P), Bm, Cm], -1)
    xv = torch.from_numpy(wide)[..., :H * P].reshape(B, S, H, P)
    assert not xv.is_contiguous()
    got = ssd(xv, torch.from_numpy(dt), torch.from_numpy(A),
              torch.from_numpy(Bm), torch.from_numpy(Cm), chunk)
    want = ssd(*[torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)], chunk)
    assert got.numpy().tobytes() == want.numpy().tobytes()


# ---------------------------------------------------------------------------
# conv, mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(dtype):
    rng = np.random.default_rng(1)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    x = rng.normal(size=(2, 13, 40)).astype(npdt)
    w = (rng.normal(size=(4, 40)) * 0.1).astype(x.dtype)
    b = rng.normal(size=40).astype(x.dtype)
    want = jS.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    t = params_from_numpy({"x": x, "w": w, "b": b}, device="cpu")
    got = tS.causal_conv1d(t["x"], t["w"], t["b"])
    # op by op, in JAX's order: the same roundings in both dtypes
    assert got.dtype == t["x"].dtype
    assert _np(got).tobytes() == _np(want).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_step_matches_jax(dtype):
    rng = np.random.default_rng(2)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    x = rng.normal(size=(3, 1, 24)).astype(npdt)
    state = rng.normal(size=(3, 3, 24)).astype(npdt)
    w = (rng.normal(size=(4, 24)) * 0.1).astype(npdt)
    b = rng.normal(size=24).astype(npdt)
    jy, jst = jS.causal_conv1d_step(*(jnp.asarray(a)
                                      for a in (x, state, w, b)))
    t = params_from_numpy({"x": x, "s": state, "w": w, "b": b}, device="cpu")
    ty, tst = tS.causal_conv1d_step(t["x"], t["s"], t["w"], t["b"])
    assert ty.dtype == t["x"].dtype and tuple(tst.shape) == (3, 3, 24)
    assert _np(tst).tobytes() == _np(jst).tobytes()
    # one rounding of a float32 sum of 4 taps: at most one output step
    step = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -23
    assert (np.abs(_np(ty) - _np(jy)) <= step * np.abs(_np(jy)) + 1e-6).all()


def _mixer(jp, tp):
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"])["mixer"]
    return jblk, tT._layer(tp["blocks"], 0)["mixer"]


def test_mamba2_block_matches_both_jax_routes(smoke_params):
    jblk, tblk = _mixer(*smoke_params)
    x = np.random.default_rng(3).normal(
        size=(2, 24, SMOKE_J.d_model)).astype(np.float32)
    got = tS.mamba2_block(tblk, torch.from_numpy(x), SMOKE_T)
    for use_kernel in (False, True):
        want = jS.mamba2_block(jblk, jnp.asarray(x), SMOKE_J,
                               use_kernel=use_kernel)
        assert _max_err(got, want) < 1e-5


def test_mamba2_decode_matches_jax(smoke_params):
    jblk, tblk = _mixer(*smoke_params)
    rng = np.random.default_rng(4)
    jst = jS.mamba2_init_state(SMOKE_J, 2, jnp.float32)
    tst = tS.mamba2_init_state(SMOKE_T, 2, torch.float32, "cpu")
    for _ in range(6):
        x = rng.normal(size=(2, 1, SMOKE_J.d_model)).astype(np.float32)
        jy, jst = jS.mamba2_decode(jblk, jnp.asarray(x), SMOKE_J, jst)
        ty, tst = tS.mamba2_decode(tblk, torch.from_numpy(x), SMOKE_T, tst)
        assert _max_err(ty, jy) < 1e-5
        for n in ("ssm", "conv"):
            assert tuple(tst[n].shape) == jst[n].shape
            assert _max_err(tst[n], jst[n]) < 1e-5


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def test_config_equals_jax_field_by_field():
    for attr in ("model", "smoke_model"):
        assert (dataclasses.asdict(getattr(TSPEC, attr))
                == dataclasses.asdict(getattr(JSPEC, attr)))
    for f in ("arch_id", "source", "notes"):
        assert getattr(TSPEC, f) == getattr(JSPEC, f)
    assert TSPEC.model.torch_dtype == torch.bfloat16
    assert get_model_api(SMOKE_T).module is tT


def test_full_config_counts_jax_parameters():
    """2,702,579,200, counted on shapes alone (fake tensors)."""
    with FakeTensorMode():
        key = jr.PRNGKey(0, device="cpu")
        p = tT.init_params(TSPEC.model, key, device="cpu")
    n = sum(t.numel() for t in jax.tree.leaves(p))
    assert n == count_params(JSPEC.model) == 2_702_579_200


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_jax_tree_and_leaves(dtype, seed):
    """Every drawn leaf (in_proj, conv_w, out_proj, embed, unembed) is
    JAX's byte for byte; A_log is within an ulp, the rest exact."""
    jcfg = SMOKE_J.replace(dtype=dtype)
    jp = jax.tree.map(np.asarray, jT.init_params(jcfg,
                                                 jax.random.PRNGKey(seed)))
    tp = params_to_numpy(tT.init_params(_tcfg(jcfg),
                                        jr.PRNGKey(seed, device="cpu"),
                                        device="cpu"))
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        name = jax.tree_util.keystr(path[-1:])[2:-2]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if name == "A_log":
            # torch's and XLA's linspace and log round differently
            ulps = np.abs(a.view(np.int32).astype(np.int64)
                          - b.view(np.int32).astype(np.int64))
            assert ulps.max() <= 1, path
        else:
            assert a.tobytes() == b.tobytes(), path


def test_a_log_within_an_ulp_at_80_heads():
    """init_mamba2's A_log at the full config's 80 heads (narrow widths
    otherwise: d_model 160, head_dim 4)."""
    jcfg = JSPEC.model.replace(d_model=160, ssm_head_dim=4, ssm_state=8,
                               dtype="float32")
    want = np.asarray(jS.init_mamba2(jax.random.PRNGKey(0), jcfg)["A_log"])
    got = tS.init_mamba2(jr.PRNGKey(0, device="cpu"),
                         _tcfg(jcfg))["A_log"].numpy()
    assert got.shape == want.shape == (80,)
    ulps = np.abs(want.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_jax(dtype):
    jcfg = SMOKE_J.replace(dtype=dtype)
    jp = jT.init_params(jcfg, jax.random.PRNGKey(1))
    tp, tcfg = _to_torch(jp), _tcfg(jcfg)
    jt, tt = _tokens(jcfg.vocab, 2, 40, 3)
    jlog, _ = jT.forward(jcfg, jp, {"tokens": jt})
    tlog, aux = tT.forward(tcfg, tp, {"tokens": tt})
    assert tlog.dtype == tcfg.torch_dtype and tlog.shape == (2, 40, 512)
    assert aux["text_mask"].all()
    _logits_close(tlog, jlog, dtype)
    jpre = jT.prefill(jcfg, jp, {"tokens": jt})
    tpre = tT.prefill(tcfg, tp, {"tokens": tt})
    assert tpre.shape == (2, 1, 512)
    _logits_close(tpre, jpre, dtype)


def test_decode_steps_match_jax(smoke_params):
    jp, tp = smoke_params
    jt, tt = _tokens(SMOKE_J.vocab, 2, 16, 4)
    jstate = jT.init_decode_state(SMOKE_J, 2, 16)
    tstate = tT.init_decode_state(SMOKE_T, 2, 16, device="cpu")
    jstep = jax.jit(lambda p, s, t: jT.decode_step(SMOKE_J, p, s, t))
    for i in range(16):
        jlog, jstate = jstep(jp, jstate, jt[:, i:i + 1])
        tlog, tstate = tT.decode_step(SMOKE_T, tp, tstate, tt[:, i:i + 1])
        assert _max_err(tlog, jlog) < 1e-4
        assert int(tstate["index"]) == int(jstate["index"])
        for n in ("ssm", "conv"):
            assert tstate["caches"][n].shape == jstate["caches"][n].shape
            assert _max_err(tstate["caches"][n], jstate["caches"][n]) < 1e-5


def test_decode_matches_forward_at_the_consistency_case():
    """The ssm case of tests/test_models_consistency.py: stepping the
    sequence through decode_step gives forward's logits within 2e-3."""
    jp = jT.init_params(_jcfg(SSM_CASE), jax.random.PRNGKey(7))
    tp = _to_torch(jp)
    _, tt = _tokens(SSM_CASE.vocab, 2, 16, 7)
    full, _ = tT.forward(SSM_CASE, tp, {"tokens": tt})
    st = tT.init_decode_state(SSM_CASE, 2, 16, device="cpu")
    outs = []
    for t in range(16):
        lg, st = tT.decode_step(SSM_CASE, tp, st, tt[:, t:t + 1])
        outs.append(lg)
    assert _max_err(torch.cat(outs, dim=1), full) < 2e-3


def test_prefill_step_matches_jax(smoke_params):
    jp, tp = smoke_params
    arch = dataclasses.replace(TSPEC, model=SMOKE_T)
    prefill, shapes = build_prefill_step(arch, "prefill_32k")
    assert shapes == {"tokens": ((32, 32768), torch.int32)}
    jt, tt = _tokens(SMOKE_J.vocab, 2, 24, 8)
    want = jT.prefill(SMOKE_J, jp, {"tokens": jt})
    assert _max_err(prefill(tp, {"tokens": tt}), want) < 1e-4


# ---------------------------------------------------------------------------
# serve, convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_serve_prompt_is_jax_prompt_and_launches_no_kernel(seed):
    _, _, jk = jax.random.split(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.randint(jk, (4, 16), 0, SMOKE_J.vocab))
    before = ssd_chunk.launches
    res = tserve.serve("mamba2-2.7b", steps=3, seed=seed, device="cpu",
                       log_fn=lambda *a: None)
    assert ssd_chunk.launches == before
    assert res.prompt.tobytes() == want.tobytes()
    assert res.tokens.shape == (4, 3)
    assert ((res.tokens >= 0) & (res.tokens < SMOKE_J.vocab)).all()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_convert_round_trips_the_mamba2_tree(dtype):
    jp = jT.init_params(SMOKE_J.replace(dtype=jnp.dtype(dtype).name),
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
    assert t["blocks"]["mixer"]["in_proj"].shape[0] == SMOKE_J.n_layers
    assert t["blocks"]["mixer"]["A_log"].dtype == torch.float32
