"""The gradient of the port's Mamba-2 SSD on the CPU: the hand-derived
``ref.ssd_chunk_bwd`` (the ``ssd_chunk_bwd`` kernel's plain version, which
the CPU path of ``ssd_chunk``'s autograd Function runs) against
``torch.autograd`` of ``ref.ssd_chunk_ref``; ``ssd``'s gradient against
``jax.vjp`` of the model's ``_ssd_chunked``; ``mamba2_block``'s parameter
gradients against ``jax.grad`` of JAX's; the vmap rules, with A mapped
(each client's own A, from the second local step on) and not, against a
loop over clients.  Inputs and cotangents come from numpy with a seed.

Limits, each the largest gap over the reference's largest magnitude:
1e-10 in float64 and 1e-5 in float32 against autograd (the same
arithmetic in another order; dA, a sum over every position, cancels
most); 1e-5 against JAX (float32 in both, XLA's and torch's CPU kernels
round differently; JAX's own ``ssd_chunk_ref`` masks after its exp and has
no finite gradient, so the model's ``_ssd_chunked`` is the reference),
except where JAX's float32 gradient is itself further than that from the
float64 gradient of the SSM run as a recurrence over positions: dA at
Q = N = 128 (6.2e-5 off it; no float32 result can be held within 1e-5 of
JAX's there) and A_log through the mixer (1.0e-5), where the port's must
be at least as close to the float64 gradient as JAX's is; 1e-6 for the
vmap rules against the loop (the same plain code at another batch size).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, vmap  # noqa: E402
from torch_parity import one_intra_op_thread  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import ssm as jS  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd, ssd_chunk, ssd_chunk_bwd  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import ssm as tS  # noqa: E402

# (B, nc, Q, H, P, N): tests/test_kernels.py's three, the mamba2 smoke
# config's at S = 64, and a ragged one (no dimension a multiple of 4)
SHAPES = [(1, 4, 16, 2, 16, 8), (2, 4, 32, 4, 32, 16), (1, 2, 128, 2, 64, 128),
          (1, 8, 8, 8, 32, 16), (2, 3, 13, 3, 10, 7)]
AUTOGRAD_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
JAX_TOL = 1e-5
VMAP_TOL = 1e-6
SMOKE = jconfigs.get_arch("mamba2-2.7b").smoke_model
# the ssm case of tests/test_models_consistency.py
SSM_CASE = jL.ModelConfig(name="ssm", family="ssm", n_layers=2, d_model=64,
                          vocab=100, ssm_state=16, ssm_head_dim=16,
                          ssm_chunk=8)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def _rel(got, want) -> float:
    got, want = (np.asarray(t.double().numpy() if torch.is_tensor(t) else t,
                            np.float64) for t in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _chunk_inputs(shape, seed, *, a_rows=False):
    """x, dt, A, Bm, Cm (the JAX kernel tests' recipe) and the cotangents
    dy, dstates, ddecays, all float64 numpy."""
    B, nc, Q, H, P, N = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, nc, Q, H, P))
    dt = np.logaddexp(rng.normal(size=(B, nc, Q, H)), 0)
    A = -np.exp(0.3 * rng.normal(size=(B, H) if a_rows else (H,)))
    Bm = rng.normal(size=(B, nc, Q, N))
    Cm = rng.normal(size=(B, nc, Q, N))
    cots = (rng.normal(size=(B, nc, Q, H, P)), rng.normal(size=(B, nc, H, N, P)),
            rng.normal(size=(B, nc, H)))
    return (x, dt, A, Bm, Cm), cots


def _t(arrays, dtype):
    return [torch.from_numpy(np.asarray(a)).to(dtype) for a in arrays]


# ---------------------------------------------------------------------------
# the hand-derived backward against autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_autograd(shape, dtype):
    ins, cots = _chunk_inputs(shape, sum(shape))
    ins, cots = _t(ins, dtype), _t(cots, dtype)
    leaves = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(tref.ssd_chunk_ref(*leaves), leaves, cots)
    got = tref.ssd_chunk_bwd(*ins, *cots)
    for name, g, w in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        assert _rel(g, w) <= AUTOGRAD_TOL[dtype], (name, _rel(g, w))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_plain_backward_per_row_a_and_missing_cotangents(dtype):
    """A one row per batch row (dA per row), and None for the states' and
    decays' gradients (zeros, as autograd gives an unused output)."""
    shape = (3, 2, 13, 3, 10, 7)
    ins, cots = _chunk_inputs(shape, 7, a_rows=True)
    ins, cots = _t(ins, dtype), _t(cots, dtype)
    leaves = [t.clone().requires_grad_() for t in ins]
    y, _, _ = tref.ssd_chunk_ref(*leaves)
    want = torch.autograd.grad(y, leaves, cots[0])
    got = tref.ssd_chunk_bwd(*ins, cots[0], None, None)
    assert got[2].shape == (3, 3)
    for g, w in zip(got, want):
        assert _rel(g, w) <= AUTOGRAD_TOL[dtype]


def test_bf16_inputs_give_bf16_gradients():
    ins, cots = _chunk_inputs((1, 2, 16, 2, 8, 8), 3)
    x, dt, A, Bm, Cm = _t(ins, torch.float32)
    bf = [t.to(torch.bfloat16) for t in (x, Bm, Cm)]
    got = tref.ssd_chunk_bwd(bf[0], dt, A, bf[1], bf[2],
                             *_t(cots, torch.float32))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    want = tref.ssd_chunk_bwd(bf[0].float(), dt, A, bf[1].float(),
                              bf[2].float(), *_t(cots, torch.float32))
    for g, w in zip(got, want):    # one rounding to bf16 of the same values
        assert torch.equal(g, w.to(g.dtype))


def test_wrapper_runs_the_plain_backward_on_the_cpu():
    ins, cots = _t(_chunk_inputs((1, 2, 8, 2, 8, 4), 1)[0], torch.float32), \
        _t(_chunk_inputs((1, 2, 8, 2, 8, 4), 1)[1], torch.float32)
    before = ssd_chunk_bwd.launches
    got = ssd_chunk_bwd(*ins, *cots)
    want = tref.ssd_chunk_bwd(*ins, *cots)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ssd_chunk_bwd.launches == before       # the CPU path launches none
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        ssd_chunk_bwd(*(t.to("meta") for t in ins + cots))


def test_one_chunk_gradient_passes_none_for_the_unread_outputs(monkeypatch):
    """A one-chunk ``ssd`` reads neither the states nor the decays: autograd
    hands the backward None for both (no zeros made), under ``grad`` and
    under ``vmap(grad)``, and the gradient is autograd's of the plain
    forward."""
    seen = []
    plain_bwd = tref.ssd_chunk_bwd

    def spy(*args):
        seen.append(tuple(t is None for t in args[5:]))
        return plain_bwd(*args)

    monkeypatch.setattr(tref, "ssd_chunk_bwd", spy)
    (x, dt, A, Bm, Cm), _ = _chunk_inputs((2, 1, 8, 4, 8, 6), 11)
    cot = np.random.default_rng(12).normal(size=x.shape)
    x, dt, A, Bm, Cm, cot = _t((x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                cot[:, 0]), torch.float32)
    g = grad(lambda *a: (ssd(*a, 8) * cot).sum(), argnums=(0, 1, 2, 3, 4))
    got = g(x, dt, A, Bm, Cm)
    assert seen == [(False, True, True)]
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, _, _ = tref.ssd_chunk_ref(*(t.unsqueeze(1) if t.dim() > 1 else t
                                   for t in leaves))
    want = torch.autograd.grad(y.squeeze(1), leaves, cot)
    for g_, w in zip(got, want):
        assert _rel(g_, w) <= AUTOGRAD_TOL[torch.float32]
    seen.clear()
    stack = [torch.stack([t, 2 * t]) for t in (x, dt, A, Bm, Cm)]
    mapped = vmap(g)(*stack)
    assert seen == [(False, True, True)]            # one call for the cohort
    for i in range(2):
        for m, l in zip(mapped, g(*(t[i] for t in stack))):
            assert _rel(m[i], l) <= VMAP_TOL


# ---------------------------------------------------------------------------
# ssd and mamba2_block against JAX
# ---------------------------------------------------------------------------


def _recurrence(x, dt, A, Bm, Cm):
    """The SSM position by position, the form independent of the chunked
    dual: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t . h_t."""
    h = x.new_zeros(x.shape[0], x.shape[2], Bm.shape[-1], x.shape[3])
    ys = []
    for t in range(x.shape[1]):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], h))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 128, 128),
    (1, 64, 8, 32, 16, 8)], ids=str)
def test_ssd_gradient_matches_jax(B, S, H, P, N, chunk):
    rng = np.random.default_rng(S + H)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(B, S, H)), 0).astype(np.float32)
    A = (-np.exp(0.3 * rng.normal(size=H))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32) for _ in "BC")
    cot = rng.normal(size=(B, S, H, P)).astype(np.float32)
    arrays = (x, dt, A, Bm, Cm)
    want = jax.jit(lambda c, *a: jax.vjp(
        lambda *b: jS._ssd_chunked(*b, chunk), *a)[1](c))(
        jnp.asarray(cot), *(jnp.asarray(a) for a in arrays))
    got = grad(lambda *a: (ssd(*a, chunk) * torch.from_numpy(cot)).sum(),
               argnums=(0, 1, 2, 3, 4))(*_t(arrays, torch.float32))
    exact = grad(lambda *a: (_recurrence(*a) * torch.from_numpy(cot)).sum(),
                 argnums=(0, 1, 2, 3, 4))(*_t(arrays, torch.float64))
    for name, g, w, e in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want,
                             exact):
        assert tuple(g.shape) == w.shape, name
        print(f"{name}: port {_rel(g, e):.2e}, JAX {_rel(w, e):.2e} off the "
              f"float64 gradient")
        if name == "dA" and chunk == N == 128:     # JAX's is 6.2e-5 off
            assert _rel(g, e) <= _rel(w, e), (name, _rel(g, w), _rel(g, e))
        else:
            assert _rel(g, w) <= JAX_TOL, (name, _rel(g, e), _rel(w, e))


def _mixer64(p, x, cfg):
    """``mamba2_block`` in float64 with the SSD as the recurrence."""
    d_inner, H, _ = tS.mamba2_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    z, xbc, dt = tS._split_proj(x @ p["in_proj"], cfg)
    xbc = tL._silu(tS.causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    xh = xbc[..., :d_inner].reshape(*x.shape[:2], H, P)
    y = _recurrence(xh, tL._softplus(dt + p["dt_bias"]), -torch.exp(p["A_log"]),
                    xbc[..., d_inner:d_inner + N], xbc[..., d_inner + N:])
    y = (y + xh * p["D"][:, None]).reshape(*x.shape[:2], d_inner) * tL._silu(z)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + cfg.norm_eps)
    return (y * (1.0 + p["norm"])) @ p["out_proj"]


@pytest.mark.parametrize("cfg", [SMOKE, SSM_CASE], ids=["smoke", "ssm_case"])
def test_mamba2_block_gradient_matches_jax(cfg):
    """Every parameter's gradient of sum(mamba2_block(p, x) * cot), float32,
    JAX's drawn mixer carried across."""
    jp = jS.init_mamba2(jax.random.PRNGKey(3), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = tL.ModelConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 4 * cfg.ssm_chunk, cfg.d_model)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(
        jS.mamba2_block(p, jnp.asarray(x), cfg) * cot)))(jp)
    got = grad(lambda p: (tS.mamba2_block(p, torch.from_numpy(x), tcfg)
                          * torch.from_numpy(cot)).sum())(tp)
    exact = grad(lambda p: (_mixer64(p, torch.from_numpy(x).double(), tcfg)
                            * torch.from_numpy(cot).double()).sum())(
        {k: v.double() for k, v in tp.items()})
    assert sorted(got) == sorted(want)
    for name in want:
        g, w, e = got[name], want[name], exact[name]
        if name == "A_log":
            assert _rel(g, e) <= _rel(w, e), (name, _rel(g, w), _rel(g, e))
        else:
            assert _rel(g, w) <= JAX_TOL, (name, _rel(g, e), _rel(w, e))


# ---------------------------------------------------------------------------
# the vmap rules
# ---------------------------------------------------------------------------


def _cohort(n, seed):
    B, nc, Q, H, P, N = 2, 3, 8, 4, 8, 6
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(n, B, nc * Q, H, P)),
            np.logaddexp(rng.normal(size=(n, B, nc * Q, H)), 0),
            -np.exp(0.3 * rng.normal(size=(n, H))),
            rng.normal(size=(n, B, nc * Q, N)), rng.normal(size=(n, B, nc * Q, N)),
            rng.normal(size=(n, B, nc * Q, H, P))]
    return _t(arrs, torch.float32), Q


@pytest.mark.parametrize("a_mapped", [True, False], ids=["A_mapped",
                                                          "A_unmapped"])
def test_vmap_of_grad_equals_a_loop_over_clients(a_mapped):
    """``vmap(grad)`` over a cohort of 3 clients through ``ssd`` (which the
    rules fold into one ``ssd_chunk`` and one ``ssd_chunk_bwd`` call) and
    through ``ssd_chunk`` alone, against each client's own ``grad``."""
    (x, dt, A, Bm, Cm, cot), Q = _cohort(3, 8)
    if not a_mapped:
        A = A[0]
    a_dim = 0 if a_mapped else None

    def loss_ssd(x, dt, A, Bm, Cm, cot):
        return (ssd(x, dt, A, Bm, Cm, Q) * cot).sum()

    def loss_chunk(x, dt, A, Bm, Cm, cot):
        B, S, H, P = x.shape
        y, st, dec = ssd_chunk(x.reshape(B, S // Q, Q, H, P),
                               dt.reshape(B, S // Q, Q, H), A,
                               Bm.reshape(B, S // Q, Q, -1),
                               Cm.reshape(B, S // Q, Q, -1))
        return (y.reshape(cot.shape) * cot).sum() + st.square().sum() \
            + dec.sum()

    for loss in (loss_ssd, loss_chunk):
        g = grad(loss, argnums=(0, 1, 2, 3, 4))
        got = vmap(g, in_dims=(0, 0, a_dim, 0, 0, 0))(x, dt, A, Bm, Cm, cot)
        loop = [g(x[i], dt[i], A[i] if a_mapped else A, Bm[i], Cm[i], cot[i])
                for i in range(3)]
        for j, name in enumerate(("dx", "ddt", "dA", "dBm", "dCm")):
            want = torch.stack([grads[j] for grads in loop])
            assert got[j].shape == want.shape, name
            assert _rel(got[j], want) <= VMAP_TOL, (name, loss.__name__)
