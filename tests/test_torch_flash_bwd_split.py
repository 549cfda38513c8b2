"""The arithmetic of the bfloat16 tensor-core flash_attention backward,
emulated on the CPU, against the plain backward ``kernels.ref.sdpa_bwd``
and against ``jax.vjp`` of ``repro.models.layers.sdpa``.

The kernel (``csrc/flash_attention_bwd.cu``, bf16 route) forms the scores
S = q k^T and dP = do v^T as float32 sums of exact bf16 products, then
P = exp(s - lse) (exp as 2^(x log2 e)) and dS = P (dP - D) scale (times
1 - tanh^2 under the soft-cap) in float32.  P and dS are the bf16 operands
of the gradient products dV = P^T do, dK = dS^T q and dQ = dS k, so each
is split into ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` and both halves
are multiplied.  The products are summed in float32 on the card; here in
float64, so what is left is the split's rounding alone.  dq, dk and dv are
rounded to bf16 once.

Every lane must lie within one bf16 step of the reference (2^-7 of its
magnitude) plus 1e-5 of the gradient's largest magnitude: the check
``chip_smoke.py`` makes of the kernel on the card.  A single bf16 rounding
of P and dS, the usual tensor-core design, breaks that check on ~10% of
the lanes; the last test shows it does, which is why the kernel splits.

The plain backward is given the bf16 o that the kernel is given.  JAX's
vjp differentiates the exact forward, so against it the emulation is
given the float32 forward's o and lse: D = rowsum(do o) of a bf16 o alone
moves 1-3% of the dq and dk lanes past one step of JAX's, in the plain
backward as in the emulation.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from torch_parity import one_intra_op_thread  # noqa: E402

BF16_STEP = 2.0 ** -7
BWD_BF16_ATOL = 1e-5        # of the gradient's largest magnitude
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
MODES = {"causal": dict(causal=True, window=0, softcap=0.0),
         "window": dict(causal=True, window=48, softcap=0.0),
         "softcap": dict(causal=True, window=0, softcap=30.0),
         "full": dict(causal=False, window=0, softcap=0.0)}
GROUPS = (1, 4, 5)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def _inputs(shape, seed):
    """bf16 q, k, v and do of (B, S, H, KV, hd), drawn with numpy."""
    B, S, H, KV, hd = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, n, hd))
                             .astype(np.float32)).to(torch.bfloat16)
            for n in (H, KV, KV, H)]


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _emulate(q, k, v, o, lse, do, *, causal, window, softcap, split=True):
    """(dq, dk, dv) in bf16 by the kernel's arithmetic, from bf16 q, k, v,
    do, the forward's o and its row log-sum-exp lse (B, H, Sq)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    f32, f64 = torch.float32, torch.float64

    def heads(x):                                # (B, KV, G, Sq, hd)
        return x.to(f64).reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)

    qh, doh = heads(q), heads(do)
    kh = k.to(f64).permute(0, 2, 1, 3)[:, :, None]
    vh = v.to(f64).permute(0, 2, 1, 3)[:, :, None]
    D = (do.to(f64) * o.to(f64)).sum(-1).to(f32)
    D = D.reshape(B, Sq, KV, G).permute(0, 2, 3, 1)[..., None]
    lse = lse.reshape(B, KV, G, Sq)[..., None]
    scale = torch.tensor(ref.attn_scale(hd), dtype=f32)
    x = (qh @ kh.transpose(-1, -2)).to(f32) * scale
    if softcap > 0:
        t = torch.tanh(x / softcap)
        x = softcap * t
    i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    keep = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window > 0:
        keep &= j > i - window
    p = torch.where(keep, torch.exp2((x - lse) * LOG2E), torch.zeros(()))
    ds = p * ((doh @ vh.transpose(-1, -2)).to(f32) - D)
    if softcap > 0:
        ds = ds * (1 - t * t)
    ds = ds * scale

    def operand(a):                              # what the tensor cores see
        hi = _bf16(a)
        return (hi + _bf16(a - hi) if split else hi).to(f64)

    P, dS = operand(p), operand(ds)
    dv = (P.transpose(-1, -2) @ doh).sum(2)      # (B, KV, Skv, hd)
    dk = (dS.transpose(-1, -2) @ qh).sum(2)
    dq = (dS @ kh).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    bf = torch.bfloat16
    return (dq.to(bf), dk.permute(0, 2, 1, 3).to(bf),
            dv.permute(0, 2, 1, 3).to(bf))


def _share_over_one_step(got, want):
    """The share of lanes further from ``want`` than one bf16 step of the
    lane plus BWD_BF16_ATOL of the largest magnitude."""
    g, w = got.double(), want.double()
    over = (g - w).abs() - BF16_STEP * w.abs() \
        - BWD_BF16_ATOL * float(w.abs().max())
    return float((over > 0).double().mean())


@functools.partial(jax.jit, static_argnames=("causal", "window",
                                             "softcap"))
def _jax_vjp(q, k, v, do, *, causal, window, softcap):
    """(dq, dk, dv) of JAX's sdpa, jitted (one compile a case)."""
    _, pull = jax.vjp(lambda a, b, c: jL.sdpa(a, b, c, causal=causal,
                                              window=window,
                                              softcap=softcap), q, k, v)
    return pull(do)


def _shape(G):
    return (2, 128, 2 * G, 2, 64)


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("mode", list(MODES))
def test_split_within_one_bf16_step_of_the_plain_backward(mode, G):
    q, k, v, do = _inputs(_shape(G), 10 * G)
    m = MODES[mode]
    o, lse = ref.sdpa_lse(q, k, v, **m)
    got = _emulate(q, k, v, o, lse, do, **m)
    want = ref.sdpa_bwd(q, k, v, o, lse, do, **m)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        assert _share_over_one_step(g, w) == 0.0


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("mode", list(MODES))
def test_split_within_one_bf16_step_of_jax(mode, G):
    q, k, v, do = _inputs(_shape(G), 10 * G + 1)
    m = MODES[mode]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o, lse = ref.sdpa_lse(qf, kf, vf, **m)
    got = _emulate(q, k, v, o, lse, do, **m)
    want = [torch.from_numpy(np.array(w)).to(torch.bfloat16)
            for w in _jax_vjp(*(jnp.asarray(x.numpy())
                                for x in (qf, kf, vf, dof)), **m)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _share_over_one_step(g, w) == 0.0


def test_single_bf16_rounding_breaks_one_step():
    """The check has teeth: rounding P and dS to bf16 once puts more than
    1% of the lanes of each gradient over it (llama's head_dim, a group of
    4, causal); the split keeps every lane on the same inputs."""
    q, k, v, do = _inputs((1, 256, 8, 2, 64), 7)
    m = MODES["causal"]
    o, lse = ref.sdpa_lse(q, k, v, **m)
    want = ref.sdpa_bwd(q, k, v, o, lse, do, **m)
    single = _emulate(q, k, v, o, lse, do, **m, split=False)
    split = _emulate(q, k, v, o, lse, do, **m)
    for s, g, w in zip(single, split, want):
        assert _share_over_one_step(s, w) > 0.01
        assert _share_over_one_step(g, w) == 0.0
