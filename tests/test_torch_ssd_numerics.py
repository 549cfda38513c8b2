"""The arithmetic of the bfloat16 tensor-core ssd_chunk kernel, emulated on
the CPU, against the plain version ``kernels.ref.ssd_chunk_ref``.

The kernel (``csrc/ssd_chunk.cu``, bf16 route) forms S = C B^T from exact
bf16 products summed in float32, then, per head, with cum the running sum
of dt A:

* y = M' x with M'_ij = S_ij exp(cum_i - cum_j) dt_j for j <= i (dt folded
  into the weight, so x stays an exact bf16 operand), M' split three ways
  into bf16 hi = bf16(M'), mid = bf16(M' - hi), lo = bf16(M' - hi - mid),
  each product summed in float32;
* states = (w o B)^T x with w_j = exp(cum_{Q-1} - cum_j) dt_j, w o B split
  into bf16 hi + lo;
* decays = exp(cum_{Q-1}).

This file repeats that arithmetic in torch and holds every lane of y and
states within (1e-4, 1e-4) and the decays within (1e-5, 1e-6) of the plain
version, the limits of ``test_ssd_chunk_allclose`` that ``chip_smoke.py``
holds the kernel to on the card.  One bf16 value or a two-way split for
M', splitting dt x in place of keeping x exact, and one bf16 value for
w o B each break them; the last test shows they do.

Which cum.  The kernel takes cum as one left-to-right float32 sum, and on
the card the plain version's ``torch.cumsum`` along the chunk axis is that
same sum bit for bit (``chip_smoke.py`` reports it as
``cumsum_left_to_right``), so there the two differ only by the split.  On
the CPU ``torch.cumsum`` accumulates in double, and a left-to-right float32
cum differs from it by a few ulps of |cum| (~200 at the end of a chunk):
enough, through exp(cum_i - cum_j) on terms of ~10, to move some lanes of
y by more than 1e-4.  So the emulation of y and the states takes the plain
version's cum, and the left-to-right cum is held through the decays it
gives.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

BF16 = torch.bfloat16
# (rtol, atol) for y, states, decays: test_ssd_chunk_allclose's
TOL = ((1e-4, 1e-4), (1e-4, 1e-4), (1e-5, 1e-6))
# (B, nc, Q, H, P, N): tests/test_kernels.py's three shapes, the mamba2
# smoke config's, and eight chunks of mamba2-2.7b's prefill layer
SHAPES = [(1, 4, 16, 2, 16, 8), (2, 4, 32, 4, 32, 16),
          (1, 2, 128, 2, 64, 128), (1, 8, 8, 8, 32, 16),
          (1, 8, 128, 80, 64, 128)]
LAYER8 = SHAPES[-1]


def _inputs(shape, seed):
    """x, B, C ~ N(0, 1) in bf16, dt = softplus(N(0, 1)), A = -exp(0.3
    N(0, 1)): chip_smoke.py's recipe."""
    B, nc, Q, H, P, N = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, nc, Q, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(B, nc, Q, H)), 0).astype(np.float32)
    A = (-np.exp(0.3 * rng.normal(size=H))).astype(np.float32)
    Bm = rng.normal(size=(B, nc, Q, N)).astype(np.float32)
    Cm = rng.normal(size=(B, nc, Q, N)).astype(np.float32)
    return (torch.from_numpy(x).to(BF16), torch.from_numpy(dt),
            torch.from_numpy(A), torch.from_numpy(Bm).to(BF16),
            torch.from_numpy(Cm).to(BF16))


def _cum_left_to_right(dt, A):
    """The kernel's cum: float32 products dt A summed left to right."""
    a = dt * A
    cum = torch.empty_like(a)
    run = torch.zeros_like(a[:, :, 0])
    for j in range(a.shape[2]):
        run = run + a[:, :, j]
        cum[:, :, j] = run
    return cum


def _split(t, terms):
    """t as a sum of `terms` bf16 values (as float32), largest first."""
    out = []
    for _ in range(terms):
        part = t.to(BF16).float()
        out.append(part)
        t = t - part
    return out


def _emulate(x, dt, A, Bm, Cm, cum, *, m_terms=3, fold_dt=True,
             w_terms=2):
    """The kernel's arithmetic, given cum (B, nc, Q, H); returns y (B, nc,
    Q, H, P), states (B, nc, H, N, P) and decays (B, nc, H) in float32."""
    Q = x.shape[2]
    cum = cum.permute(0, 1, 3, 2)                      # (B, nc, H, Q)
    dth = dt.permute(0, 1, 3, 2)
    xf = x.float().permute(0, 1, 3, 2, 4)              # (B, nc, H, Q, P)
    S = (Cm.float() @ Bm.float().transpose(-1, -2))[:, :, None]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    diff = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)
    L = torch.where(tri, torch.exp(diff), 0.0)         # exp only on j <= i
    if fold_dt:
        terms = _split(S * L * dth[..., None, :], m_terms)
        y = sum(t @ xf for t in terms)
    else:                     # M = S o L and dt x, each split hi + lo
        mh, ml = _split(S * L, 2)
        xh, xl = _split(xf * dth[..., None], 2)
        y = mh @ xh + mh @ xl + ml @ xh
    w = torch.exp(cum[..., -1:] - cum) * dth           # (B, nc, H, Q)
    wb = Bm.float()[:, :, None] * w[..., None]         # (B, nc, H, Q, N)
    states = sum(t.transpose(-1, -2) @ xf for t in _split(wb, w_terms))
    return y.permute(0, 1, 3, 2, 4), states, torch.exp(cum[..., -1])


def _lanes_over(got, want, tol):
    rtol, atol = tol
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_three_way_split_within_limits(shape):
    ins = _inputs(shape, sum(shape))
    want = ref.ssd_chunk_ref(*ins)
    cum = torch.cumsum(ins[1] * ins[2], dim=2)         # the plain version's
    got = _emulate(*ins, cum)
    for g, w, tol in zip(got, want, TOL):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _lanes_over(g, w, tol) == 0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_left_to_right_cum_decays_within_limits(shape):
    ins = _inputs(shape, sum(shape))
    decays = _emulate(*ins, _cum_left_to_right(ins[1], ins[2]))[2]
    want = ref.ssd_chunk_ref(*ins)[2]
    np.testing.assert_allclose(decays.numpy(), want.numpy(), rtol=TOL[2][0],
                               atol=TOL[2][1])


def test_cpu_cumsum_is_not_left_to_right():
    """Why the emulation takes the plain version's cum: on the CPU
    torch.cumsum accumulates in double, which a left-to-right float32 sum
    departs from, and that alone moves lanes of y over the limit."""
    ins = _inputs(LAYER8, 0)
    a = ins[1] * ins[2]
    assert torch.equal(torch.cumsum(a, dim=2),
                       torch.cumsum(a.double(), dim=2).float())
    seq = _cum_left_to_right(ins[1], ins[2])
    assert not torch.equal(seq, torch.cumsum(a, dim=2))
    y = _emulate(*ins, seq)[0]
    assert _lanes_over(y, ref.ssd_chunk_ref(*ins)[0], TOL[0]) > 0


@pytest.mark.parametrize("variant,output", [
    (dict(m_terms=1), 0),          # M' as one bf16 value
    (dict(m_terms=2), 0),          # M' as bf16 hi + mid
    (dict(fold_dt=False), 0),      # S o L and dt x, each hi + lo
    (dict(w_terms=1), 1),          # w o B as one bf16 value
], ids=["m_single", "m_two_way", "dt_x_split", "w_single"])
def test_cheaper_splits_break_limits(variant, output):
    """The limits have teeth: each cheaper split puts lanes over at eight
    chunks of the layer, where the kernel's split keeps every lane."""
    ins = _inputs(LAYER8, 7)
    want = ref.ssd_chunk_ref(*ins)
    cum = torch.cumsum(ins[1] * ins[2], dim=2)
    cheap = _emulate(*ins, cum, **variant)[output]
    assert _lanes_over(cheap, want[output], TOL[output]) > 0
    kernel = _emulate(*ins, cum)[output]
    assert _lanes_over(kernel, want[output], TOL[output]) == 0
