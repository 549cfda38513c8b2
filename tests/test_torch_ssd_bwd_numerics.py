"""The arithmetic of the bfloat16 tensor-core ssd_chunk backward, emulated
on the CPU, against the plain version ``kernels.ref.ssd_chunk_bwd``.

The kernel (``csrc/ssd_chunk_bwd.cu``, bf16 route) feeds the tensor cores
bf16 operands and sums in float32.  x, Bm and Cm are bf16 and enter every
product exact; a float32 operand is split into bf16 terms, hi = bf16(v),
mid = bf16(v - hi), lo = bf16(v - hi - mid), and only some of the products
of the terms are formed.  Per (batch row, chunk, head), with cum the
running sum of dt A, L_ij = exp(cum_i - cum_j) (j <= i) and w_j =
exp(cum_{Q-1} - cum_j):

* S = C B^T once a chunk (exact operands);
* dM_ij = dt_j (dy x^T)_ij: dy split hi + lo, x exact;
* M = S o L in float32; M^T dy with M split hi + lo and dy hi + lo, of
  which the products hi.hi, hi.lo and lo.hi are formed (M's third term,
  which the forward's M' needs, and lo.lo are below what the limits see:
  the worst ddt lane sits at ~3% of its limit without them);
* U = B dstate: dstate split hi + lo;  w_j dt_j (x dstate^T)_jn for dB:
  the same split;
* G = dM o M and D = sum_h dM o L element by element in float32;
* dC = D B and dB = D^T C: D split hi + lo.

This file repeats that arithmetic in torch and holds every lane against the
plain version within ``chip_smoke.SSD_BWD_TOL``: the float32 gradients (ddt,
dA) within 1e-4 of the lane plus 1e-4 of the largest magnitude, the bf16
ones (dx, dBm, dCm) within one bf16 step (2^-7 of the lane) plus the same.
The last test shows that each cheaper split, or dropping a product the
kernel forms, puts lanes over those limits at two chunks of mamba2-2.7b's
training layer.

Which exponential: the kernel forms L on the special function unit, as
ex2.approx of (cum_i - cum_j) log2 e, where the forward and the kernel's w
and decay take the accurate expf.  The emulation takes exp2 of that float32
product, so it models the product's rounding but not ex2.approx's own
error (about 2 ulp): the cuda-marked cases and chip_smoke.py's
ssd_backward hold that on the card.

Which cum: as in ``test_torch_ssd_numerics.py``, the plain version's.  On
the CPU ``torch.cumsum`` accumulates in double, on the card it is the
kernel's left-to-right float32 sum; the emulation takes the CPU's, so that
here, as on the card, the two differ only by the kernel's arithmetic.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

BF16 = torch.bfloat16
BF16_STEP = 2.0 ** -7
# chip_smoke.SSD_BWD_TOL: (rtol, atol as a share of the largest magnitude)
TOL_F32 = (1e-4, 1e-4)
TOL_BF16 = (BF16_STEP, 1e-4)
NAMES = ("dx", "ddt", "dA", "dBm", "dCm")
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
# the kernel's splits: terms of each float32 operand, and the products
# (M's term, dy's term) that M^T dy forms, 0 the hi term, 1 the lo
KERNEL = dict(dy_terms=2, m_terms=2, mdy=((0, 0), (0, 1), (1, 0)),
              dst_terms=2, d_terms=2)
# (B, nc, Q, H, P, N): tests/test_kernels.py's three shapes, the mamba2
# smoke config's, chip_smoke's RAGGED_SSD, and two chunks of mamba2-2.7b's
# training layer
SHAPES = [(1, 4, 16, 2, 16, 8), (2, 4, 32, 4, 32, 16),
          (1, 2, 128, 2, 64, 128), (1, 8, 8, 8, 32, 16), (2, 3, 13, 3, 10, 7),
          (2, 1, 128, 80, 64, 128)]
RAGGED = SHAPES[4]
TRAIN2 = SHAPES[-1]


def _inputs(shape, seed, *, a_rows=False, cotangents=True):
    """chip_smoke.py's recipe: x, B, C ~ N(0, 1) in bf16, dt = softplus(N(0,
    1)), A = -exp(0.3 N(0, 1)) (one row a batch row with a_rows), and the
    cotangents dy, dstates, ddecays ~ N(0, 1) float32 (None for the last
    two unless cotangents)."""
    B, nc, Q, H, P, N = shape
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = torch.from_numpy(rng.normal(size=(B, nc, Q, H, P)).astype(f32))
    Bm = torch.from_numpy(rng.normal(size=(B, nc, Q, N)).astype(f32))
    Cm = torch.from_numpy(rng.normal(size=(B, nc, Q, N)).astype(f32))
    dt = torch.from_numpy(
        np.logaddexp(rng.normal(size=(B, nc, Q, H)), 0).astype(f32))
    A = torch.from_numpy(
        (-np.exp(0.3 * rng.normal(size=(B, H) if a_rows else H))).astype(f32))
    dy = torch.from_numpy(rng.normal(size=(B, nc, Q, H, P)).astype(f32))
    dst = ddec = None
    if cotangents:
        dst = torch.from_numpy(rng.normal(size=(B, nc, H, N, P)).astype(f32))
        ddec = torch.from_numpy(rng.normal(size=(B, nc, H)).astype(f32))
    return (x.to(BF16), dt, A, Bm.to(BF16), Cm.to(BF16)), (dy, dst, ddec)


def _split(t, terms):
    """t as a list of `terms` bf16 values (as float32), largest first."""
    out = []
    for _ in range(terms):
        part = t.to(BF16).float()
        out.append(part)
        t = t - part
    return out


def _emulate(x, dt, A, Bm, Cm, dy, dst, ddec, *, dy_terms, m_terms, mdy,
             dst_terms, d_terms):
    """The bf16 route's arithmetic: (dx, ddt, dA, dBm, dCm) as the kernel
    forms them, given its splits."""
    Q = x.shape[2]
    Af = ref._a_rows(A)                                # (B|1, 1, 1, H)
    cum = torch.cumsum(dt * Af, dim=2)                 # the plain version's
    cum, dth = cum.permute(0, 1, 3, 2), dt.permute(0, 1, 3, 2)  # (B, nc, H, Q)
    xf = x.float().permute(0, 1, 3, 2, 4)              # (B, nc, H, Q, P)
    Bf, Cf = Bm.float(), Cm.float()
    S = (Cf @ Bf.transpose(-1, -2))[:, :, None]        # (B, nc, 1, i, j)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    diff = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)
    # exp only on j <= i, as 2^(float32 (diff log2 e)) like the kernel
    L = torch.where(tri, torch.exp2(diff * LOG2E), 0.0)
    M = S * L
    dyh = dy.permute(0, 1, 3, 2, 4)                    # (B, nc, H, Q, P)
    dys = _split(dyh, dy_terms)
    # dM_ij = dt_j (dy x^T)_ij, each dy term's product summed in float32
    dM = sum(d @ xf.transpose(-1, -2) for d in dys) * dth[..., None, :]
    Ms = _split(M, m_terms)
    dxdt = sum(Ms[a].transpose(-1, -2) @ dys[b] for a, b in mdy)
    G = dM * M
    D = (dM * L).sum(2)                                # (B, nc, i, j)
    pre = torch.nn.functional.pad(torch.cumsum(G[..., :-1], dim=-1), (1, 0))
    daG = torch.diagonal(torch.flip(torch.cumsum(torch.flip(pre, (-2,)),
                                                 dim=-2), (-2,)),
                         dim1=-2, dim2=-1)             # (B, nc, H, Q)
    da = daG.clone()
    dB = 0.0                                           # the states' term
    if dst is not None:
        w = torch.exp(cum[..., -1:] - cum)             # (B, nc, H, Q)
        dsts = _split(dst, dst_terms)                  # (B, nc, H, N, P)
        U = sum(Bf[:, :, None] @ d for d in dsts)
        dxdt = dxdt + w[..., None] * U
        dww = (U * xf).sum(-1) * dth * w
        # sum_{k >= r} of dcum's other terms is sum_{j < r} dw_j w_j
        da = da + torch.nn.functional.pad(torch.cumsum(dww[..., :-1], -1),
                                          (1, 0))
        V = sum(xf @ d.transpose(-1, -2) for d in dsts)    # (.., H, Q, N)
        dB = dB + ((w * dth)[..., None] * V).sum(2)
    if ddec is not None:
        da = da + (ddec[..., None] * torch.exp(cum[..., -1:]))
    ddt = da * A.reshape(-1, 1, A.shape[-1], 1) + (dxdt * xf).sum(-1)
    dA = (da * dth).sum((1, 3))                        # (B, H)
    if A.dim() == 1:
        dA = dA.sum(0)
    Ds = _split(D, d_terms)
    dC = sum(d @ Bf for d in Ds)
    dB = sum(d.transpose(-1, -2) @ Cf for d in Ds) + dB
    dx = (dxdt * dth[..., None]).permute(0, 1, 3, 2, 4)
    return (dx.to(x.dtype), ddt.permute(0, 1, 3, 2), dA, dB.to(Bm.dtype),
            dC.to(Cm.dtype))


def _lanes_over(got, want):
    """{name: lanes over chip_smoke's limit} of the five gradients."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        rt, at = TOL_BF16 if g.dtype == BF16 else TOL_F32
        gf, wf = g.float(), w.float()
        over = (gf - wf).abs() - rt * wf.abs() - at * float(wf.abs().max())
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(torch.isfinite(gf).all())
        out[name] = int((over > 0).sum())
    return out


def _worst_share(got, want):
    """{name: the worst lane's error as a share of its limit}."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        rt, at = TOL_BF16 if g.dtype == BF16 else TOL_F32
        gf, wf = g.float(), w.float()
        lim = rt * wf.abs() + at * float(wf.abs().max())
        out[name] = float(((gf - wf).abs() / lim).max())
    return out


@pytest.mark.parametrize("a_rows", [False, True], ids=["shared_A", "A_rows"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_splits_within_limits(shape, a_rows):
    ins, cots = _inputs(shape, sum(shape) + a_rows, a_rows=a_rows,
                        cotangents=shape != RAGGED)
    got = _emulate(*ins, *cots, **KERNEL)
    want = ref.ssd_chunk_bwd(*ins, *cots)
    assert _lanes_over(got, want) == dict.fromkeys(NAMES, 0)


def test_prefix_form_of_the_states_terms():
    """The kernel sums dcum's states and decay terms from the left (sum_{j <
    r} dw_j w_j + ddecay decay), the plain version from the right (a total
    less a running sum): algebraically one value, and at two training
    chunks within 1e-6 of the largest ddt."""
    ins, cots = _inputs(TRAIN2, 3, a_rows=True)
    zero = (torch.zeros_like(cots[0]),) + cots[1:]
    # with dy = 0 only the states and decay terms reach ddt
    exact = dict(dy_terms=3, m_terms=3, mdy=(), dst_terms=3, d_terms=3)
    got = _emulate(*ins, *zero, **exact)[1]
    want = ref.ssd_chunk_bwd(*ins, *zero)[1]
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("variant,output", [
    (dict(dy_terms=1, mdy=((0, 0), (1, 0))), "ddt"),   # one bf16 dy
    (dict(m_terms=1, mdy=((0, 0), (0, 1))), "ddt"),    # one bf16 M (no lo.hi)
    (dict(mdy=((0, 0), (1, 0))), "ddt"),               # no hi.lo
    (dict(dst_terms=1), "ddt"),                        # one bf16 dstate
    (dict(d_terms=1), "dCm"),                          # one bf16 D
], ids=["dy_single", "m_single", "no_hi_lo", "dstate_single", "d_single"])
def test_cheaper_splits_break_limits(variant, output):
    """The limits have teeth: each cheaper split puts lanes over at two
    chunks of the training layer, where the kernel's keeps every lane."""
    ins, cots = _inputs(TRAIN2, 11, a_rows=True)
    want = ref.ssd_chunk_bwd(*ins, *cots)
    cheap = _lanes_over(_emulate(*ins, *cots, **{**KERNEL, **variant}), want)
    assert cheap[output] > 0
    assert _lanes_over(_emulate(*ins, *cots, **KERNEL), want) \
        == dict.fromkeys(NAMES, 0)


@pytest.mark.parametrize("variant", [
    dict(m_terms=3, mdy=KERNEL["mdy"] + ((2, 0),)),    # M hi + mid + lo
    dict(mdy=KERNEL["mdy"] + ((1, 1),)),               # lo.lo formed
], ids=["m_three", "lo_lo"])
def test_dropped_products_are_below_the_limits(variant):
    """What the kernel leaves out of M^T dy (M's third term, the lo.lo
    product) is below what the limits see: at two chunks of the training
    layer the kernel's worst ddt lane is under a tenth of its limit, and
    keeping the product only brings it lower."""
    ins, cots = _inputs(TRAIN2, 11, a_rows=True)
    want = ref.ssd_chunk_bwd(*ins, *cots)
    kernel = _worst_share(_emulate(*ins, *cots, **KERNEL), want)
    dearer = _emulate(*ins, *cots, **{**KERNEL, **variant})
    assert _lanes_over(dearer, want) == dict.fromkeys(NAMES, 0)
    assert _worst_share(dearer, want)["ddt"] <= kernel["ddt"] < 0.1


def test_ablation_variants_apply_to_the_source():
    """chip_ssd_bwd_ablation.py's one-edit variants still find their text
    in the committed kernel source exactly once, and its split variants are
    the cheaper splits above."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_ssd_bwd_ablation as abl
    finally:
        sys.path.remove(str(root))
    src = (root / "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu").read_text()
    variants = abl.variant_sources(src)
    assert variants["kernel"] == src
    assert {"parent", "in_accumulator", "no_exp", "no_reads"} <= set(variants)
    assert {"dy_single", "m_single", "no_hi_lo", "dstate_single",
            "d_single", "m_three", "lo_lo"} <= set(variants)
    assert all(v != src for k, v in variants.items() if k != "kernel")
