"""Plain PyTorch versions of the port's kernels (their CPU path and their
oracle on the card).

Port of ``repro.kernels.ref``'s ``fed_select``, ``fed_aggregate``,
``attention_ref`` and ``ssd_chunk_ref`` oracles, op for op, so that on the
CPU they are bitwise (``fed_select``) or allclose (the others) to the JAX
package's.  The attention of the model (``sdpa``: dense, or the chunked
online softmax for long sequences, as ``repro.models.layers`` computes it)
lives here too, as the plain version of the ``flash_attention`` kernel;
``repro_torch.models.layers`` re-exports it.  So does the model's chunked
SSD (``ssd_ref``, ``repro.models.ssm._ssd_chunked``), the plain version of
the composed ``kernels.ssd_chunk.ssd``.
"""
from __future__ import annotations

import torch

# Sentinel for unavailable clients — must match core.selection._NEG.
SELECT_NEG = -1e30

SELECT_WEIGHT_MODES = ("unbiased", "unbiased_frozen", "uniform", "fedavg")


def fed_aggregate_ref(deltas: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """(K, D), (K,) -> (D,): float32-accumulated weighted sum, returned in
    the delta dtype."""
    acc = torch.sum(deltas.to(torch.float32)
                    * weights.to(torch.float32)[:, None], dim=0)
    return acc.to(deltas.dtype)


_MANTISSA_BITS = {torch.float32: 23, torch.bfloat16: 7}


def fed_aggregate_err_bound(deltas: torch.Tensor, weights: torch.Tensor,
                            got: torch.Tensor,
                            want: torch.Tensor) -> torch.Tensor:
    """Per-lane bound on ``|got − want|`` for two evaluations of
    :func:`fed_aggregate_ref`'s contract (float32 accumulation in any order,
    one rounding to the delta dtype).  Each float32 sum lies within
    ``K·2^-24·Σ_k|w_k v[k, d]|`` of the exact one, so two differ by at most
    twice that; each then rounds once, together at most one step of the
    output dtype at the larger magnitude.  A sum accumulated in bfloat16
    breaks this bound."""
    k_rows = deltas.shape[0]
    mag = torch.sum(deltas.to(torch.float32).abs()
                    * weights.to(torch.float32).abs()[:, None], dim=0)
    big = torch.maximum(got.to(torch.float32).abs(),
                        want.to(torch.float32).abs())
    _, exp = torch.frexp(big)
    step = torch.ldexp(torch.ones_like(big),
                       exp - 1 - _MANTISSA_BITS[deltas.dtype])
    return 2.0 * k_rows * 2.0 ** -24 * mag + step


def topk_threshold_mask(scores: torch.Tensor, avail: torch.Tensor,
                        k: torch.Tensor) -> torch.Tensor:
    """The stable ``(score, id)`` top-k cut as a threshold: with ``thr`` the
    ``k_eff``-th largest masked score, select ``masked > thr`` plus the
    first ``k_eff − |{masked > thr}|`` ties in ascending id order.
    Bit-identical to ``core.selection._topk_mask``."""
    n = scores.shape[0]
    avail = avail.to(torch.bool)
    masked = torch.where(avail, scores,
                         torch.full_like(scores, SELECT_NEG)).to(torch.float32)
    n_avail = avail.sum().to(torch.int32)
    k_eff = torch.minimum(torch.as_tensor(k, device=scores.device)
                          .to(torch.int32), n_avail)
    svals = torch.sort(masked).values
    # k_eff-th largest lives at ascending index n - k_eff; k_eff == 0 clips
    # to the maximum, for which the counts below select nothing.
    idx = torch.clamp(n - k_eff, 0, n - 1).to(torch.int64)
    thr = svals[idx]
    gt = masked > thr
    g = gt.sum().to(torch.int32)
    eq = (masked == thr) & avail
    eq_i = eq.to(torch.int32)
    tie_rank = torch.cumsum(eq_i, 0, dtype=torch.int32) - eq_i
    return (gt | (eq & (tie_rank < (k_eff - g)))) & avail


def select_weights_ref(mask, new_r, p, r_weight, weight_mode: str):
    """The built-in strategies' weight rules on the selection mask."""
    from ..core.hfun import R_MIN   # here: ``core`` imports the kernels
    zero = torch.zeros_like(p)
    if weight_mode == "unbiased":
        return torch.where(mask, p / torch.clamp_min(new_r, R_MIN), zero)
    if weight_mode == "unbiased_frozen":
        return torch.where(mask, p / torch.clamp_min(r_weight, R_MIN), zero)
    if weight_mode == "uniform":
        v = mask.to(torch.float32)
        return v / torch.clamp_min(v.sum(), 1.0)
    if weight_mode == "fedavg":
        w = torch.where(mask, p, zero)
        return w / torch.clamp_min(w.sum(), 1e-12)
    raise ValueError(f"unknown weight_mode {weight_mode!r}; "
                     f"known: {SELECT_WEIGHT_MODES}")


def fed_select_ref(scores, avail, k, r, p, beta, *,
                   weight_mode: str = "unbiased", r_weight=None):
    """The fused selection step (mask, new_r, weights): threshold cut →
    r_k EMA → cohort weights."""
    from ..core.rates import ema    # here: ``core`` imports the kernels
    mask = topk_threshold_mask(scores, avail, k)
    new_r = ema(r, mask, beta)
    w = select_weights_ref(mask, new_r, p, r_weight, weight_mode)
    return mask, new_r, w


# ---------------------------------------------------------------------------
# Attention: the plain version of the flash_attention kernel
# ---------------------------------------------------------------------------

# Masked scores take this value, not -inf (as in the JAX package).
ATTN_NEG = -1e30
# Above this many score elements per (batch, head), sdpa takes the chunked
# online-softmax path instead of materialising (Sq, Skv) scores.
_CHUNKED_THRESHOLD = 2048 * 2048
_Q_CHUNK = 1024
_KV_CHUNK = 1024


def sqrt_hd(hd: int) -> float:
    """``sqrt(hd)`` in float32, as the JAX package computes it."""
    return float(torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))


def attn_scale(hd: int) -> float:
    """``1 / sqrt(hd)`` in float32, as the JAX package computes it."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))


def sdpa(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
         q_offset=0, kv_valid_len=None, with_lse: bool = False):
    """Grouped-query scaled dot-product attention (``layers.sdpa``).

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); query head h reads KV head
    h // (H // KV).  ``q_offset`` is the absolute position of q[0] relative
    to k[0]; ``kv_valid_len`` masks cache slots >= it.  Above 2048² score
    elements (and Sq a multiple of 1024) the chunked online softmax runs,
    never materialising the (Sq, Skv) scores.  ``with_lse`` also returns
    each row's log-sum-exp (:func:`sdpa_lse`)."""
    Sq, Skv = q.shape[1], k.shape[1]
    if (Sq * Skv > _CHUNKED_THRESHOLD and Sq % _Q_CHUNK == 0
            and kv_valid_len is None):
        kv_len = None
        if Skv % _KV_CHUNK:
            # pad K/V to a chunk multiple; the padded slots are masked
            pad = _KV_CHUNK - Skv % _KV_CHUNK
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            kv_len = Skv
        return _chunked_sdpa(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset, kv_len=kv_len,
                             with_lse=with_lse)
    return _dense_sdpa(q, k, v, causal=causal, window=window, softcap=softcap,
                       q_offset=q_offset, kv_valid_len=kv_valid_len,
                       with_lse=with_lse)


def _chunked_sdpa(q, k, v, *, causal: bool, window: int, softcap: float,
                  q_offset=0, kv_len=None, with_lse: bool = False):
    """Blockwise attention: a loop over q chunks and, inside, over kv
    chunks, with the exact online softmax (running max, rescaled sum and
    accumulator) of ``layers._chunked_sdpa``.  ``with_lse`` also returns
    each row's log-sum-exp, m + log(sum), (B, H, Sq) float32."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    dev = q.device
    scale = attn_scale(hd)
    outs, lses = [], []
    for qi in range(Sq // _Q_CHUNK):
        qc = q[:, qi * _Q_CHUNK:(qi + 1) * _Q_CHUNK].reshape(
            B, _Q_CHUNK, KV, g, hd).to(torch.float32)
        qpos = qi * _Q_CHUNK + torch.arange(_Q_CHUNK, device=dev) + q_offset
        acc = torch.zeros(B, KV, g, _Q_CHUNK, hd, dtype=torch.float32,
                          device=dev)
        m = torch.full((B, KV, g, _Q_CHUNK), float("-inf"),
                       dtype=torch.float32, device=dev)
        denom = torch.zeros(B, KV, g, _Q_CHUNK, dtype=torch.float32,
                            device=dev)
        for ki in range(Skv // _KV_CHUNK):
            sl = slice(ki * _KV_CHUNK, (ki + 1) * _KV_CHUNK)
            kc, vc = k[:, sl].to(torch.float32), v[:, sl].to(torch.float32)
            kpos = ki * _KV_CHUNK + torch.arange(_KV_CHUNK, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qc, kc) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            mask = torch.ones(_Q_CHUNK, _KV_CHUNK, dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            if kv_len is not None:
                mask &= (kpos < kv_len)[None, :]
            s = torch.where(mask, s, torch.full_like(s, ATTN_NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh",
                                                       p, vc)
            m = m_new
        out = acc / torch.clamp_min(denom[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))        # (B, Qc, KV, g, hd)
        lses.append(m + torch.log(denom))              # (B, KV, g, Qc)
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, hd).to(q.dtype)
    if with_lse:
        return out, torch.cat(lses, dim=-1).reshape(B, H, Sq)
    return out


def _dense_sdpa(q, k, v, *, causal: bool, window: int = 0,
                softcap: float = 0.0, q_offset=0, kv_valid_len=None,
                with_lse: bool = False):
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    dev = q.device
    qg = q.reshape(B, Sq, KV, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) / sqrt_hd(hd)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
    kpos = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    if kv_valid_len is not None:
        mask &= kpos < kv_valid_len
    logits = torch.where(mask, logits, torch.full_like(logits, ATTN_NEG))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(torch.float32))
    out = out.reshape(B, Sq, H, hd).to(q.dtype)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(B, H, Sq)
    return out


def sdpa_lse(q, k, v, *, causal: bool, window: int = 0,
             softcap: float = 0.0):
    """``(o, lse)``: :func:`sdpa`'s output (the same function, on the same
    dense or chunked path) and each row's log-sum-exp of its masked scores
    (B, H, Sq) float32, the forward that a backward reads.  The plain
    version of the flash_attention kernel with a non-null ``lse``."""
    return sdpa(q, k, v, causal=causal, window=window, softcap=softcap,
                with_lse=True)


def sdpa_bwd(q, k, v, o, lse, do, *, causal: bool, window: int = 0,
             softcap: float = 0.0):
    """The gradient of :func:`sdpa` (the plain version of the
    flash_attention_bwd kernel), in the FlashAttention-2 form, from the
    forward's output ``o`` and row log-sum-exp ``lse`` (B, H, Sq):

        D = rowsum(do * o),  P = exp(s - lse),  dV = P^T do,
        dP = do V^T,  dS = P * (dP - D)  (times 1 - tanh^2 under the
        soft-cap),  dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd),

    dK and dV summed over the query heads of each KV group.  float32
    throughout, one query chunk of at most 1024 rows at a time (so no
    (Sq, Skv) tensor is formed above that); returns (dq, dk, dv) in the
    dtypes of q, k and v."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    dev = q.device
    f32 = torch.float32
    scale = attn_scale(hd)
    qf = q.to(f32).reshape(B, Sq, KV, g, hd)
    dof = do.to(f32).reshape(B, Sq, KV, g, hd)
    kf, vf = k.to(f32), v.to(f32)
    delta = (dof * o.to(f32).reshape(B, Sq, KV, g, hd)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)                    # (B, KV, g, Sq)
    lse = lse.reshape(B, KV, g, Sq)
    kpos = torch.arange(Skv, device=dev)[None, :]
    dq = torch.empty(B, Sq, KV, g, hd, dtype=f32, device=dev)
    dk = torch.zeros(B, Skv, KV, hd, dtype=f32, device=dev)
    dv = torch.zeros(B, Skv, KV, hd, dtype=f32, device=dev)
    for a in range(0, Sq, _Q_CHUNK):
        b = min(a + _Q_CHUNK, Sq)
        qc, doc = qf[:, a:b], dof[:, a:b]
        s = torch.einsum("bqkgh,bskh->bkgqs", qc, kf) * scale
        if softcap > 0:
            t = torch.tanh(s / softcap)
            s = softcap * t
        qpos = torch.arange(a, b, device=dev)[:, None]
        mask = torch.ones(b - a, Skv, dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        p = torch.where(mask, torch.exp(s - lse[..., a:b, None]),
                        torch.zeros((), dtype=f32, device=dev))
        dv += torch.einsum("bkgqs,bqkgh->bskh", p, doc)
        dp = torch.einsum("bqkgh,bskh->bkgqs", doc, vf)
        ds = p * (dp - delta[..., a:b, None])
        if softcap > 0:
            ds = ds * (1.0 - t * t)
        ds = ds * scale
        dq[:, a:b] = torch.einsum("bkgqs,bskh->bqkgh", ds, kf)
        dk += torch.einsum("bkgqs,bqkgh->bskh", ds, qc)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Dense-softmax GQA attention (``repro.kernels.ref.attention_ref``):
    the (Sq, Skv) scores in float32, masked with -1e30, softmax, output in
    q's dtype.  q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd)."""
    return _dense_sdpa(q, k, v, causal=causal, window=window, softcap=softcap)


# ---------------------------------------------------------------------------
# Mamba-2 SSD: the plain versions of the ssd_chunk kernel and of ssd
# ---------------------------------------------------------------------------


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """float64 inputs are computed in float64 (the tests' exact checks),
    anything else in float32, as the kernels compute."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _a_rows(A: torch.Tensor) -> torch.Tensor:
    """A against (B, nc, Q, H): a shared (H,) A, or one row of A per batch
    row (B, H), as the cohort's folded batch carries it."""
    return A[:, None, None, :] if A.dim() == 2 else A[None, None, None, :]


def ssd_chunk_ref(x, dt, A, Bm, Cm):
    """Intra-chunk SSD pieces (``repro.kernels.ref.ssd_chunk_ref``).

    x: (B, nc, Q, H, P); dt: (B, nc, Q, H) float32; A: (H,) float32, or
    (B, H) for one A per batch row; Bm, Cm: (B, nc, Q, N).  Returns float32
    (float64 for float64 x) (y_intra (B, nc, Q, H, P), states (B, nc, H,
    N, P), decays (B, nc, H)).

    L is masked before the exp, as ``ssd_ref`` masks it: the same values
    as JAX's exp-then-mask (exp(-1e30) is 0), and a finite gradient, where
    exp of the upper triangle's positive differences would overflow and
    give 0 * inf in the backward."""
    f = _work_dtype(x)
    a = dt * _a_rows(A)                                   # (B, nc, Q, H)
    cum = torch.cumsum(a, dim=2)
    Q = x.shape[2]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              torch.full((), -1e30, device=x.device)))
    scores = torch.einsum("bcin,bcjn->bcij", Cm.to(f), Bm.to(f))
    M = scores[..., None] * L
    xdt = x.to(f) * dt[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xdt)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchnp", decay_to_end * dt,
                          Bm.to(f), x.to(f))
    decays = torch.exp(cum[:, :, -1, :])
    return y_intra, states, decays


def ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, dstates=None, ddecays=None):
    """(dx, ddt, dA, dBm, dCm): the gradient of :func:`ssd_chunk_ref`
    against the cotangents dy (B, nc, Q, H, P), dstates (B, nc, H, N, P)
    and ddecays (B, nc, H), derived by hand op by op (no autograd), as the
    ``ssd_chunk_bwd`` kernel computes it.  ``None`` for dstates or
    ddecays is a zero gradient.

    Per (b, c, h), with xdt = dt x, M = (C B^T) o L, w_j = exp(cum_{Q-1} -
    cum_j) and G = dM o M:

      d(xdt) = M^T dy + w o (B dstate),   dM = dy xdt^T,
      d(C B^T) = sum_h dM o L,
      dcum_k = sum_j G_kj - sum_i G_ik - dw_k w_k
               (+ sum_j dw_j w_j + ddecay decay at k = Q-1),
        with dw_j = xdt_j . (B dstate)_j,
      da_r = sum_{k >= r} dcum_k, whose G part is sum_{i >= r > j} G_ij,
      ddt = da A + sum_p d(xdt) x,  dx = d(xdt) dt,  dA = sum da dt,
      dC = d(C B^T) B,  dB = d(C B^T)^T C + sum_h (w o xdt) dstate^T.

    G's part of da is summed as that block of G, not as the reverse sum of
    G's row sums minus its column sums, which cancel in float32: so dA at
    Q = N = 128 comes closer to its float64 value than JAX's float32
    gradient does (``tests/test_torch_ssd_grad.py``).

    Bm and Cm are shared by the heads, so their gradients sum over H.  dA
    has A's shape: summed over the batch and chunks for a shared (H,) A,
    per row for a (B, H) one.  dx, dBm and dCm are returned in their
    input's dtype, ddt and dA in float32 (float64 for float64 inputs)."""
    f = _work_dtype(x)
    xf, Bf, Cf, dtf = x.to(f), Bm.to(f), Cm.to(f), dt.to(f)
    Af = _a_rows(A.to(f))
    cum = torch.cumsum(dtf * Af, dim=2)                   # (B, nc, Q, H)
    Q = x.shape[2]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              torch.full((), -1e30, device=x.device)))
    M = torch.einsum("bcin,bcjn->bcij", Cf, Bf)[..., None] * L
    xdt = xf * dtf[..., None]
    dy = dy.to(f)
    dxdt = torch.einsum("bcijh,bcihp->bcjhp", M, dy)
    dM = torch.einsum("bcihp,bcjhp->bcijh", dy, xdt)      # (B, nc, i, j, H)
    dS = (dM * L).sum(-1)                                 # d(C B^T)
    G = dM * M
    # sum_{j < r} G_ir at (i, r), summed over i >= r: G's block i >= r > j
    pre = torch.nn.functional.pad(torch.cumsum(G[:, :, :, :-1], dim=3),
                                  (0, 0, 1, 0))
    daG = torch.diagonal(torch.flip(torch.cumsum(torch.flip(pre, (2,)),
                                                 dim=2), (2,)),
                         dim1=2, dim2=3).permute(0, 1, 3, 2)
    dcum = torch.zeros_like(daG)          # dcum's other terms (B, nc, Q, H)
    dB = torch.einsum("bcij,bcin->bcjn", dS, Cf)
    dC = torch.einsum("bcij,bcjn->bcin", dS, Bf)
    if dstates is not None:
        w = torch.exp(cum[:, :, -1:, :] - cum)
        dst = dstates.to(f)
        U = torch.einsum("bcjn,bchnp->bcjhp", Bf, dst)    # B dstate
        dxdt = dxdt + w[..., None] * U
        dww = (U * xdt).sum(-1) * w                       # dw_j w_j
        dcum = dcum - dww
        dcum[:, :, -1] += dww.sum(2)
        dB = dB + torch.einsum("bcjhp,bchnp->bcjn", w[..., None] * xdt, dst)
    if ddecays is not None:
        dcum[:, :, -1] += ddecays.to(f) * torch.exp(cum[:, :, -1])
    da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,)) + daG
    ddt = da * Af + (dxdt * xf).sum(-1)
    dA = (da * dtf).sum((1, 2))                           # (B, H)
    if A.dim() == 1:
        dA = dA.sum(0)
    return (dxdt * dtf[..., None]).to(x.dtype), ddt, dA, dB.to(Bm.dtype), \
        dC.to(Cm.dtype)


def ssd_ref(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD, the dual form of Mamba-2 (``repro.models.ssm.
    _ssd_chunked``): x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm
    (B, S, N) -> y (B, S, H, P) in x's dtype.

    L is masked BEFORE the exp (for i < j the difference is positive and
    would overflow), and the inter-chunk recurrence emits the state from
    before each chunk."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    nc = S // Q
    a = dt * A[None, None, :]
    xr = x.reshape(Bsz, nc, Q, H, P)
    ar = a.reshape(Bsz, nc, Q, H)
    dtr = dt.reshape(Bsz, nc, Q, H)
    Br = Bm.reshape(Bsz, nc, Q, N).to(torch.float32)
    Cr = Cm.reshape(Bsz, nc, Q, N).to(torch.float32)

    cum = torch.cumsum(ar, dim=2)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              torch.full((), -1e30, device=x.device)))
    scores = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    M = scores[..., None] * L
    xdt = xr.to(torch.float32) * dtr[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xdt)

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    chunk_states = torch.einsum("bcjh,bcjn,bcjhp->bchnp", decay_to_end * dtr,
                                Br, xr.to(torch.float32))
    chunk_decay = torch.exp(cum[:, :, -1, :])

    h = torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                           # the state before chunk c
        h = h * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    h_prev = torch.stack(h_prev, dim=1)            # (B, nc, H, N, P)

    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", Cr, torch.exp(cum),
                           h_prev)
    return (y_intra + y_inter).reshape(Bsz, S, H, P).to(x.dtype)
