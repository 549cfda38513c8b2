"""Mamba-2 SSD (state-space duality): the intra-chunk kernel, its gradient,
and the full chunked scan of the model's prefill and training.

Port of ``repro.kernels.ssd_chunk`` and of ``repro.kernels.ops.ssd``.  On a
CUDA tensor ``ssd_chunk`` launches the hand-written kernel in
``csrc/ssd_chunk.cu``: bfloat16 x, Bm and Cm go to its tensor-core route
(bf16 products, float32 sums, the weights split into bf16 terms), float32
ones to its CUDA-core route; on a CPU tensor it runs the plain version,
``ref.ssd_chunk_ref``.  Any other device raises; nothing falls back.
``ssd_chunk.launches`` counts launches.

The gradient: the TPU kernel has none (the JAX package differentiates the
plain ``_ssd_chunked``).  Here ``ssd_chunk`` is a ``torch.autograd.
Function`` whose backward is a second Function around ``ssd_chunk_bwd``:
the kernels of ``csrc/ssd_chunk_bwd.cu`` on a CUDA tensor (counted by
``ssd_chunk_bwd.launches``; bfloat16 inputs on the tensor cores, their
float32 operands split into bf16 terms, float32 inputs on the CUDA cores),
the hand-derived ``ref.ssd_chunk_bwd`` on a CPU tensor.
Both Functions carry a ``vmap`` rule that folds the mapped axis into the
batch, so ``torch.func.vmap(grad(loss))`` over a cohort launches one kernel
a call for the whole cohort.  A, which each client's weights make its own
from the second local step on, is then one row of H per folded batch row:
both kernels read A through a batch stride (0 for the shared (H,) A of
prefill and serve).

x, dt, Bm and Cm are read through their strides (unit stride along the
last axis): the model's x is a view of the convolution's output, and the
wrappers make no copy of it.

``ssd`` reshapes into chunks, calls ``ssd_chunk`` and runs the inter-chunk
recurrence in torch, with one body for both devices, so the CPU tests run
the recurrence, and the hand-derived backward, that run on the card.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["ssd_chunk", "ssd_chunk_bwd", "ssd"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128          # the kernels take Q and N up to this, the forward P
MAX_BWD_P = 64         # the backward's P (its shared memory)
_MAX_GRID = 65535      # chunks and batch are grid axes y and z


def _check(x, dt, A, Bm, Cm, name):
    """The kernels' contract on (x, dt, A, Bm, Cm); returns (B, nc, Q, H,
    P, N) and A's batch stride."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu tensors, got "
                           f"{x.device}")
    if x.dim() != 5 or dt.dim() != 4 or A.dim() not in (1, 2) \
            or Bm.dim() != 4:
        raise ValueError("x must be (B, nc, Q, H, P), dt (B, nc, Q, H), "
                         "A (H,) or (B, H), Bm and Cm (B, nc, Q, N)")
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, nc, Q, H)
            or tuple(A.shape) not in ((H,), (B, H))
            or tuple(Bm.shape) != (B, nc, Q, N) or Cm.shape != Bm.shape):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)} "
            f"do not agree")
    if not (1 <= Q <= MAX_DIM and 1 <= N <= MAX_DIM and 1 <= P <= MAX_DIM):
        raise ValueError(f"Q = {Q}, N = {N}, P = {P}: each must be in "
                         f"[1, {MAX_DIM}]")
    if nc > _MAX_GRID or B > _MAX_GRID:
        raise ValueError(f"{nc} chunks x batch {B}: each must be <= "
                         f"{_MAX_GRID}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must share one of {tuple(_DTYPES)}, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    if not all(t.device == x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, Bm and Cm must be on one device")
    if any(t.stride(-1) != 1 for t in (x, dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, Bm and Cm must have unit stride along "
                         "their last axis")
    return (B, nc, Q, H, P, N), (A.stride(0) if A.dim() == 2 else 0)


def _forward(x, dt, A, Bm, Cm):
    if x.device.type == "cpu":
        return _ref.ssd_chunk_ref(x, dt, A, Bm, Cm)
    (B, nc, Q, H, P, N), asb = _check(x, dt, A, Bm, Cm, "ssd_chunk")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(B, nc, Q, H, P, **f32)
    states = torch.empty(B, nc, H, N, P, **f32)
    decays = torch.empty(B, nc, H, **f32)
    if y.numel() == 0:
        return y, states, decays
    lib = _build.load("ssd_chunk")
    err = lib.ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), states.data_ptr(), decays.data_ptr(),
        _DTYPES[x.dtype], B, nc, Q, H, P, N, *x.stride()[:4],
        *dt.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3], asb,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_chunk kernel launch")
    ssd_chunk.launches += 1
    return y, states, decays


def ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, dstates=None, ddecays=None):
    """(dx, ddt, dA, dBm, dCm) of :func:`ssd_chunk` at (x, dt, A, Bm, Cm)
    against the gradients dy (B, nc, Q, H, P), dstates (B, nc, H, N, P) and
    ddecays (B, nc, H) of its three outputs (``None``: zero).  dx, dBm and
    dCm in their input's dtype, ddt float32, dA float32 of A's shape
    (summed over the batch for a shared (H,) A, per row for a (B, H) one).
    The kernels on a CUDA tensor (P up to 64), ``ref.ssd_chunk_bwd`` on a
    CPU tensor."""
    if x.device.type == "cpu":
        return _ref.ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, dstates, ddecays)
    (B, nc, Q, H, P, N), asb = _check(x, dt, A, Bm, Cm, "ssd_chunk_bwd")
    if P > MAX_BWD_P:
        raise ValueError(f"P = {P}: the backward kernel takes P up to "
                         f"{MAX_BWD_P}")
    want = {"dy": (dy, (B, nc, Q, H, P)), "dstates": (dstates, (B, nc, H, N, P)),
            "ddecays": (ddecays, (B, nc, H))}
    for name, (t, shape) in want.items():
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32
                              or t.device != x.device):
            raise ValueError(f"{name} must be {shape} float32 on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    dy = dy.contiguous()
    dstates = None if dstates is None else dstates.contiguous()
    ddecays = None if ddecays is None else ddecays.contiguous()
    dx = torch.empty(B, nc, Q, H, P, dtype=x.dtype, device=x.device)
    ddt = torch.empty(B, nc, Q, H, dtype=torch.float32, device=x.device)
    dA = torch.empty(A.shape, dtype=torch.float32, device=x.device)
    dBm = torch.empty(B, nc, Q, N, dtype=Bm.dtype, device=x.device)
    dCm = torch.empty_like(dBm)
    if dx.numel() == 0:
        return dx, ddt, dA.zero_(), dBm.zero_(), dCm.zero_()
    lib = _build.load("ssd_chunk_bwd")
    ws = torch.empty(lib.ssd_chunk_bwd_workspace_floats(
        B, nc, Q, H, P, N, int(dstates is not None), _DTYPES[x.dtype]),
        dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()     # noqa: E731
    err = lib.ssd_chunk_bwd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), dy.data_ptr(), ptr(dstates), ptr(ddecays),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(),
        dCm.data_ptr(), ws.data_ptr(), _DTYPES[x.dtype], B, nc, Q, H, P, N,
        *x.stride()[:4], *dt.stride()[:3], *Bm.stride()[:3],
        *Cm.stride()[:3], asb, int(A.dim() == 2),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_chunk_bwd kernel launch")
    ssd_chunk_bwd.launches += 1
    return dx, ddt, dA, dBm, dCm


ssd_chunk_bwd.launches = 0


def _fold(t, dim, n):
    """``t`` with its vmapped axis ``dim`` (None: not mapped, so expanded to
    ``n``) folded into the batch axis that follows it: (n * B, ...), a view
    where the strides allow it (the kernels read strides)."""
    if t is None:
        return None
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    t = t.reshape(n * t.shape[1], *t.shape[2:])
    return t if t.stride(-1) == 1 else t.contiguous()


def _fold_a(A, dim, n, rows, shared):
    """A for a batch of n * rows folded rows: one row of H per folded row,
    a client's A on each of its rows, or, where A is not mapped and
    ``shared``, the one (H,) A of every row."""
    if dim is None:
        if A.dim() == 1:
            return A if shared else A.expand(n * rows, A.shape[0])
        return _fold(A, None, n)
    A = A.movedim(dim, 0)
    if A.dim() == 2:                       # one (H,) A a client
        A = A[:, None].expand(n, rows, A.shape[-1])
    return A.reshape(n * rows, A.shape[-1])


def _unfold(t, n):
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])


class _SsdChunk(torch.autograd.Function):
    """(y_intra, states, decays) = ssd_chunk(x, dt, A, Bm, Cm)."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm):
        return _forward(x, dt, A, Bm, Cm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        # an output that nothing reads gets None, not zeros: the backward
        # kernel then skips the states' pass (a one-chunk ``ssd``)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dy, dstates, ddecays):
        x = ctx.saved_tensors[0]
        if dy is None:
            dy = x.new_zeros(x.shape, dtype=torch.float32)
        return _SsdChunkBwd.apply(*ctx.saved_tensors, dy, dstates, ddecays)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bm, Cm):
        n = info.batch_size
        xf, dtf, Bf, Cf = (_fold(t, d, n) for t, d in
                           zip((x, dt, Bm, Cm), in_dims[:2] + in_dims[3:]))
        Af = _fold_a(A, in_dims[2], n, xf.shape[0] // n, shared=True)
        outs = _SsdChunk.apply(xf, dtf, Af, Bf, Cf)
        return tuple(_unfold(o, n) for o in outs), (0, 0, 0)


class _SsdChunkBwd(torch.autograd.Function):
    """(dx, ddt, dA, dBm, dCm) of :class:`_SsdChunk`; it has no gradient
    itself."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm, dy, dstates, ddecays):
        return ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, dstates, ddecays)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("ssd_chunk has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bm, Cm, dy, dstates, ddecays):
        # A one row per folded row, mapped or not, so that dA comes per
        # row and each client's dA is the sum over its own rows
        n = info.batch_size
        x_dim, dt_dim, a_dim, b_dim, c_dim, *g_dims = in_dims
        xf = _fold(x, x_dim, n)
        rows = xf.shape[0] // n
        grads = _SsdChunkBwd.apply(
            xf, _fold(dt, dt_dim, n),
            _fold_a(A, a_dim, n, rows, shared=False), _fold(Bm, b_dim, n),
            _fold(Cm, c_dim, n),
            *(_fold(t, d, n) for t, d in zip((dy, dstates, ddecays), g_dims)))
        dx, ddt, dA, dBm, dCm = (_unfold(g, n) for g in grads)
        if A.dim() - (a_dim is not None) == 1:   # A is (H,) to each client
            dA = dA.sum(1)
        return (dx, ddt, dA, dBm, dCm), (0, 0, 0, 0, 0)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor):
    """Intra-chunk SSD over all chunks.

    x: (B, nc, Q, H, P); dt: (B, nc, Q, H) float32; A: (H,) float32, or
    (B, H) for one A per batch row; Bm, Cm: (B, nc, Q, N).  Returns float32
    (y_intra (B, nc, Q, H, P), states (B, nc, H, N, P), decays (B, nc, H)).
    Differentiable (and ``torch.func``-transformable) in all five inputs."""
    return _SsdChunk.apply(x, dt, A, Bm, Cm)


ssd_chunk.launches = 0


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Full SSD: the intra-chunk kernel plus the inter-chunk recurrence
    (``repro.kernels.ops.ssd``).

    x: (B, S, H, P); dt: (B, S, H) float32; A: (H,); Bm, Cm: (B, S, N).
    Returns y (B, S, H, P) in x's dtype.  The recurrence h <- h * decay +
    state runs as one ``addcmul`` per chunk (nc - 1 launches), emitting the
    state from before each chunk, out of place so that autograd can
    differentiate it on the CPU; y_inter = exp(cum) * (C h_prev) is one
    batched matmul."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    nc = S // chunk
    xr = x.reshape(Bsz, nc, chunk, H, P)
    dtr = dt.reshape(Bsz, nc, chunk, H)
    Br = Bm.reshape(Bsz, nc, chunk, N)
    Cr = Cm.reshape(Bsz, nc, chunk, N)
    y_intra, states, decays = ssd_chunk(xr, dtr, A, Br, Cr)

    # h_prev[c] is the state before chunk c: (nc, B, H, N, P)
    h = [torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)]
    for c in range(nc - 1):
        h.append(torch.addcmul(states[:, c], h[c],
                               decays[:, c, :, None, None]))
    h_prev = torch.stack(h)
    cum = torch.cumsum(dtr * A[None, None, None, :], dim=2)   # (B, nc, Q, H)
    # (B, nc, 1, Q, N) @ (B, nc, H, N, P) -> (B, nc, H, Q, P)
    ch = torch.matmul(Cr.to(torch.float32)[:, :, None],
                      h_prev.permute(1, 0, 2, 3, 4))
    y_inter = ch.permute(0, 1, 3, 2, 4) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(Bsz, S, H, P).to(x.dtype)
