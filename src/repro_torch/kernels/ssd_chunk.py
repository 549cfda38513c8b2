"""Mamba-2 SSD (state-space duality): the intra-chunk kernel and the full
chunked scan of the model's prefill.

Port of ``repro.kernels.ssd_chunk`` and of ``repro.kernels.ops.ssd``.  On a
CUDA tensor ``ssd_chunk`` launches the hand-written kernel in
``csrc/ssd_chunk.cu``: bfloat16 x, Bm and Cm go to its tensor-core route
(bf16 products, float32 sums, the weights split into bf16 terms), float32
ones to its CUDA-core route; on a CPU tensor it runs the plain version,
``ref.ssd_chunk_ref``.  Any other device raises; nothing falls back.
``ssd_chunk.launches`` counts launches.

x, dt, Bm and Cm are read through their strides (unit stride along the
last axis): the model's x is a view of the convolution's output, and the
wrapper makes no copy of it.

``ssd`` reshapes into chunks, calls ``ssd_chunk`` and runs the inter-chunk
recurrence in torch, with one body for both devices, so the CPU tests run
the recurrence that runs on the card.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["ssd_chunk", "ssd"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128          # the kernel takes Q, N and P up to this
_MAX_GRID = 65535      # chunks and batch are grid axes y and z


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor):
    """Intra-chunk SSD over all chunks.

    x: (B, nc, Q, H, P); dt: (B, nc, Q, H) float32; A: (H,) float32;
    Bm, Cm: (B, nc, Q, N).  Returns float32 (y_intra (B, nc, Q, H, P),
    states (B, nc, H, N, P), decays (B, nc, H))."""
    if x.device.type == "cpu":
        return _ref.ssd_chunk_ref(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_chunk runs on cuda or cpu tensors, got "
                           f"{x.device}")
    if x.dim() != 5 or dt.dim() != 4 or A.dim() != 1 or Bm.dim() != 4:
        raise ValueError("x must be (B, nc, Q, H, P), dt (B, nc, Q, H), "
                         "A (H,), Bm and Cm (B, nc, Q, N)")
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, nc, Q, H) or tuple(A.shape) != (H,)
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
    if any(t.stride(-1) != 1 for t in (x, dt, Bm, Cm)):
        raise ValueError("x, dt, Bm and Cm must have unit stride along their "
                         "last axis")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(B, nc, Q, H, P, **f32)
    states = torch.empty(B, nc, H, N, P, **f32)
    decays = torch.empty(B, nc, H, **f32)
    if y.numel() == 0:
        return y, states, decays
    A = A.contiguous()
    lib = _build.load("ssd_chunk")
    err = lib.ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), states.data_ptr(), decays.data_ptr(),
        _DTYPES[x.dtype], B, nc, Q, H, P, N, *x.stride()[:4],
        *dt.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_chunk kernel launch")
    ssd_chunk.launches += 1
    return y, states, decays


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
