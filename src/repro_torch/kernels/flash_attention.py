"""Grouped-query attention with an online softmax (the model's full-sequence
attention: prefill and training), and its gradient.

Port of ``repro.kernels.flash_attention``.  On a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/flash_attention.cu`` (float32
scores and accumulator, output in q's dtype): bfloat16 on the tensor cores,
float32 on the CUDA cores.  On a CPU tensor it runs the plain version,
``kernels/ref.py::sdpa``.  Any other device raises; nothing falls back.
``flash_attention.launches`` counts launches.

The gradient: the TPU kernel has none (the JAX package differentiates the
plain ``sdpa``).  Here ``flash_attention`` is a ``torch.autograd.Function``
whose backward is a second Function around ``flash_attention_bwd``: the
kernel of ``csrc/flash_attention_bwd.cu`` on a CUDA tensor (counted by
``flash_attention_bwd.launches``), ``ref.sdpa_bwd`` on a CPU tensor.  When
a gradient is recorded the forward also returns each row's log-sum-exp,
which the backward reads; where none is (prefill, serve) the kernel writes
none and runs as before.  Both Functions carry a ``vmap`` rule that folds
the mapped axis into the batch, so ``torch.func.vmap(grad(loss))`` over a
cohort launches one kernel a call for the whole cohort.

Unlike the TPU kernel, any Sq and Skv are taken (the kernel masks the
ragged edge), and q, k and v are read through their strides in the
(B, S, heads, hd) layout.  The bfloat16 forward copies 16 bytes at a time,
so it needs each of q, k and v 16-byte aligned with its batch, sequence
and head strides multiples of 8 elements; a view that breaks this raises
``ValueError``.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_bwd",
           "HEAD_DIMS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def _check(q, k, v, window, softcap, name):
    if q.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu tensors, got "
                           f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D (B, S, heads, hd)")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, KV, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must be ({B}, Skv, KV, {hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"H = {H} is not a multiple of KV = {KV}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {tuple(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must have unit stride along head_dim")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")


def _forward(q, k, v, causal, window, softcap, with_lse):
    """(o, lse): lse (B, H, Sq) float32 when ``with_lse``, else an empty
    tensor (the kernel is given a null pointer)."""
    if q.device.type == "cpu":
        if with_lse:
            return _ref.sdpa_lse(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
        o = _ref.sdpa(q, k, v, causal=causal, window=window, softcap=softcap)
        return o, q.new_empty(0, dtype=torch.float32)
    _check(q, k, v, window, softcap, "flash_attention")
    if q.dtype == torch.bfloat16:
        for name, t in zip("qkv", (q, k, v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    f"bfloat16 {name} must be 16-byte aligned with strides "
                    f"along batch, sequence and head that are multiples of "
                    f"8, got address {t.data_ptr():#x} and strides "
                    f"{t.stride()}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq) if with_lse else (0,), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.load("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        _DTYPES[q.dtype], B, Sq, Skv, H, KV, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(bool(causal)), int(window), float(softcap),
        _ref.attn_scale(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention kernel launch")
    flash_attention.launches += 1
    return out, lse


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """(o, lse) of :func:`flash_attention` as its gradient's forward makes
    them: ``o`` and each row's log-sum-exp ``lse`` (B, H, Sq) float32, the
    pair :func:`flash_attention_bwd` reads.  Records no gradient."""
    return _forward(q, k, v, causal, window, softcap, True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of :func:`flash_attention` from its inputs, its output
    ``o``, the row log-sum-exp ``lse`` (B, H, Sq) float32 and the output's
    gradient ``do``; each in its input's dtype.  The kernel on a CUDA
    tensor, ``ref.sdpa_bwd`` on a CPU tensor."""
    if q.device.type == "cpu":
        return _ref.sdpa_bwd(q, k, v, o, lse, do, causal=causal,
                             window=window, softcap=softcap)
    _check(q, k, v, window, softcap, "flash_attention_bwd")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o, do = o.contiguous(), do.to(q.dtype).contiguous()
    lse = lse.contiguous()
    if (tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape)
            or o.dtype != q.dtype or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, Sq)):
        raise ValueError(f"o and do must be {tuple(q.shape)} {q.dtype} and "
                         f"lse ({B}, {H}, {Sq}) float32, got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)}, "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if any(t.device != q.device for t in (o, lse, do)):
        raise ValueError("o, lse and do must lie on q's device")
    dq = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device)
    dk = torch.empty(B, Skv, KV, hd, dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 and dk.numel() == 0:
        return dq, dk, dv
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_bwd")
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], B, Sq, Skv, H, KV,
        hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(bool(causal)), int(window), float(softcap),
        _ref.attn_scale(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd kernel launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _fold(t, dim, n):
    """``t`` with its vmapped axis ``dim`` (None: not mapped, so expanded to
    ``n``) folded into the batch axis that follows it: (n * B, ...)."""
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()


def _unfold(t, n):
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])


class _Flash(torch.autograd.Function):
    """(o, lse) = attention(q, k, v); lse is not differentiable."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap, with_lse):
        return _forward(q, k, v, causal, window, softcap, with_lse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, softcap, with_lse = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mode = (causal, window, softcap, with_lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        causal, window, softcap, with_lse = ctx.mode
        if not with_lse:
            raise RuntimeError("flash_attention was called without a "
                               "recorded gradient, so it kept no lse")
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashBwd.apply(q, k, v, o, lse, do, causal, window,
                                     softcap)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, softcap, with_lse):
        n = info.batch_size
        o, lse = _Flash.apply(*(_fold(t, d, n) for t, d in
                                zip((q, k, v), in_dims[:3])),
                              causal, window, softcap, with_lse)
        if with_lse:
            return (_unfold(o, n), _unfold(lse, n)), (0, 0)
        return (_unfold(o, n), lse), (0, None)


class _FlashBwd(torch.autograd.Function):
    """(dq, dk, dv) of :class:`_Flash`; it has no gradient itself."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window, softcap):
        return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window, softcap=softcap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, window, softcap):
        n = info.batch_size
        grads = _FlashBwd.apply(*(_fold(t, d, n) for t, d in
                                  zip((q, k, v, o, lse, do), in_dims[:6])),
                                causal, window, softcap)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's
    dtype.  Query head h attends with KV head h // (H // KV).
    Differentiable (and ``torch.func``-transformable) in q, k and v."""
    with_lse = torch.is_grad_enabled() and any(t.requires_grad
                                               for t in (q, k, v))
    return _Flash.apply(q, k, v, causal, window, softcap, with_lse)[0]


flash_attention.launches = 0
