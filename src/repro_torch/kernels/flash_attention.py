"""Grouped-query attention with an online softmax (the model's full-sequence
attention: prefill and training).

Port of ``repro.kernels.flash_attention``.  On a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/flash_attention.cu`` (float32
scores and accumulator, output in q's dtype): bfloat16 on the tensor cores,
float32 on the CUDA cores.  On a CPU tensor it runs the plain version,
``kernels/ref.py::sdpa``.  Any other device raises; nothing falls back.
``flash_attention.launches`` counts launches.

Unlike the TPU kernel, any Sq and Skv are taken (the kernel masks the
ragged edge), and q, k and v are read through their strides in the
(B, S, heads, hd) layout.  The bfloat16 route copies 16 bytes at a time,
so it needs each of q, k and v 16-byte aligned with its batch, sequence
and head strides multiples of 8 elements; a view that breaks this raises
``ValueError``.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

__all__ = ["flash_attention", "HEAD_DIMS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's
    dtype.  Query head h attends with KV head h // (H // KV)."""
    if q.device.type == "cpu":
        return _ref.sdpa(q, k, v, causal=causal, window=window,
                         softcap=softcap)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on cuda or cpu tensors, got "
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
    if q.dtype == torch.bfloat16:
        for name, t in zip("qkv", (q, k, v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    f"bfloat16 {name} must be 16-byte aligned with strides "
                    f"along batch, sequence and head that are multiples of "
                    f"8, got address {t.data_ptr():#x} and strides "
                    f"{t.stride()}")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    out = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, Sq, Skv, H, KV, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(bool(causal)), int(window), float(softcap),
        _ref.attn_scale(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention kernel launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
