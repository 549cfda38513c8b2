"""Chunked cross-entropy (port of ``repro.models.losses``).

``chunked_softmax_xent`` takes the logits one sequence chunk at a time, the
gold logit by an iota == target masked sum and the log-sum-exp in float32
on the chunk only.  ``fused_unembed_xent`` also forms each chunk's logits
from the final hidden states inside the loop, so the (B, T, V) logits are
never materialised: at llama3.2-1b's 128,256-token vocabulary and
S = 4096 they would take 2.1 GB a sequence in float32.  Each chunk is
checkpointed (``repro_torch.remat``): its backward forms the logits tile
again from the (B, chunk, d) activations instead of keeping it.

Both pad T to a multiple of the chunk (the padded positions are masked
out) and return the masked mean, as the JAX functions do; the running
max of the log-sum-exp is detached, as JAX's ``stop_gradient`` is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..remat import checkpoint

__all__ = ["chunked_softmax_xent", "fused_unembed_xent"]


def _pad_t(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` (B, T, ...) padded with zeros (False) to T + pad."""
    if x.dim() == 2:
        return F.pad(x, (0, pad))
    return F.pad(x, (0, 0, 0, pad))


def _chunk_nll(lgf: torch.Tensor, tgc: torch.Tensor,
               mkc: torch.Tensor) -> torch.Tensor:
    """Σ over the chunk's unmasked positions of logsumexp − gold logit;
    ``lgf`` is the (B, chunk, V) float32 logits tile."""
    m = lgf.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.sum(torch.exp(lgf - m), dim=-1)) + m[..., 0]
    iota = torch.arange(lgf.shape[-1], device=lgf.device)
    gold = torch.sum(torch.where(iota == tgc[..., None], lgf,
                                 torch.zeros((), dtype=lgf.dtype,
                                             device=lgf.device)), dim=-1)
    return torch.sum((logz - gold) * mkc.to(torch.float32))


def chunked_softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, chunk: int = 512):
    """Mean masked CE.  logits: (B, T, V); targets, mask: (B, T)."""
    T = logits.shape[1]
    pad = (-T) % chunk
    if pad:
        logits, targets, mask = (_pad_t(x, pad)
                                 for x in (logits, targets, mask))
    nll, cnt = [], []
    for c in range(0, T + pad, chunk):
        sl = slice(c, c + chunk)
        nll.append(_chunk_nll(logits[:, sl].to(torch.float32), targets[:, sl],
                              mask[:, sl]))
        cnt.append(torch.sum(mask[:, sl].to(torch.float32)))
    return torch.stack(nll).sum() / torch.clamp_min(torch.stack(cnt).sum(),
                                                    1.0)


def _unembed_nll(tensors, static):
    xc, proj = tensors
    tgc, mkc = static
    return _chunk_nll((xc @ proj).to(torch.float32), tgc, mkc)


def fused_unembed_xent(x: torch.Tensor, proj: torch.Tensor,
                       targets: torch.Tensor, mask: torch.Tensor,
                       chunk: int = 512):
    """Mean masked CE with the unembedding fused into the chunk loop.

    x: (B, T, d) final hidden states; proj: (d, V); targets, mask: (B, T).
    The sums run over the chunks in order, as JAX's ``lax.scan`` carries
    them."""
    T = x.shape[1]
    pad = (-T) % chunk
    if pad:
        x, targets, mask = (_pad_t(t, pad) for t in (x, targets, mask))
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, T + pad, chunk):
        sl = slice(c, c + chunk)
        nll = nll + checkpoint(_unembed_nll, (targets[:, sl], mask[:, sl]),
                               x[:, sl], proj)
        cnt = cnt + torch.sum(mask[:, sl].to(torch.float32))
    return nll / torch.clamp_min(cnt, 1.0)
