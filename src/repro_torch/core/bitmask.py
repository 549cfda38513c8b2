"""Bit-packed boolean client masks: (N,) bool ⇄ (ceil(N/32),) words (port
of ``repro.core.bitmask``).

At N = 1e6–1e7 the per-round (N,) bool traffic — the selection and
completion masks streamed out of a chunk, and the full-width mask gather
of the sharded engine — is a round's largest data movement.  Packing 32
clients a word cuts it 8× without touching the semantics: engines pack at
the producer, drivers unpack once a chunk on the host.

Layout (little-endian within a word), the JAX package's: bit ``j`` of word
``w`` is client ``32*w + j``, so concatenating the packed blocks of a
client dimension split in multiples of 32 equals packing the whole mask.
Pad bits (clients >= n in the last word) pack as 0 and unpack as False.

Torch has no 32-bit unsigned arithmetic on the CPU, so a word is held as
an ``int32`` tensor carrying the uint32 bit pattern (``.view(np.uint32)``
on the host gives JAX's words).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["all_gather_bits", "n_words", "pack_bits", "unpack_bits",
           "unpack_bits_np"]

_WORD = 32
_M32 = 0xFFFFFFFF


def n_words(n: int) -> int:
    """Packed word count for an ``n``-bit mask: ceil(n / 32)."""
    return -(-int(n) // _WORD)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(…, N) bool → (…, ceil(N/32)) int32 words (uint32 bit patterns,
    little-endian bit order)."""
    n = mask.shape[-1]
    w = n_words(n)
    bits = mask.to(torch.int64)
    pad = w * _WORD - n
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(mask.shape[:-1] + (w, _WORD))
    shifts = torch.arange(_WORD, dtype=torch.int64, device=mask.device)
    words = (bits << shifts).sum(-1)
    # [0, 2^32) as the int32 of the same bits
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(…, W) words → (…, n) bool with ``n <= 32*W`` (inverse of
    :func:`pack_bits`)."""
    w64 = words.to(torch.int64) & _M32
    shifts = torch.arange(_WORD, dtype=torch.int64, device=words.device)
    bits = (w64[..., :, None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * _WORD,))
    return flat[..., :n].to(torch.bool)


def unpack_bits_np(words: np.ndarray, n: int) -> np.ndarray:
    """Host-side :func:`unpack_bits` for a driver's chunk stream (int32 or
    uint32 words)."""
    words = np.ascontiguousarray(words)
    if words.dtype != np.uint32:
        words = words.astype(np.int64).astype(np.uint32)
    bits = (words[..., :, None] >> np.arange(_WORD, dtype=np.uint32)) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * _WORD,))
    return flat[..., :n].astype(bool)


def all_gather_bits(mask_blk: torch.Tensor, axis, n: int) -> torch.Tensor:
    """Packed ``all_gather`` of a shard's (n_local,) bool block → (n,) bool
    over the client mesh ``axis`` (a ``launch.mesh.ClientMesh``).  When the
    block length is a multiple of 32 the gather moves words (8× less
    traffic) and unpacks locally; otherwise the shards' pad bits would
    interleave mid-mask, so it gathers the bools — the same result either
    way."""
    n_local = mask_blk.shape[0]
    if n_local % _WORD:
        return axis.all_gather(mask_blk)[:n]
    words = axis.all_gather(pack_bits(mask_blk))
    return unpack_bits(words, words.shape[0] * _WORD)[:n]
