"""Threefry-2x32 key stream, bit-identical to ``jax.random`` (partitionable).

The F3AST trajectory is a function of the PRNG key stream: availability
masks, the f3ast tie-break and the minibatch indices all come from it.  So
the port does not use ``torch.Generator``; it reproduces JAX's default
threefry2x32 PRNG with ``jax_threefry_partitionable=True`` (the default of
current JAX releases), draw for draw:

* a key is a (2,) tensor of uint32 words (held in int64, see below);
* ``bits(key, shape)``   = ``b1 ^ b2`` of ``threefry2x32(key, hi(i), lo(i))``
  over the row-major flat index ``i`` of ``shape``; ``start=s`` draws the
  lanes ``[s, s + size)`` of a larger draw, so a large leaf can be drawn in
  chunks with the same bits;
* ``split(key, n)``      = ``stack([b1, b2], -1)`` over the same counters;
* ``fold_in(key, d)``    = ``threefry2x32(key, 0, d)``;
* ``uniform``            = ``((bits >> 9) | 0x3F800000).view(f32) - 1``,
  then ``max(lo, u * (hi - lo) + lo)`` (one FMA) on ``[lo, hi)``;
* ``normal``             = ``sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))``
  with XLA's float32 ``erf_inv`` (``xla_math``);
* ``bernoulli(key, p)``  = ``uniform(key, p.shape) < p``;
* ``randint``            = JAX's ``_randint``: two ``bits`` draws from
  ``split(key)`` folded into ``[minval, maxval)`` with uint32 span /
  multiplier arithmetic.

Torch's CPU ``uint32`` lacks ``+``, ``<<``, ``>>`` and ``%``, so every word
is computed in ``int64`` and masked with ``& 0xFFFFFFFF``.  Keys and draws
live on the device of the key tensor; nothing here synchronises.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from . import xla_math
from .device import resolve_device

__all__ = ["PRNGKey", "bernoulli", "bits", "fold_in", "key_data", "normal",
           "randint", "split", "threefry2x32", "uniform"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_FLOAT_ONE_BITS = 0x3F800000

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off (JAX's default):
    the seed is taken as 32 bits, so the key is ``[0, seed & M32]``.
    ``device=None`` means CUDA, as everywhere in the port."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def key_data(key: torch.Tensor):
    """The key's words as a numpy uint32 array (what ``jax.random.key_data``
    returns), for comparisons with the JAX package."""
    import numpy as np
    return key.cpu().numpy().astype(np.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round Threefry-2x32 block function on counter words (x0, x1),
    as ``jax._src.prng._threefry2x32_lowering`` computes it.  The key's
    words (``key[..., 0]``, ``key[..., 1]``) broadcast against the
    counters."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _counters(key: torch.Tensor, shape: tuple, start: int = 0):
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(start, start + n, dtype=torch.int64,
                       device=key.device).reshape(shape)
    return idx >> 32, idx & _M32


def bits(key: torch.Tensor, shape: Shape, *, start: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words, in int64).  With
    ``start``, the lanes ``[start, start + size)`` of a flat draw from the
    same key (``start=0``: the draw itself)."""
    hi, lo = _counters(key, _shape(shape), start)
    b1, b2 = threefry2x32(key, hi, lo)
    return b1 ^ b2


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: a (num, 2) stack of keys.  A stack
    of keys (..., 2) is split key by key (``vmap(split)``), giving
    (..., num, 2)."""
    hi, lo = _counters(key, (int(num),))
    b1, b2 = threefry2x32(key.unsqueeze(-2), hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a Python int ``data``."""
    d = torch.tensor([int(data) & _M32], dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.cat([b1, b2])


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, *, start: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.

    On [0, 1) it is the mantissa trick alone.  Otherwise ``minval`` and
    ``maxval`` are rounded to float32 and the [0, 1) draw is mapped as
    XLA:CPU computes it: ``max(minval, fma(u, maxval - minval, minval))``."""
    fb = (bits(key, shape, start=start) >> 9) | _FLOAT_ONE_BITS
    u = fb.to(torch.int32).view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return u
    lo, hi = xla_math.f32(minval), xla_math.f32(maxval)
    return torch.clamp_min(xla_math.fma(u, xla_math.f32(hi - lo), lo), lo)


_NORMAL_LO = xla_math.f32(-1.0 + 2.0 ** -24)      # nextafter(-1, 0) in f32
_SQRT2 = xla_math.f32(math.sqrt(2.0))


def normal(key: torch.Tensor, shape: Shape = (), *,
           start: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32, bit for bit:
    ``sqrt(2) * erf_inv(u)`` with u uniform on [nextafter(-1, 0), 1) and
    XLA's ``erf_inv``.  ``start`` as in :func:`bits`."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, start=start)
    return xla_math.erf_inv(u) * _SQRT2


def bernoulli(key: torch.Tensor, p, shape: Shape | None = None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p)``: ``uniform(key, shape) < p``, with
    ``shape`` defaulting to ``p``'s shape.  ``p`` is a float32 tensor or a
    Python float (cast to float32, as JAX does with a weak scalar)."""
    if not torch.is_tensor(p):
        p = torch.tensor(p, dtype=torch.float32, device=key.device)
    shape = tuple(p.shape) if shape is None else _shape(shape)
    return uniform(key, shape) < p


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 ``a * b`` (wrapping) without an int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def randint(key: torch.Tensor, shape: Shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 output.

    ``minval``/``maxval`` are ints or int tensors broadcastable to
    ``shape`` (the cohort gather passes per-row bounds
    ``counts[:, None, None]``).  Ported op for op from JAX's ``_randint``:
    two 32-bit draws from ``split(key)``, reduced mod the span with the
    ``2**32 % span`` multiplier, all in uint32 arithmetic.
    """
    shape = _shape(shape)
    dev = key.device
    minval = torch.as_tensor(minval, device=dev).to(torch.int64)
    maxval = torch.as_tensor(maxval, device=dev).to(torch.int64)
    k1, k2 = split(key, 2)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = (maxval - minval) & _M32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    multiplier = torch.remainder(torch.full_like(span, 1 << 16), span)
    multiplier = torch.remainder(_mul32(multiplier, multiplier), span)
    offset = (_mul32(torch.remainder(higher, span), multiplier)
              + torch.remainder(lower, span)) & _M32
    offset = torch.remainder(offset, span)
    # the int32 result: minval + (int32) offset, wrapping as XLA's add does
    out = (minval + offset) & _M32
    out = torch.where(out >= 1 << 31, out - (1 << 32), out)
    return out.to(torch.int32)
