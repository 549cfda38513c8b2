"""State-space blocks (port of ``repro.models.ssm``): the depthwise causal
conv1d with its streaming state, the Mamba-2 SSD mixer (arXiv:2405.21060)
and the RG-LRU recurrent block of RecurrentGemma/Griffin
(arXiv:2402.19427), each for the full sequence (prefill) and for one token
against an O(1) state (decode).

The full-sequence Mamba-2 mixer calls ``kernels.ssd_chunk.ssd``, whose
intra-chunk step is the ``ssd_chunk`` kernel on a CUDA tensor and its plain
version on a CPU tensor (there is no ``use_kernel`` knob).  The RG-LRU's
gates and scan are plain torch, as the JAX package computes them outside
any kernel.
"""
from __future__ import annotations

import torch

from .. import random as jr
from ..kernels.ssd_chunk import ssd
from .. import xla_math
from .layers import (ModelConfig, _gelu, _normal, _silu, _softplus, inv_sqrt,
                     rms_norm, sqrt_f32)

__all__ = ["causal_conv1d", "causal_conv1d_step", "mamba2_dims",
           "init_mamba2", "mamba2_block", "mamba2_init_state",
           "mamba2_decode", "init_rglru", "rglru_block", "rglru_init_state",
           "rglru_decode"]


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (width W), with streaming state for decode
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); w: (W, D) depthwise taps; returns (B, S, D).  The taps
    are summed in JAX's order, tap 0 first, in x's dtype."""
    W, S = w.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = pad[:, 0:S, :] * w[0]
    for i in range(1, W):
        out = out + pad[:, i:i + S, :] * w[i]
    return out + b


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor):
    """x_t: (B, 1, D); conv_state: (B, W-1, D) past inputs.  Returns
    (y_t (B, 1, D), the new state (B, W-1, D)).  The W taps are summed in
    float32, tap 0 first, and rounded once to x's dtype, as JAX's einsum
    computes them."""
    window = torch.cat([conv_state, x_t], dim=1)                # (B, W, D)
    w32 = w.to(torch.float32)
    acc = window[:, 0].to(torch.float32) * w32[0]
    for i in range(1, w.shape[0]):
        acc = acc + window[:, i].to(torch.float32) * w32[i]
    y = acc.to(x_t.dtype)[:, None, :] + b
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state      # x, B, C go through the conv
    return d_inner, n_heads, conv_dim


def init_mamba2(key: torch.Tensor, cfg: ModelConfig):
    """The mixer's weights from ``key`` as the JAX package draws them
    (``split(key, 6)``: in_proj, conv_w, out_proj from the first three;
    in_proj times ``1 / sqrt(d)``, conv_w times float32 0.1, out_proj
    divided by ``sqrt(d_inner)``, all in float32 before the cast).
    A_log = log(linspace(1, 16, H)), D = 1, dt_bias = 0, conv_b = 0 and
    norm = 0 are JAX's leaves (A_log within an ulp: torch's and XLA's
    linspace and log round differently).  ``key`` may be a stack of keys
    ``lead + (2,)`` (one per layer), which gives each leaf the ``lead``
    axes in front."""
    d = cfg.d_model
    d_inner, H, conv_dim = mamba2_dims(cfg)
    N = cfg.ssm_state
    proj_out = 2 * d_inner + 2 * N + H           # z, x, B, C, dt
    dt = cfg.torch_dtype
    device = key.device
    lead = tuple(key.shape[:-1])
    k = jr.split(key, 6)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "in_proj": _normal(k[..., 0, :], (d, proj_out), inv_sqrt(d, device),
                           dt),
        "conv_w": _normal(k[..., 1, :], (cfg.conv_width, conv_dim),
                          torch.tensor(0.1, **f32), dt),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dt, device=device),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), **f32),
        "dt_bias": torch.zeros(lead + (H,), **f32),
        "norm": torch.zeros(lead + (d_inner,), dtype=dt, device=device),
        "out_proj": _normal(k[..., 2, :], (d_inner, d),
                            sqrt_f32(d_inner, device), dt, divide=True),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """(z, xBC, dt) of the in-projection; xBC is the slice that goes
    through the conv (x, B and C are adjacent, so no concatenation)."""
    d_inner, _, conv_dim = mamba2_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xbc, dt


def mamba2_block(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer.  x: (B, S, d_model)."""
    B, S, _ = x.shape
    d_inner, H, _ = mamba2_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(x @ p["in_proj"], cfg)
    xbc = _silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_inner]
    Bm = xbc[..., d_inner:d_inner + N]
    Cm = xbc[..., d_inner + N:]
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, H, P)             # a view: the kernel reads strides
    y = ssd(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xh.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y * _silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype, device,
                      lead: tuple = ()):
    d_inner, H, conv_dim = mamba2_dims(cfg)
    return {
        "ssm": torch.zeros(lead + (batch, H, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def mamba2_decode(p, x_t: torch.Tensor, cfg: ModelConfig, state):
    """Single-token recurrent update.  x_t: (B, 1, d_model).  Returns
    (y (B, 1, d_model), state).

    Unlike the JAX package, ``state``'s tensors are updated in place
    (h <- decay * h + dt B x^T, and the conv window shifted by one) and
    returned: no copy of the state is made per step."""
    B = x_t.shape[0]
    d_inner, H, _ = mamba2_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(x_t @ p["in_proj"], cfg)
    xbc_t, new_conv = causal_conv1d_step(xbc, state["conv"], p["conv_w"],
                                         p["conv_b"])
    conv = state["conv"].copy_(new_conv)
    xbc_t = _silu(xbc_t)
    xs = xbc_t[..., :d_inner]
    Bm = xbc_t[:, 0, d_inner:d_inner + N].to(torch.float32)
    Cm = xbc_t[:, 0, d_inner + N:].to(torch.float32)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])[:, 0]      # (B, H)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, H, P).to(torch.float32)
    decay = torch.exp(dt * A[None, :])                              # (B, H)
    # h <- decay * h + dt * B x^T ;  y = C . h + D x
    upd = (dt[:, :, None] * xh)[:, :, None, :] * Bm[:, None, :, None]
    h = state["ssm"].mul_(decay[..., None, None]).add_(upd)
    y = torch.matmul(Cm[:, None, None, :], h)[:, :, 0, :]          # (B, H, P)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(x_t.dtype)
    y = rms_norm(y * _silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"ssm": h, "conv": conv}


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin recurrent block)
# ---------------------------------------------------------------------------

_RG_C = 8.0


# Above this many lanes XLA:CPU's vectorised loop for ``jnp.linspace`` also
# fuses ``1 - i * r`` into an FMA, except in the last lanes that its
# 32-lane vector loop leaves to scalar code.
_LINSPACE_FUSED_ABOVE = 352


def _xla_linspace(start: float, stop: float, n: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, n)`` in float32 as XLA:CPU rounds it:
    ``start * (1 - i * r) + i * (stop * r)`` with r = float32(1 / (n - 1)),
    the last add fused into an FMA, and ``stop`` itself last.  Above
    _LINSPACE_FUSED_ABOVE lanes, ``1 - i * r`` is fused too, fma(-i, r, 1),
    in lanes i < 32 * floor((n - 1) / 32).  Against jnp.linspace(0.9,
    0.999, n) on jax 0.9.0: bitwise at every n < 2,700 but 12, 14, 15 and
    26, and at every 37th width from 2,700 to 4,439; above that some
    widths (4,476, 4,550, 5,000, ...) take another code path."""
    f32 = dict(dtype=torch.float32, device=device)
    s, e = torch.tensor(start, **f32), torch.tensor(stop, **f32)
    if n == 1:
        return s.reshape(1)
    div = n - 1
    r = torch.tensor(1.0 / div, **f32)
    i = torch.arange(div, **f32)
    one_minus = 1.0 - i * r
    if n > _LINSPACE_FUSED_ABOVE:
        cut = 32 * (div // 32)
        one_minus[:cut] = xla_math.fma(-i[:cut], r.expand(cut), 1.0)
    head = xla_math.fma(i, (e * r).expand(div), s * one_minus)
    return torch.cat([head, e.reshape(1)])


def init_rglru(key: torch.Tensor, cfg: ModelConfig):
    """The RG-LRU's weights from ``key`` as the JAX package draws them
    (``split(key, 6)``: wx, wy, conv_w, w_a, w_i, wo in that order; wx and
    wy times ``1 / sqrt(d)``, conv_w times float32 0.1, w_a, w_i and wo
    times ``1 / sqrt(lru_width)``, in float32 before the cast).  b_a, b_i
    (float32) and conv_b are zeros; ``lam`` (float32) is not drawn:
    ``log(expm1(-log(linspace(0.9, 0.999, w)) / 8))``, so that
    a = exp(-8 softplus(lam)) spans (0.9, 0.999) (within an ulp of JAX's:
    torch's and XLA's log and expm1 round differently).  ``key`` may be a
    stack of keys ``lead + (2,)``, as in ``init_mamba2``."""
    d, w = cfg.d_model, cfg.lru_width
    dt = cfg.torch_dtype
    device = key.device
    lead = tuple(key.shape[:-1])
    k = jr.split(key, 6)
    f32 = dict(dtype=torch.float32, device=device)
    s, sw = inv_sqrt(d, device), inv_sqrt(w, device)
    x = _xla_linspace(0.9, 0.999, w, device)
    lam = torch.log(torch.expm1(-torch.log(x) / _RG_C))
    return {
        "wx": _normal(k[..., 0, :], (d, w), s, dt),
        "wy": _normal(k[..., 1, :], (d, w), s, dt),
        "conv_w": _normal(k[..., 2, :], (cfg.conv_width, w),
                          torch.tensor(0.1, **f32), dt),
        "conv_b": torch.zeros(lead + (w,), dtype=dt, device=device),
        "w_a": _normal(k[..., 3, :], (w, w), sw, dt),
        "b_a": torch.zeros(lead + (w,), **f32),
        "w_i": _normal(k[..., 4, :], (w, w), sw, dt),
        "b_i": torch.zeros(lead + (w,), **f32),
        "lam": lam.expand(lead + (w,)).clone(),
        "wo": _normal(k[..., 5, :], (w, d), sw, dt),
    }


def _rglru_gates(p, u: torch.Tensor):
    """(a, gated), both float32 (B, S, w), spelled op for op as JAX's: the
    gates' products in float32 whatever the model's dtype."""
    u32 = u.to(torch.float32)
    r = torch.sigmoid(u32 @ p["w_a"].to(torch.float32) + p["b_a"])
    i = torch.sigmoid(u32 @ p["w_i"].to(torch.float32) + p["b_i"])
    log_a = (-_RG_C * _softplus(p["lam"])) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * u32)
    return a, gated


def _combine(a1, b1, a2, b2):
    """The linear recurrence's operator: (a1 a2, a2 b1 + b2)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (even has as many
    entries as odd, or one more)."""
    m = odd.shape[1]
    out = torch.stack([even[:, :m], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, m:]], dim=1) if even.shape[1] > m else out


def _linear_scan(a: torch.Tensor, b: torch.Tensor):
    """``lax.associative_scan(combine, (a, b), axis=1)`` spelled as JAX
    spells it: the odd/even recursion, whose ~2 log2(S) levels are each a
    few elementwise ops over the whole sequence (no loop over positions).
    Returns the scanned (a, b); b[:, t] = a[:, t] b[:, t-1] + b[:, t]."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = _linear_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_block(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Griffin recurrent block: conv1d, then the RG-LRU
    h_t = a_t h_{t-1} + gated_t (float32, from h_{-1} = 0), gated by
    gelu(x wy).  x: (B, S, d_model)."""
    u = causal_conv1d(x @ p["wx"], p["conv_w"], p["conv_b"])
    a, gated = _rglru_gates(p, u)
    _, h = _linear_scan(a, gated)
    y = h.to(x.dtype) * _gelu(x @ p["wy"])
    return y @ p["wo"]


def rglru_init_state(cfg: ModelConfig, batch: int, dtype, device,
                     lead: tuple = ()):
    return {
        "h": torch.zeros(lead + (batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, cfg.lru_width),
                            dtype=dtype, device=device),
    }


def rglru_decode(p, x_t: torch.Tensor, cfg: ModelConfig, state):
    """Single-token recurrent update.  x_t: (B, 1, d_model).  Returns
    (y (B, 1, d_model), state).  As in ``mamba2_decode``, ``state``'s
    tensors are updated in place (h <- a h + gated, the conv window
    shifted by one) and returned."""
    u, new_conv = causal_conv1d_step(x_t @ p["wx"], state["conv"],
                                     p["conv_w"], p["conv_b"])
    conv = state["conv"].copy_(new_conv)
    a, gated = _rglru_gates(p, u)
    h = state["h"].mul_(a[:, 0]).add_(gated[:, 0])
    y = h[:, None, :].to(x_t.dtype) * _gelu(x_t @ p["wy"])
    return y @ p["wo"], {"h": h, "conv": conv}
