"""State-space blocks, Mamba-2 part (port of ``repro.models.ssm``): the
depthwise causal conv1d with its streaming state, and the Mamba-2 SSD
mixer (arXiv:2405.21060) for the full sequence (prefill) and for one token
against an O(1) state (decode).

The full-sequence mixer calls ``kernels.ssd_chunk.ssd``, whose intra-chunk
step is the ``ssd_chunk`` kernel on a CUDA tensor and its plain version on
a CPU tensor (there is no ``use_kernel`` knob).  The RG-LRU block of the
hybrid family is ROADMAP.md queue 1 item 12.
"""
from __future__ import annotations

import torch

from .. import random as jr
from ..kernels.ssd_chunk import ssd
from .layers import (ModelConfig, _normal, _silu, _softplus, inv_sqrt,
                     rms_norm, sqrt_f32)

__all__ = ["causal_conv1d", "causal_conv1d_step", "mamba2_dims",
           "init_mamba2", "mamba2_block", "mamba2_init_state",
           "mamba2_decode"]


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
