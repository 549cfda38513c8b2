"""Shared transformer layers, dense part (port of ``repro.models.layers``):
the model config, RMS norm, rotary embeddings, GQA attention (causal /
sliding-window, optional qk-norm and logit soft-cap) for the full sequence
and for one decode step against a KV cache, and the gated MLPs.

Layers are plain functions over nested dicts of tensors.  The sharding
annotations of the JAX package (``hooks.constrain``) are identity on one
card and are left out (ROADMAP.md queue 1 item 11); so is ``remat``, which
only training uses.  MoE blocks are ROADMAP.md queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import random as jr
from .. import xla_math
from ..kernels.flash_attention import flash_attention
# The model's attention is the plain version of the flash_attention kernel
# and lives beside it; it is the same function as the JAX layers' sdpa.
from ..kernels.ref import ATTN_NEG, sdpa, sqrt_hd

__all__ = ["ModelConfig", "rms_norm", "init_rms", "rotary", "init_attention",
           "sdpa", "attention_block", "attention_decode", "init_mlp",
           "mlp_block"]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Every field of ``repro.models.layers.ModelConfig``, with the same
    defaults, so that the two compare equal field by field."""
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab: int = 1024
    mlp: str = "swiglu"            # swiglu | geglu | gelu (non-gated) | moe
    use_rope: bool = True          # False: absolute position embeddings (whisper)
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    moe_group_size: int = 4096     # routing-group length (bounds dispatch mem)
    qk_norm: bool = False
    sliding_window: int = 0        # 0 = full causal attention
    attn_softcap: float = 0.0      # e.g. grok-1 uses 30.0
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "float32"         # param/activation dtype
    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4
    # --- hybrid (recurrentgemma) ---
    lru_width: int = 0
    hybrid_pattern: tuple = ()     # e.g. ("rec", "rec", "attn")
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0               # encoder frame count (stub frontend output)
    # --- vlm (llava) ---
    vit_dim: int = 0               # stub vision-embedding dim (0 = not a VLM)
    n_patches: int = 0             # image tokens per example
    # --- long-context variant flag (documented SWA override for dense archs)
    long_context_window: int = 0
    # --- per-layer activation rematerialization (training memory policy)
    remat: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 RMS norm with the ``1 + scale`` gain, result in x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def init_rms(d: int, dtype: torch.dtype, device, lead: tuple = ()):
    return torch.zeros(lead + (d,), dtype=dtype, device=device)  # 1 + scale


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    frequencies are computed in the JAX package's order,
    ``1 / theta ** (arange(0, hd, 2) / hd)`` in float32, which gives its
    angles bit for bit."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


_DRAW_CHUNK = 1 << 24


def inv_sqrt(n: int, device) -> torch.Tensor:
    """``1.0 / jnp.sqrt(n)`` as JAX forms it: a float32 root, then a
    float32 reciprocal (not a Python double)."""
    return 1.0 / sqrt_f32(n, device)


def sqrt_f32(n: int, device) -> torch.Tensor:
    """``jnp.sqrt(n)`` of a Python int: the correctly rounded float32
    root."""
    return xla_math.sqrt(torch.tensor(float(n), dtype=torch.float32,
                                      device=device))


def _normal(keys: torch.Tensor, shape, scale: torch.Tensor, dtype, *,
            divide: bool = False) -> torch.Tensor:
    """``(jax.random.normal(k, shape) * scale).astype(dtype)`` (``/ scale``
    with ``divide``) for every key ``k`` of ``keys`` (shape ``lead + (2,)``),
    stacked along ``lead``, bit for bit.  ``scale`` is a float32 tensor.
    Each draw is made in chunks of at most 2^24 lanes, the same bits, so a
    large leaf needs no multi-GB temporaries."""
    lead = tuple(keys.shape[:-1])
    out = torch.empty(lead + tuple(shape), dtype=dtype, device=keys.device)
    n = math.prod(shape)
    rows = out.view(-1, n)
    for i, key in enumerate(keys.reshape(-1, 2)):
        for start in range(0, n, _DRAW_CHUNK):
            m = min(_DRAW_CHUNK, n - start)
            x = jr.normal(key, m, start=start)
            rows[i, start:start + m] = (x / scale if divide
                                        else x * scale).to(dtype)
    return out


def init_attention(key: torch.Tensor, cfg: ModelConfig):
    """Attention weights from ``key`` as the JAX package draws them
    (``split(key, 4)``: wq, wk, wv, wo).  ``key`` may be a stack of keys
    ``lead + (2,)`` (one per layer), which gives each leaf the ``lead``
    axes in front."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = tuple(key.shape[:-1])
    k = jr.split(key, 4)
    s = inv_sqrt(d, key.device)
    dt = cfg.torch_dtype
    p = {"wq": _normal(k[..., 0, :], (d, h * hd), s, dt),
         "wk": _normal(k[..., 1, :], (d, kv * hd), s, dt),
         "wv": _normal(k[..., 2, :], (d, kv * hd), s, dt),
         "wo": _normal(k[..., 3, :], (h * hd, d), s, dt)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(lead + (hd,), dtype=dt, device=key.device)
        p["k_norm"] = torch.zeros(lead + (hd,), dtype=dt, device=key.device)
    return p


def _qkv(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (x @ p["wk"]).reshape(B, S, kv, hd)
    v = (x @ p["wv"]).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p, x, cfg: ModelConfig, positions, *, window: int):
    """Full-sequence causal attention (prefill / training): the
    flash_attention kernel on a CUDA tensor, the plain ``sdpa`` on a CPU
    tensor (the wrapper dispatches by device)."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = flash_attention(q, k, v, causal=True, window=window,
                          softcap=cfg.attn_softcap)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"]


def attention_decode(p, x, cfg: ModelConfig, cache, index, *, window: int):
    """Single-token decode against a KV cache.

    cache: dict(k=(B, M, KV, hd), v=(B, M, KV, hd)); M = allocated cache
    length (the full sequence, or a ring buffer of ``window`` slots when a
    window is set and the cache was allocated at exactly that size).
    ``index`` is the absolute position of the new token (int32 scalar
    tensor, kept on the device).

    Unlike the JAX package, the new K/V row is written INTO ``cache`` in
    place (``index_copy_``), and the same tensors are returned: no copy of
    the cache is made per step.
    """
    B = x.shape[0]
    M = cache["k"].shape[1]
    ring = window > 0 and M == window
    pos = index.reshape(1) if index.dim() == 0 else index
    q, k_new, v_new = _qkv(p, x, cfg, pos.expand(B, 1))
    slot = torch.remainder(index, M) if ring else index
    slot = slot.reshape(1).to(torch.int64)
    ck = cache["k"].index_copy_(1, slot, k_new)
    cv = cache["v"].index_copy_(1, slot, v_new)
    ar = torch.arange(M, device=x.device)
    if ring:
        # the M slots hold the last M tokens once index >= M; slot order
        # does not matter to the softmax, only validity and the window
        kpos = index - torch.remainder(index - ar, M)    # absolute position
        valid = (kpos >= 0) & (kpos > index - window) & (kpos <= index)
    else:
        kpos = ar
        valid = kpos <= index
        if window > 0:
            valid &= kpos > index - window
    out = _decode_sdpa(q, ck, cv, valid, cfg)
    y = out.reshape(B, 1, -1) @ p["wo"]
    return y, {"k": ck, "v": cv}


def _decode_sdpa(q, k, v, valid, cfg: ModelConfig):
    """Attention of one query row over the cache (plain torch: the JAX
    package computes decode attention outside any kernel too)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, 1, KV, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) / sqrt_hd(hd)
    if cfg.attn_softcap > 0:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    logits = torch.where(valid, logits, torch.full_like(logits, ATTN_NEG))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Gated MLPs
# ---------------------------------------------------------------------------


def init_mlp(key: torch.Tensor, cfg: ModelConfig):
    """MLP weights from ``key`` as the JAX package draws them
    (``split(key, 3)``: w1 takes the first, w3 the second, w2 the third);
    ``key`` may be a stack of keys, as in :func:`init_attention`."""
    d, f = cfg.d_model, cfg.d_ff
    k = jr.split(key, 3)
    s_in, s_out = inv_sqrt(d, key.device), inv_sqrt(f, key.device)
    dt = cfg.torch_dtype
    p = {"w1": _normal(k[..., 0, :], (d, f), s_in, dt),
         "w2": _normal(k[..., 2, :], (f, d), s_out, dt)}
    if cfg.mlp != "gelu":  # gated variants need the second in-projection
        p["w3"] = _normal(k[..., 1, :], (d, f), s_in, dt)
    return p


# The activations are spelled op for op as jax.nn spells them, with the
# constants cast to x's dtype as JAX casts weak scalars: in bfloat16 every
# op then rounds where JAX's does (F.silu and F.gelu round once, which
# differs from JAX in ~40% of bf16 lanes).


def _silu(x):
    """``jax.nn.silu``: x * (1 / (1 + exp(-x)))."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, spelled as JAX spells it,
    max(x, 0) + log1p(exp(-|x|)).  (``F.softplus`` returns x above a
    threshold of 20 and rounds elsewhere with another formula.)"""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _gelu(x):
    """``jax.nn.gelu`` (approximate=True, its default)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def mlp_block(p, x, cfg: ModelConfig):
    if cfg.mlp == "gelu":
        return _gelu(x @ p["w1"]) @ p["w2"]
    act = _gelu if cfg.mlp == "geglu" else _silu
    return (act(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
