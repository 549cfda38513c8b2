"""Shared transformer layers (port of ``repro.models.layers``): the
model config, RMS norm, rotary embeddings, GQA attention (causal /
sliding-window, optional qk-norm and logit soft-cap) for the full sequence
and for one decode step against a KV cache, the gated MLPs and the top-k
routed Mixture-of-Experts block.

Layers are plain functions over nested dicts of tensors.  ``remat`` is
applied per layer by ``transformer.backbone``.

**Tensor parallelism** (the serving programs of ``launch.steps`` over a
(data, model) mesh).  Where JAX pins activations with
``hooks.constrain`` and XLA partitions, each rank here runs its own
blocks of the weights with explicit collectives, Megatron-style.  The
layers read their head counts and widths from the leaves they are given,
not from ``cfg``: leaves narrower than ``cfg`` are the rank's blocks, and
``sharding.hooks.axis_for`` names the model axis they are split over.
The attention then runs on the rank's H/m query heads (the
flash_attention kernel on local tensors) and the MLP on its d_ff/m
columns; the row-parallel products after ``wo`` and ``w2`` are partial
sums, each rank's in float32, all-reduced over the model axis and
rounded once (:func:`row_parallel`).  A rank that holds H/m query heads
but every kv head (their count does not divide the axis) reads the kv
heads its queries share (:func:`_rank_kv`).  Whole leaves, on one card,
take none of these steps.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import torch

from .. import random as jr
from .. import xla_math
from ..sharding import hooks
from ..kernels.flash_attention import flash_attention
# The model's attention is the plain version of the flash_attention kernel
# and lives beside it; it is the same function as the JAX layers' sdpa.
from ..kernels.ref import ATTN_NEG, sdpa, sqrt_hd

__all__ = ["ModelConfig", "rms_norm", "init_rms", "rotary", "init_attention",
           "sdpa", "attention_block", "attention_decode", "sum_partials",
           "row_parallel",
           "init_mlp", "mlp_block", "init_moe", "top_k", "moe_routing",
           "moe_block"]

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
    angles bit for bit.  They are computed on the CPU and copied to x's
    device: the card's ``powf`` rounds up to 2 ulps apart, and at
    position 32,760 one ulp of a frequency moves an angle by ~2e-3."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32) / hd
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    freqs = freqs.to(x.device, non_blocking=True)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


_DRAW_CHUNK = 1 << 24
_SHAPES_ONLY = [False]


@contextlib.contextmanager
def shapes_only():
    """Inside it, :func:`_normal` draws nothing and returns an empty tensor
    on the meta device: ``init_params`` then gives the tree's shapes and
    dtypes at no cost (``launch.specs.param_specs``)."""
    _SHAPES_ONLY[0] = True
    try:
        yield
    finally:
        _SHAPES_ONLY[0] = False


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
    if _SHAPES_ONLY[0]:
        return torch.empty(lead + tuple(shape), dtype=dtype, device="meta")
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
    """q (B, S, h, hd), k and v (B, S, kv, hd), with h and kv the heads
    the given leaves hold (the rank's, under a model split)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, -1, hd)
    k = (x @ p["wk"]).reshape(B, S, -1, hd)
    v = (x @ p["wv"]).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
    return q, k, v


def sum_partials(y: torch.Tensor, logical: str) -> torch.Tensor:
    """The partial sums ``y`` all-reduced over the mesh axis ``logical``
    maps to, in float32 (the result's dtype).  ``sum_partials.calls`` and
    ``.bytes`` count the all-reduces and the bytes each rank hands
    them."""
    ax = hooks.axis_for(logical)
    if ax is None:
        raise RuntimeError(f"split {logical!r} leaves with no mesh axis "
                           f"mapped to {logical!r} (sharding.hooks)")
    sum_partials.calls += 1
    sum_partials.bytes += y.numel() * 4
    return ax.all_reduce(y.to(torch.float32))


sum_partials.calls = 0
sum_partials.bytes = 0


def row_parallel(x: torch.Tensor, w: torch.Tensor, logical: str):
    """``x @ w`` where ``w`` holds the rank's rows of a row-parallel
    weight (and x its columns of the input): each rank's partial product
    in float32, unrounded (a bfloat16 GEMM with a float32 output on the
    card), summed over the mesh axis and rounded to x's dtype once, as a
    single card's GEMM rounds its float32 accumulator once.  (Rounding
    each partial to bfloat16 first put qwen3-14b's 40-layer logits 2.4e-2
    of their scale off one card's.)"""
    if x.dtype == torch.float32:
        y = x @ w
    elif x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w,
                     out_dtype=torch.float32).reshape(
            x.shape[:-1] + (w.shape[-1],))
    else:
        y = x.to(torch.float32) @ w.to(torch.float32)
    return sum_partials(y, logical).to(x.dtype)


def _rank_kv(k, v, n_q: int, cfg: ModelConfig):
    """The kv heads the rank's ``n_q`` query heads read, where it holds
    H/m of them but every kv head: its queries r·n_q, ..., (r+1)·n_q - 1
    read kv heads q // (H/KV)."""
    if n_q == cfg.n_heads or k.shape[2] < cfg.n_kv_heads:
        return k, v
    r = hooks.axis_for("heads").rank
    g = cfg.n_heads // cfg.n_kv_heads
    lo, hi = r * n_q // g, ((r + 1) * n_q - 1) // g + 1
    return k[:, :, lo:hi], v[:, :, lo:hi]


def attention_block(p, x, cfg: ModelConfig, positions, *, window: int):
    """Full-sequence causal attention (prefill / training): the
    flash_attention kernel on a CUDA tensor, the plain ``sdpa`` on a CPU
    tensor (the wrapper dispatches by device).  Its gradient is the
    flash_attention_bwd kernel (``ref.sdpa_bwd`` on the CPU).  On the
    rank's heads, its ``wo`` partials summed over the model axis."""
    q, k, v = _qkv(p, x, cfg, positions)
    n_q = q.shape[2]
    k, v = _rank_kv(k, v, n_q, cfg)
    out = flash_attention(q, k, v, causal=True, window=window,
                          softcap=cfg.attn_softcap)
    B, S = x.shape[:2]
    out = out.reshape(B, S, -1)
    if n_q < cfg.n_heads:
        return row_parallel(out, p["wo"], "heads")
    return out @ p["wo"]


def attention_decode(p, x, cfg: ModelConfig, cache, index, *, window: int):
    """Single-token decode against a KV cache.

    cache: dict(k=(B, M, KV, hd), v=(B, M, KV, hd)); M = allocated cache
    length (the full sequence, or a ring buffer of ``window`` slots when a
    window is set and the cache was allocated at exactly that size).
    ``index`` is the absolute position of the new token (int32 scalar
    tensor, kept on the device).  Under a model split the cache is the
    rank's block: its kv heads (KV/m of them, or all of them where KV
    does not divide the axis).

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
    n_q = q.shape[2]
    out = _decode_sdpa(q, *_rank_kv(ck, cv, n_q, cfg), valid, cfg)
    out = out.reshape(B, 1, -1)
    y = (row_parallel(out, p["wo"], "heads") if n_q < cfg.n_heads
         else out @ p["wo"])
    return y, {"k": ck, "v": cv}


def _decode_sdpa(q, k, v, valid, cfg: ModelConfig):
    """Attention of one query row over the cache (plain torch: the JAX
    package computes decode attention outside any kernel too), with the
    head counts of q and the cache it is given (the rank's)."""
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
    """The MLP; with the rank's d_ff/m columns of ``w1`` and ``w3``
    (column-parallel) and rows of ``w2`` (row-parallel), its partials
    summed over the model axis."""
    if cfg.mlp == "gelu":
        h = _gelu(x @ p["w1"])
    else:
        act = _gelu if cfg.mlp == "geglu" else _silu
        h = act(x @ p["w1"]) * (x @ p["w3"])
    if p["w1"].shape[-1] < cfg.d_ff:
        return row_parallel(h, p["w2"], "tensor")
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# Mixture-of-Experts (top-k, capacity-based dispatch/combine)
# ---------------------------------------------------------------------------


def init_moe(key: torch.Tensor, cfg: ModelConfig):
    """MoE weights from ``key`` as the JAX package draws them
    (``split(key, 4)``: the router, float32 whatever the model's dtype;
    w1 and w3 (E, d, f) scaled by 1/sqrt(d); w2 (E, f, d) by 1/sqrt(f));
    ``key`` may be a stack of keys, as in :func:`init_attention`."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    k = jr.split(key, 4)
    s_in, s_out = inv_sqrt(d, key.device), inv_sqrt(f, key.device)
    dt = cfg.torch_dtype
    return {"router": _normal(k[..., 0, :], (d, E), s_in, torch.float32),
            "w1": _normal(k[..., 1, :], (E, d, f), s_in, dt),
            "w3": _normal(k[..., 2, :], (E, d, f), s_in, dt),
            "w2": _normal(k[..., 3, :], (E, f, d), s_out, dt)}


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: (values, int64 indices), the
    larger value first and, among equal values, the lower index first
    (``torch.topk`` orders ties otherwise).  k passes of ``argmax``, which
    returns the first maximal index; the values must be above -inf (the
    router's probabilities are)."""
    cols = torch.arange(x.shape[-1], device=x.device)
    taken = torch.zeros_like(x, dtype=torch.bool)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(torch.where(taken, float("-inf"), x), dim=-1,
                         keepdim=True)
        vals.append(torch.gather(x, -1, i))
        idxs.append(i)
        taken = taken | (cols == i)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


class Routing(NamedTuple):
    """What :func:`moe_routing` decides for x (B, S, d), over the groups
    (B, nG, G) of the padded sequence."""
    xg: torch.Tensor        # (B, nG, G, d) the padded tokens
    probs: torch.Tensor     # (B, nG, G, E) float32 router softmax
    gates: torch.Tensor     # (B, nG, G, k) float32, renormalised
    idx: torch.Tensor       # (B, nG, G, k) the chosen experts
    onehot: torch.Tensor    # (B, nG, G, k, E) int32
    keep: torch.Tensor      # (B, nG, G, k, E) within the expert's capacity
    slot: torch.Tensor      # (B, nG, G, E) buffer slot, -1 if none
    cap: int                # each expert's slots per group


def moe_routing(p, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The routing of :func:`moe_block`, step by step as the JAX package's:
    the sequence padded with zero rows to a multiple of the group length
    G = min(moe_group_size, S); float32 router logits and softmax; the
    top-k, renormalised by max(sum, 1e-9); capacity
    max(int(cf * G * k / E), 1) a group; each (token, choice)'s place in
    its expert's buffer by a cumsum over the group's G * k pairs in
    token-then-choice order, kept if below capacity."""
    B, S, d = x.shape
    E, k_top = cfg.n_experts, cfg.moe_top_k
    G = min(cfg.moe_group_size or 4096, S)
    pad = (-S) % G
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    nG = (S + pad) // G
    xg = x.reshape(B, nG, G, d)
    probs = torch.softmax(xg.to(torch.float32) @ p["router"], dim=-1)
    gates, idx = top_k(probs, k_top)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    cap = max(int(cfg.capacity_factor * G * k_top / E), 1)
    onehot = (idx[..., None] == torch.arange(E, device=x.device)).to(
        torch.int32)
    flat = onehot.reshape(B, nG, G * k_top, E)
    pos = (torch.cumsum(flat, dim=2) * flat - 1).reshape(onehot.shape)
    keep = (pos >= 0) & (pos < cap)
    slot = torch.where(keep, pos, -1).amax(dim=3)
    return Routing(xg, probs, gates, idx, onehot, keep, slot, cap)


def moe_block(p, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routed MoE with grouped capacity dispatch and combine
    einsums (``repro.models.layers.moe_block``): returns (y, {"lb_loss"}),
    the Switch-style load-balancing loss over the padded groups.  The
    expert products are plain large products (the JAX package runs them
    outside any kernel too), one spelling on the CPU and the card."""
    S = x.shape[1]
    r = moe_routing(p, x, cfg)
    xg = r.xg
    B, nG, G, d = xg.shape
    # one-hot of the slot, with -1 giving a zero row
    dispatch = (r.slot[..., None] == torch.arange(r.cap, device=x.device)
                ).to(xg.dtype)                          # (B, nG, G, E, C)
    # each expert's gate: at most one choice of a token is that expert
    gates_e = (r.onehot.to(torch.float32) * r.gates[..., None]).sum(3)
    combine = dispatch * gates_e.to(xg.dtype)[..., None]
    xe = torch.einsum("bgtd,bgtec->begcd", xg, dispatch)
    h = _silu(torch.einsum("begcd,edf->begcf", xe, p["w1"])) \
        * torch.einsum("begcd,edf->begcf", xe, p["w3"])
    ye = torch.einsum("begcf,efd->begcd", h, p["w2"])
    y = torch.einsum("begcd,bgtec->bgtd", ye, combine).reshape(B, nG * G, d)
    frac_tokens = r.onehot[..., 0, :].to(torch.float32).mean(dim=(0, 1, 2))
    frac_probs = r.probs.mean(dim=(0, 1, 2))
    lb = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    return y[:, :S].to(x.dtype), {"lb_loss": lb}
