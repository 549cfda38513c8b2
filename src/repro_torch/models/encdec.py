"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``;
arXiv:2212.04356).

As in the JAX package, the audio frontend (mel-spectrogram and two conv
layers) is a stub: the batch carries precomputed frame embeddings
``frames: (B, enc_seq, d_model)``.  Everything downstream is implemented:
sinusoidal encoder positions, the bidirectional encoder, the causal
decoder with cross-attention, learned decoder positions and the tied
unembedding.  The blocks are stacked along a leading layer axis and run
in a Python loop, as in ``transformer``.

The full-sequence attention (the encoder's, non-causal; the decoder's
self-attention, causal; its cross-attention, non-causal with Sq = S and
Skv = enc_seq) goes through ``kernels.flash_attention``: the kernel on a
CUDA tensor, the plain ``sdpa`` on a CPU tensor.  Decode stays on the
plain path: per-layer self-attention KV caches, written in place, and the
cross-attention K/V computed once from the encoder output by
:func:`prefill`.

    init_params(cfg, key, device=None)             -> params
    encode(cfg, params, frames)                    -> encoder output
    forward(cfg, params, batch)                    -> (logits, aux)
    loss_fn(cfg, params, batch)                    -> next-token CE
    prefill_logits(cfg, params, batch)             -> last-position logits
    init_decode_state(cfg, batch, max_len, device=None) -> state
    prefill(cfg, params, batch, state)             -> state with cross K/V
    decode_step(cfg, params, state, tok_t)         -> (logits, state)

``batch`` is {"frames", "tokens"}.  ``prefill`` is the JAX package's
(it fills the decode state); ``get_model_api``'s ``prefill`` is
:func:`prefill_logits`, the last position of :func:`forward`, as the JAX
package's ``build_prefill_step`` takes it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .. import random as jr
from .. import xla_math
from ..device import resolve_device
from ..kernels.flash_attention import flash_attention
from ..kernels.ref import sdpa
from .layers import (ModelConfig, _normal, init_attention, init_mlp,
                     init_rms, inv_sqrt, mlp_block, rms_norm)
# the masked attention of one decode row over a cache (JAX's
# ``_masked_decode_attn``; whisper has no soft-cap)
from .layers import _decode_sdpa as _masked_decode_attn
from .losses import fused_unembed_xent

DEC_POS = 4096          # learned decoder positions


def _sinusoid(seq: int, d: int, device) -> torch.Tensor:
    """(seq, d) float32 [sin | cos] of pos / 10000^(2i / d), within an ulp
    of the JAX package's compiled ``_sinusoid``: the angles bitwise (``2i
    / d`` as XLA rewrites a division by a constant, 2i * f32(1 / d), and
    glibc's ``powf``, ``xla_math.pow``; at pos ~1,500 one ulp of an angle
    moves its sine by 1e-4), the sine and cosine in float64 rounded once
    (glibc's ``sinf`` and ``cosf`` are within an ulp of that)."""
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.arange(seq, **f32)[:, None]
    expo = (2.0 * torch.arange(d // 2, **f32)) * xla_math.recip(d)
    ang = (pos / xla_math.pow(torch.full_like(expo, 10000.0), expo)).to(
        torch.float64)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(
        torch.float32)


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked along axis 0 (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _n_enc(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _proj_qkv(p, xq, xkv, cfg: ModelConfig):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (xq @ p["wq"]).reshape(B, Sq, h, hd)
    k = (xkv @ p["wk"]).reshape(B, Skv, kv, hd)
    v = (xkv @ p["wv"]).reshape(B, Skv, kv, hd)
    return q, k, v


def _attn(p, xq, xkv, cfg: ModelConfig, causal: bool):
    """Attention of the queries of ``xq`` over ``xkv``, the full sequence
    through ``flash_attention``."""
    q, k, v = _proj_qkv(p, xq, xkv, cfg)
    out = flash_attention(q, k, v, causal=causal)
    B, Sq = xq.shape[:2]
    return out.reshape(B, Sq, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------


def _init_enc_block(keys: torch.Tensor, cfg: ModelConfig):
    """Encoder blocks stacked along ``keys``' lead axes: each splits its
    key in two, attention then the MLP."""
    lead, device = tuple(keys.shape[:-1]), keys.device
    k = jr.split(keys, 2)
    dt = cfg.torch_dtype
    return {"ln1": init_rms(cfg.d_model, dt, device, lead),
            "ln2": init_rms(cfg.d_model, dt, device, lead),
            "attn": init_attention(k[..., 0, :], cfg),
            "mlp": init_mlp(k[..., 1, :], cfg)}


def _init_dec_block(keys: torch.Tensor, cfg: ModelConfig):
    """Decoder blocks stacked along ``keys``' lead axes: each splits its
    key in three, self-attention, cross-attention, then the MLP."""
    lead, device = tuple(keys.shape[:-1]), keys.device
    k = jr.split(keys, 3)
    dt = cfg.torch_dtype
    return {"ln1": init_rms(cfg.d_model, dt, device, lead),
            "ln2": init_rms(cfg.d_model, dt, device, lead),
            "ln3": init_rms(cfg.d_model, dt, device, lead),
            "self_attn": init_attention(k[..., 0, :], cfg),
            "cross_attn": init_attention(k[..., 1, :], cfg),
            "mlp": init_mlp(k[..., 2, :], cfg)}


def init_params(cfg: ModelConfig, key: torch.Tensor, device=None
                ) -> Dict[str, Any]:
    """Random parameters, bit for bit the JAX package's ``init_params``
    from the same key: ``split(key, 5)``: the embedding (scaled by
    1/sqrt(d)), the decoder positions (DEC_POS, d) times 0.01, then
    ``split(keys[2], n_enc)`` and ``split(keys[3], n_layers)``, one key a
    stacked encoder and decoder block; norms at zero.  On ``device``
    (default CUDA); the key is moved there."""
    device = resolve_device(device)
    keys = jr.split(key.to(device), 5)
    dt = cfg.torch_dtype
    return {
        "embed": _normal(keys[0], (cfg.vocab, cfg.d_model),
                         inv_sqrt(cfg.d_model, device), dt),
        "dec_pos": _normal(keys[1], (DEC_POS, cfg.d_model),
                           torch.tensor(0.01, dtype=torch.float32,
                                        device=device), dt),
        "enc_blocks": _init_enc_block(jr.split(keys[2], _n_enc(cfg)), cfg),
        "dec_blocks": _init_dec_block(jr.split(keys[3], cfg.n_layers), cfg),
        "ln_enc": init_rms(cfg.d_model, dt, device),
        "ln_f": init_rms(cfg.d_model, dt, device),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def encode(cfg: ModelConfig, params, frames):
    """frames (B, enc_seq, d) + sinusoidal positions through the
    bidirectional encoder; the normed output (B, enc_seq, d)."""
    dt = cfg.torch_dtype
    x = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model,
                                  frames.device).to(dt)[None]
    for i in range(_n_enc(cfg)):
        blk = _layer(params["enc_blocks"], i)
        hn = rms_norm(x, blk["ln1"], cfg.norm_eps)
        x = x + _attn(blk["attn"], hn, hn, cfg, causal=False)
        x = x + mlp_block(blk["mlp"], rms_norm(x, blk["ln2"], cfg.norm_eps),
                          cfg)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _decoder(cfg: ModelConfig, params, tokens, enc_out):
    """The causal decoder over ``tokens`` (B, S) with cross-attention to
    ``enc_out``; the normed hidden states (B, S, d).  The learned
    positions are added only when S <= DEC_POS (as in the JAX package)."""
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.torch_dtype)
    if S <= params["dec_pos"].shape[0]:
        x = x + params["dec_pos"][None, :S, :]
    for i in range(cfg.n_layers):
        blk = _layer(params["dec_blocks"], i)
        hn = rms_norm(x, blk["ln1"], cfg.norm_eps)
        x = x + _attn(blk["self_attn"], hn, hn, cfg, causal=True)
        x = x + _attn(blk["cross_attn"], rms_norm(x, blk["ln2"], cfg.norm_eps),
                      enc_out, cfg, causal=False)
        x = x + mlp_block(blk["mlp"], rms_norm(x, blk["ln3"], cfg.norm_eps),
                          cfg)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def forward(cfg: ModelConfig, params, batch):
    """(logits (B, S, V), {"lb_loss": 0}); the unembedding is the
    embedding's transpose (tied, as whisper's)."""
    enc_out = encode(cfg, params, batch["frames"])
    x = _decoder(cfg, params, batch["tokens"], enc_out)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x @ params["embed"].T, {"lb_loss": zero}


def prefill_logits(cfg: ModelConfig, params, batch):
    """The last position's logits (B, 1, V) of :func:`forward`: only that
    row is unembedded (the rows are the same function)."""
    enc_out = encode(cfg, params, batch["frames"])
    x = _decoder(cfg, params, batch["tokens"], enc_out)
    return x[:, -1:, :] @ params["embed"].T


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token CE over every decoder position, the unembedding fused
    into the chunked CE (``losses.fused_unembed_xent``)."""
    enc_out = encode(cfg, params, batch["frames"])
    x = _decoder(cfg, params, batch["tokens"], enc_out)
    tgt = batch["tokens"][:, 1:]
    mask = torch.ones(tgt.shape, dtype=torch.bool, device=tgt.device)
    return fused_unembed_xent(x[:, :-1, :], params["embed"].T, tgt, mask)


# ---------------------------------------------------------------------------
# Decode (self KV caches + cross K/V computed once)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None):
    """{"index": int32 scalar, "self_k", "self_v": (L, B, max_len, KV, hd),
    "cross_k", "cross_v": (L, B, enc_seq, KV, hd)}, zeros; :func:`prefill`
    fills the cross K/V."""
    device = resolve_device(device)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype

    def zeros(seq):
        return torch.zeros((L, batch, seq, kv, hd), dtype=dt, device=device)
    return {"index": torch.zeros((), dtype=torch.int32, device=device),
            "self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(cfg.enc_seq), "cross_v": zeros(cfg.enc_seq)}


def prefill(cfg: ModelConfig, params, batch, state):
    """Encode ``batch["frames"]`` once and write each decoder layer's
    cross-attention K/V into ``state`` (in place); returns the state."""
    enc_out = encode(cfg, params, batch["frames"])
    for i in range(cfg.n_layers):
        p = _layer(params["dec_blocks"], i)["cross_attn"]
        _, k, v = _proj_qkv(p, enc_out[:, :1], enc_out, cfg)
        state["cross_k"][i].copy_(k)
        state["cross_v"][i].copy_(v)
    return dict(state)


def decode_step(cfg: ModelConfig, params, state, tok_t):
    """One decode step.  tok_t: (B, 1) int.  Returns (logits (B, 1, V),
    state).  The new token's self-attention K/V row is written into the
    caches of ``state`` in place, at the step's index; the position
    embedding is row min(index, DEC_POS - 1).  Attention over the caches
    is the plain masked softmax, the cross-attention the plain ``sdpa``:
    no kernel runs."""
    B = tok_t.shape[0]
    idx = state["index"]
    x = params["embed"][tok_t].to(cfg.torch_dtype)
    dec_pos = params["dec_pos"]
    row = torch.clamp_max(idx, dec_pos.shape[0] - 1).reshape(1).to(
        torch.int64)
    x = x + dec_pos.index_select(0, row)[None]
    M = state["self_k"].shape[2]
    slot = idx.reshape(1).to(torch.int64)
    valid = torch.arange(M, device=x.device) <= idx
    for i in range(cfg.n_layers):
        blk = _layer(params["dec_blocks"], i)
        hn = rms_norm(x, blk["ln1"], cfg.norm_eps)
        q, k_new, v_new = _proj_qkv(blk["self_attn"], hn, hn, cfg)
        sk = state["self_k"][i].index_copy_(1, slot, k_new)
        sv = state["self_v"][i].index_copy_(1, slot, v_new)
        out = _masked_decode_attn(q, sk, sv, valid, cfg)
        x = x + out.reshape(B, 1, -1) @ blk["self_attn"]["wo"]
        p = blk["cross_attn"]
        hx = rms_norm(x, blk["ln2"], cfg.norm_eps)
        qx = (hx @ p["wq"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
        outx = sdpa(qx, state["cross_k"][i], state["cross_v"][i],
                    causal=False)
        x = x + outx.reshape(B, 1, -1) @ p["wo"]
        x = x + mlp_block(blk["mlp"], rms_norm(x, blk["ln3"], cfg.norm_eps),
                          cfg)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["embed"].T, dict(state, index=idx + 1)
