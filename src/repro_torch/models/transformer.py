"""Decoder-only model assembly, dense and ssm families (port of
``repro.models.transformer``).  One nested dict of parameters with the
blocks stacked along a leading layer axis; a Python loop over that axis
takes the place of ``lax.scan``.  Full-sequence forward and prefill, and
the decode path: a KV cache (dense) or an O(1) recurrent state (ssm).

    init_params(cfg, key, device=None)            -> params
    forward(cfg, params, batch)                   -> (logits, aux)
    init_decode_state(cfg, batch, max_len, device=None) -> state
    decode_step(cfg, params, state, tok_t)        -> (logits, state)
    prefill(cfg, params, batch)                   -> last-position logits

The other families (moe, hybrid, vlm, audio) raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .. import random as jr
from ..device import resolve_device
from ..registry import lookup
from . import ssm as ssm_lib
from .layers import (ModelConfig, _normal, attention_block, attention_decode,
                     init_attention, init_mlp, init_rms, inv_sqrt, mlp_block,
                     rms_norm)

# the JAX package's other families: ROADMAP.md queue 1 item 12
DEFERRED_FAMILIES = ("moe", "hybrid", "vlm", "audio")
_MLPS = ("swiglu", "geglu", "gelu")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet:
    any family but dense and ssm, and MoE blocks."""
    lookup("family", cfg.family, ("dense", "ssm"), DEFERRED_FAMILIES, 12)
    lookup("mlp", cfg.mlp, _MLPS, ("moe",), 12)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _dense_block(p, x, cfg: ModelConfig, positions, window: int):
    h = x + attention_block(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                            cfg, positions, window=window)
    return h + mlp_block(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg)


def _dense_block_decode(p, x, cfg: ModelConfig, cache, index, window: int):
    a, cache = attention_decode(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                cfg, cache, index, window=window)
    h = x + a
    return h + mlp_block(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps),
                         cfg), cache


def _ssm_block(p, x, cfg: ModelConfig):
    return x + ssm_lib.mamba2_block(p["mixer"],
                                    rms_norm(x, p["ln"], cfg.norm_eps), cfg)


def _ssm_block_decode(p, x, cfg: ModelConfig, state):
    y, state = ssm_lib.mamba2_decode(p["mixer"],
                                     rms_norm(x, p["ln"], cfg.norm_eps), cfg,
                                     state)
    return x + y, state


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked along axis 0 (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, key: torch.Tensor, device=None
                ) -> Dict[str, Any]:
    """Random parameters, bit for bit the JAX package's ``init_params``
    from the same key: the same tree, shapes and dtypes, and the same
    ``jax.random.normal`` draws down the same key tree (``split(key, 8)``:
    embed, unembed, then ``split(keys[2], n_layers)``, one key per stacked
    layer; each dense block splits its key in two, attention then MLP),
    scaled in float32 before the cast; norms at zero.  On ``device``
    (default CUDA); the key is moved there."""
    check_supported(cfg)
    device = resolve_device(device)
    keys = jr.split(key.to(device), 8)
    dt = cfg.torch_dtype
    emb_scale = inv_sqrt(cfg.d_model, device)
    params: Dict[str, Any] = {
        "embed": _normal(keys[0], (cfg.vocab, cfg.d_model), emb_scale, dt),
        "ln_f": init_rms(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _normal(keys[1], (cfg.d_model, cfg.vocab),
                                    emb_scale, dt)
    lead = (cfg.n_layers,)
    layer_keys = jr.split(keys[2], cfg.n_layers)          # the vmapped axis
    if cfg.family == "ssm":
        params["blocks"] = {
            "ln": init_rms(cfg.d_model, dt, device, lead),
            "mixer": ssm_lib.init_mamba2(layer_keys, cfg),
        }
        return params
    block_keys = jr.split(layer_keys, 2)
    params["blocks"] = {
        "ln1": init_rms(cfg.d_model, dt, device, lead),
        "ln2": init_rms(cfg.d_model, dt, device, lead),
        "attn": init_attention(block_keys[:, 0], cfg),
        "mlp": init_mlp(block_keys[:, 1], cfg),
    }
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _window(cfg: ModelConfig) -> int:
    if cfg.long_context_window:
        return cfg.long_context_window
    return cfg.sliding_window


def _embed_inputs(cfg: ModelConfig, params, batch):
    """Returns (x (B, S, d), text_mask (B, S)); text only."""
    tokens = batch["tokens"]
    x = params["embed"][tokens].to(cfg.torch_dtype)
    return x, torch.ones(tokens.shape, dtype=torch.bool, device=x.device)


def backbone(cfg: ModelConfig, params, x):
    """Run the stacked blocks over embeddings x: (B, S, d)."""
    B, S, _ = x.shape
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_block(_layer(params["blocks"], i), x, cfg)
    else:
        positions = torch.arange(S, device=x.device).expand(B, S)
        w = _window(cfg)
        for i in range(cfg.n_layers):
            x = _dense_block(_layer(params["blocks"], i), x, cfg, positions,
                             w)
    return x, {"lb_loss": torch.zeros((), dtype=torch.float32,
                                      device=x.device)}


def unembed(cfg: ModelConfig, params, x):
    xn = rms_norm(x, params["ln_f"], cfg.norm_eps)
    proj = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return xn @ proj


def forward(cfg: ModelConfig, params, batch):
    x, tmask = _embed_inputs(cfg, params, batch)
    x, aux = backbone(cfg, params, x)
    logits = unembed(cfg, params, x)
    aux["text_mask"] = tmask
    return logits, aux


def prefill(cfg: ModelConfig, params, batch):
    """Full-sequence prefill: the last position's logits (B, 1, V).

    Only the last position is unembedded.  The JAX package computes every
    position's logits and slices; the rows are the same function, and at
    S = 8192 with llama3.2-1b's 128,256-token vocabulary the full bf16
    logits would take 2.1 GB (mamba2-2.7b's at S = 32,768: 3.3 GB)."""
    x, _ = _embed_inputs(cfg, params, batch)
    x, _ = backbone(cfg, params, x)
    return unembed(cfg, params, x[:, -1:, :])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _kv_cache_init(cfg: ModelConfig, batch: int, max_len: int, window: int,
                   device, lead: tuple = ()):
    M = min(max_len, window) if window > 0 else max_len
    shape = lead + (batch, M, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None):
    """{"index": int32 scalar, "caches": stacked over layers}: the KV
    caches {"k", "v"} (dense), or the recurrent state {"ssm", "conv"}
    (ssm; O(1) in the sequence length, so ``max_len`` is not read)."""
    check_supported(cfg)
    device = resolve_device(device)
    lead = (cfg.n_layers,)
    if cfg.family == "ssm":
        caches = ssm_lib.mamba2_init_state(cfg, batch, cfg.torch_dtype,
                                           device, lead)
    else:
        caches = _kv_cache_init(cfg, batch, max_len, _window(cfg), device,
                                lead)
    return {"index": torch.zeros((), dtype=torch.int32, device=device),
            "caches": caches}


def decode_step(cfg: ModelConfig, params, state, tok_t):
    """One decode step.  tok_t: (B, 1) int.  Returns (logits (B, 1, V),
    state).  The caches of ``state`` are updated in place (see
    ``layers.attention_decode`` and ``ssm.mamba2_decode``); the returned
    state holds the same cache tensors and a new index."""
    x = params["embed"][tok_t].to(cfg.torch_dtype)
    idx = state["index"]
    caches = state["caches"]
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x, _ = _ssm_block_decode(_layer(params["blocks"], i), x, cfg,
                                     _layer(caches, i))
    else:
        w = _window(cfg)
        for i in range(cfg.n_layers):
            x, _ = _dense_block_decode(_layer(params["blocks"], i), x, cfg,
                                       _layer(caches, i), idx, w)
    return unembed(cfg, params, x), {"index": idx + 1, "caches": caches}
