"""Decoder-only model assembly, dense, moe, ssm, hybrid and vlm families
(port of ``repro.models.transformer``).  One nested dict of parameters
with the blocks stacked along a leading layer axis; a Python loop over
that axis takes the place of ``lax.scan``.  Full-sequence forward and
prefill, and the decode path: a KV cache (dense, moe, vlm), an O(1)
recurrent state (ssm), or both (hybrid).  A block with ``mlp="moe"``
routes its tokens to experts (``layers.moe_block``) and adds its
load-balancing loss to ``aux``.  The hybrid family (recurrentgemma) runs
groups of ``cfg.hybrid_pattern`` blocks, RG-LRU recurrent blocks and
local-attention blocks, then a tail of recurrent blocks; the vlm family
(llava) prepends projected patch embeddings to the text and decodes text
only.

    init_params(cfg, key, device=None)            -> params
    forward(cfg, params, batch)                   -> (logits, aux)
    loss_fn(cfg, params, batch)                   -> next-token CE
    init_decode_state(cfg, batch, max_len, device=None) -> state
    decode_step(cfg, params, state, tok_t)        -> (logits, state)
    prefill(cfg, params, batch)                   -> last-position logits

The audio family (whisper's encoder-decoder) is ``encdec``'s.

Under the serving programs of ``launch.steps`` over a (data, model) mesh
the dense family runs on each rank's blocks (``layers``' tensor
parallelism): the embedding is looked up vocab-parallel
(:func:`embed_tokens`), each block's attention and MLP end in an
all-reduce over the model axis, :func:`unembed` gives the rank's vocab
slice of the logits, and :func:`init_decode_state` the rank's cache
block, (B/d, M, KV/m, hd) a layer.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .. import random as jr
from ..device import resolve_device
from ..registry import lookup
from ..remat import checkpoint
from ..sharding import hooks
from ..tree import tree_leaves, tree_map
from . import ssm as ssm_lib
from .layers import (ModelConfig, _gelu, _normal, attention_block,
                     attention_decode, init_attention, init_mlp, init_moe,
                     init_rms, inv_sqrt, mlp_block, moe_block, rms_norm,
                     sqrt_f32, sum_partials)
from .losses import fused_unembed_xent

# families of the JAX package not ported yet: none (audio is encdec's)
DEFERRED_FAMILIES = ()
_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
_MLPS = ("swiglu", "geglu", "gelu", "moe")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``KeyError`` for a family or an MLP this module does not
    build (the audio family is ``encdec``'s)."""
    lookup("family", cfg.family, _FAMILIES, DEFERRED_FAMILIES)
    lookup("mlp", cfg.mlp, _MLPS)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _ffn(p, z, cfg: ModelConfig):
    """The block's feed-forward: (y, the MoE load-balancing loss or None)."""
    if cfg.mlp == "moe":
        y, aux = moe_block(p["moe"], z, cfg)
        return y, aux["lb_loss"]
    return mlp_block(p["mlp"], z, cfg), None


def _dense_block(p, x, cfg: ModelConfig, positions, window: int):
    """(h, lb): lb is the MoE block's load-balancing loss, None without
    one (the JAX package's constant 0).  On the rank's blocks of a dense
    block the attention's and the MLP's partials are each all-reduced
    over the model axis (``layers.row_parallel``) before their residual
    add."""
    h = x + attention_block(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                            cfg, positions, window=window)
    y, lb = _ffn(p, rms_norm(h, p["ln2"], cfg.norm_eps), cfg)
    return h + y, lb


def _dense_block_decode(p, x, cfg: ModelConfig, cache, index, window: int):
    a, cache = attention_decode(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                cfg, cache, index, window=window)
    h = x + a
    y, _ = _ffn(p, rms_norm(h, p["ln2"], cfg.norm_eps), cfg)
    return h + y, cache


def _ssm_block(p, x, cfg: ModelConfig):
    return x + ssm_lib.mamba2_block(p["mixer"],
                                    rms_norm(x, p["ln"], cfg.norm_eps), cfg)


def _ssm_block_decode(p, x, cfg: ModelConfig, state):
    y, state = ssm_lib.mamba2_decode(p["mixer"],
                                     rms_norm(x, p["ln"], cfg.norm_eps), cfg,
                                     state)
    return x + y, state


def _rec_block(p, x, cfg: ModelConfig):
    h = x + ssm_lib.rglru_block(p["rglru"],
                                rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
    return h + mlp_block(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg)


def _rec_block_decode(p, x, cfg: ModelConfig, state):
    y, state = ssm_lib.rglru_decode(p["rglru"],
                                    rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                                    state)
    h = x + y
    return (h + mlp_block(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps),
                          cfg), state)


def _hybrid_layout(cfg: ModelConfig):
    """(pattern, number of groups, tail length): the tail's blocks are
    recurrent."""
    pat = cfg.hybrid_pattern or ("rec", "rec", "attn")
    n_groups = cfg.n_layers // len(pat)
    return pat, n_groups, cfg.n_layers - n_groups * len(pat)


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked along axis 0 (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------


def _init_dense_block(keys: torch.Tensor, cfg: ModelConfig):
    """Dense or moe blocks stacked along ``keys``' lead axes (one key a
    block): each splits its key in two, attention then the MLP or the MoE
    weights."""
    lead, device = tuple(keys.shape[:-1]), keys.device
    k = jr.split(keys, 2)
    dt = cfg.torch_dtype
    p = {"ln1": init_rms(cfg.d_model, dt, device, lead),
         "ln2": init_rms(cfg.d_model, dt, device, lead),
         "attn": init_attention(k[..., 0, :], cfg)}
    if cfg.mlp == "moe":
        p["moe"] = init_moe(k[..., 1, :], cfg)
    else:
        p["mlp"] = init_mlp(k[..., 1, :], cfg)
    return p


def _init_rec_block(keys: torch.Tensor, cfg: ModelConfig):
    """Recurrent blocks stacked along ``keys``' lead axes: each splits its
    key in two, the RG-LRU then the MLP."""
    lead, device = tuple(keys.shape[:-1]), keys.device
    k = jr.split(keys, 2)
    dt = cfg.torch_dtype
    return {"ln1": init_rms(cfg.d_model, dt, device, lead),
            "ln2": init_rms(cfg.d_model, dt, device, lead),
            "rglru": ssm_lib.init_rglru(k[..., 0, :], cfg),
            "mlp": init_mlp(k[..., 1, :], cfg)}


def init_params(cfg: ModelConfig, key: torch.Tensor, device=None
                ) -> Dict[str, Any]:
    """Random parameters, bit for bit the JAX package's ``init_params``
    from the same key: the same tree, shapes and dtypes, and the same
    ``jax.random.normal`` draws down the same key tree (``split(key, 8)``:
    embed, unembed, then ``split(keys[2], n_layers)``, one key per stacked
    layer; each dense or moe block splits its key in two, attention then
    the MLP or the MoE weights).  The hybrid family splits ``keys[2]`` into
    one key a group and each group's key into one a block of its pattern
    (``"0_rec"``, ``"1_rec"``, ``"2_attn"``; a recurrent block splits its
    key in two, the RG-LRU then the MLP), and its tail of recurrent blocks
    takes ``split(keys[3], tail)``; the vlm family's projector takes
    ``split(keys[4], 2)``.  Draws are
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
    if cfg.family == "hybrid":
        pat, n_groups, rem = _hybrid_layout(cfg)
        # (n_groups, len(pat), 2): the vmapped groups' keys, split per block
        block_keys = jr.split(jr.split(keys[2], n_groups), len(pat))
        params["groups"] = {
            f"{i}_{t}": (_init_rec_block if t == "rec" else
                         _init_dense_block)(block_keys[:, i], cfg)
            for i, t in enumerate(pat)}
        if rem:
            params["tail"] = _init_rec_block(jr.split(keys[3], rem), cfg)
        return params
    layer_keys = jr.split(keys[2], cfg.n_layers)          # the vmapped axis
    if cfg.family == "ssm":
        params["blocks"] = {
            "ln": init_rms(cfg.d_model, dt, device, (cfg.n_layers,)),
            "mixer": ssm_lib.init_mamba2(layer_keys, cfg),
        }
        return params
    params["blocks"] = _init_dense_block(layer_keys, cfg)
    if cfg.family == "vlm":
        k = jr.split(keys[4], 2)
        params["projector"] = {
            "w1": _normal(k[0], (cfg.vit_dim, cfg.d_model),
                          inv_sqrt(cfg.vit_dim, device), dt),
            "w2": _normal(k[1], (cfg.d_model, cfg.d_model),
                          sqrt_f32(cfg.d_model, device), dt, divide=True),
        }
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _window(cfg: ModelConfig) -> int:
    if cfg.long_context_window:
        return cfg.long_context_window
    return cfg.sliding_window


def embed_tokens(cfg: ModelConfig, embed: torch.Tensor, tokens):
    """The embedding rows of ``tokens`` in the model's dtype.  ``embed``
    may be the rank's block of V/m vocab rows: each rank then looks up
    the tokens in its rows, zero elsewhere, and the rows are all-reduced
    over the model axis (in float32: exact, one term of each sum is
    nonzero)."""
    rows = embed.shape[0]
    if rows == cfg.vocab:
        return embed[tokens].to(cfg.torch_dtype)
    local = tokens - hooks.axis_for("vocab").rank * rows
    inside = (local >= 0) & (local < rows)
    x = embed[torch.where(inside, local, torch.zeros_like(local))]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return sum_partials(x, "vocab").to(cfg.torch_dtype)


def _embed_inputs(cfg: ModelConfig, params, batch):
    """Returns (x (B, S, d), text_mask (B, S)).  The vlm family prepends
    the projected patches, gelu(patch_embeds w1) w2, which the text mask
    leaves out."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params["embed"], tokens)
    tmask = torch.ones(tokens.shape, dtype=torch.bool, device=x.device)
    if cfg.family != "vlm":
        return x, tmask
    pe = batch["patch_embeds"].to(cfg.torch_dtype)       # (B, P, vit_dim)
    proj = _gelu(pe @ params["projector"]["w1"]) @ params["projector"]["w2"]
    pmask = torch.zeros(proj.shape[:2], dtype=torch.bool, device=x.device)
    return (torch.cat([proj, x], dim=1), torch.cat([pmask, tmask], dim=1))


def _rematted_block(block, p, x):
    """``block(p, x)`` with its activations recomputed in the backward
    (``jax.checkpoint`` of the JAX package's scanned layer body)."""
    def run(tensors, _):
        it = iter(tensors[1:])
        return block(tree_map(lambda _: next(it), p), tensors[0])
    return checkpoint(run, None, x, *tree_leaves(p))


def _positions(h):
    # made in the block, not closed over: a checkpointed block may take no
    # tensor from outside under torch.func's transforms
    B, S, _ = h.shape
    return torch.arange(S, device=h.device).expand(B, S)


def _hybrid_backbone(cfg: ModelConfig, params, x):
    """The groups of ``cfg.hybrid_pattern``, each one checkpoint with
    ``cfg.remat``, then the tail's recurrent blocks, not checkpointed (as
    the JAX package's scans).  Attention takes ``cfg.sliding_window``."""
    pat, n_groups, rem = _hybrid_layout(cfg)

    def group(p, h):
        for i, t in enumerate(pat):
            blk = p[f"{i}_{t}"]
            if t == "rec":
                h = _rec_block(blk, h, cfg)
            else:
                h, _ = _dense_block(blk, h, cfg, _positions(h),
                                    cfg.sliding_window)
        return h
    for g in range(n_groups):
        p = _layer(params["groups"], g)
        x = _rematted_block(group, p, x) if cfg.remat else group(p, x)
    for j in range(rem):
        x = _rec_block(_layer(params["tail"], j), x, cfg)
    return x


def backbone(cfg: ModelConfig, params, x):
    """Run the stacked blocks over embeddings x: (B, S, d); with
    ``cfg.remat`` each layer (a hybrid: each group) keeps only its input
    for the backward.  Returns (x, {"lb_loss"}): the MoE blocks'
    load-balancing losses summed over the layers, 0 without MoE blocks."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        return _hybrid_backbone(cfg, params, x), {"lb_loss": zero}
    moe = cfg.family != "ssm" and cfg.mlp == "moe"
    if cfg.family == "ssm":
        def block(p, h):
            return _ssm_block(p, h, cfg)
    else:
        w = _window(cfg)

        def block(p, h):
            h, lb = _dense_block(p, h, cfg, _positions(h), w)
            return (h, lb) if moe else h
    lbs = []
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        x = _rematted_block(block, p, x) if cfg.remat else block(p, x)
        if moe:
            x, lb = x
            lbs.append(lb)
    lb_loss = torch.stack(lbs).sum() if lbs else zero
    return x, {"lb_loss": lb_loss}


def unembed(cfg: ModelConfig, params, x):
    """The logits of x, tied (``embed.T``) or not; over the rank's vocab
    rows, the rank's vocab slice of them."""
    xn = rms_norm(x, params["ln_f"], cfg.norm_eps)
    proj = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return xn @ proj


def forward(cfg: ModelConfig, params, batch):
    x, tmask = _embed_inputs(cfg, params, batch)
    x, aux = backbone(cfg, params, x)
    logits = unembed(cfg, params, x)
    aux["text_mask"] = tmask
    return logits, aux


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token CE over text positions (+ 0.01 * the MoE load-balance
    loss, 0 without MoE blocks), with the unembedding fused
    into the chunked CE (``losses.fused_unembed_xent``): the (B, T, V)
    logits are never formed.  ``batch["loss_mask"]``, when present, masks
    targets as the JAX package's does; a vlm's image prefix is dropped
    before the CE."""
    x, tmask = _embed_inputs(cfg, params, batch)
    x, aux = backbone(cfg, params, x)
    xn = rms_norm(x, params["ln_f"], cfg.norm_eps)
    proj = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    tokens = batch["tokens"]
    n_prefix = x.shape[1] - tokens.shape[1]        # the vlm's image prefix
    mask = tmask[:, n_prefix:][:, 1:]
    if "loss_mask" in batch:
        mask = mask & batch["loss_mask"][:, 1:]
    ce = fused_unembed_xent(xn[:, n_prefix:-1, :], proj, tokens[:, 1:], mask)
    return ce + 0.01 * aux["lb_loss"]


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
    """Zero K and V caches (lead + (batch, M, kv, hd)): kv = KV/m where
    the kv heads are split over the model axis (``hooks.axis_for``)."""
    M = min(max_len, window) if window > 0 else max_len
    ax = hooks.axis_for("kv_heads", cfg.n_kv_heads)
    kv = cfg.n_kv_heads // ax.size if ax is not None else cfg.n_kv_heads
    shape = lead + (batch, M, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None):
    """{"index": int32 scalar, "caches": stacked over layers}: the KV
    caches {"k", "v"} (dense, moe, vlm), or the recurrent state {"ssm",
    "conv"} (ssm; O(1) in the sequence length, so ``max_len`` is not
    read).  The hybrid family's is {"index", "groups", "tail"}: per group
    of its pattern, the RG-LRU state {"h", "conv"} of each recurrent block
    and the KV cache of each attention block (a ring of
    ``cfg.sliding_window`` slots once ``max_len`` reaches it), stacked
    over the groups; the tail's recurrent states stacked over its
    blocks."""
    check_supported(cfg)
    device = resolve_device(device)
    index = torch.zeros((), dtype=torch.int32, device=device)
    dt = cfg.torch_dtype
    if cfg.family == "hybrid":
        pat, n_groups, rem = _hybrid_layout(cfg)
        lead = (n_groups,)
        state = {"index": index, "groups": {
            f"{i}_{t}": (ssm_lib.rglru_init_state(cfg, batch, dt, device,
                                                  lead) if t == "rec" else
                         _kv_cache_init(cfg, batch, max_len,
                                        cfg.sliding_window, device, lead))
            for i, t in enumerate(pat)}}
        if rem:
            state["tail"] = ssm_lib.rglru_init_state(cfg, batch, dt, device,
                                                     (rem,))
        return state
    lead = (cfg.n_layers,)
    if cfg.family == "ssm":
        caches = ssm_lib.mamba2_init_state(cfg, batch, dt, device, lead)
    else:
        caches = _kv_cache_init(cfg, batch, max_len, _window(cfg), device,
                                lead)
    return {"index": index, "caches": caches}


def _hybrid_decode(cfg: ModelConfig, params, state, x):
    pat, n_groups, rem = _hybrid_layout(cfg)
    idx = state["index"]
    for g in range(n_groups):
        grp, st = _layer(params["groups"], g), _layer(state["groups"], g)
        for i, t in enumerate(pat):
            key = f"{i}_{t}"
            if t == "rec":
                x, _ = _rec_block_decode(grp[key], x, cfg, st[key])
            else:
                x, _ = _dense_block_decode(grp[key], x, cfg, st[key], idx,
                                           cfg.sliding_window)
    for j in range(rem):
        x, _ = _rec_block_decode(_layer(params["tail"], j), x, cfg,
                                 _layer(state["tail"], j))
    return x


def decode_step(cfg: ModelConfig, params, state, tok_t):
    """One decode step.  tok_t: (B, 1) int.  Returns (logits (B, 1, V),
    state).  The caches and recurrent states of ``state`` are updated in
    place (see ``layers.attention_decode``, ``ssm.mamba2_decode`` and
    ``ssm.rglru_decode``); the returned state holds the same tensors and a
    new index.  A vlm decodes text only: its image prefix is in the cache
    where the prompt put it."""
    x = embed_tokens(cfg, params["embed"], tok_t)
    idx = state["index"]
    if cfg.family == "hybrid":
        x = _hybrid_decode(cfg, params, state, x)
        return unembed(cfg, params, x), dict(state, index=idx + 1)
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
