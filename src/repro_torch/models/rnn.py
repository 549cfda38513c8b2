"""The paper's Shakespeare model (Table 6): char embedding (dim 8) -> 2
LSTMs (hidden 256) -> dense softmax over the 90-char vocabulary (port of
``repro.models.rnn``).

The parameter tree is JAX's: ``embed``, ``out_w``, ``out_b`` and ``lstm``,
a list of layers ``{wx (in, 4H), wh (H, 4H), b (4H,)}`` with the gates in
the order f, i, o, g and the forget bias 1 at ``b[:H]``.  ``init_params``
draws every leaf down JAX's key tree with the port's ``random.normal``, so
the same key gives JAX's parameters bit for bit.  The time loop is written
out (not ``nn.LSTM``/cuDNN, whose gate order and biases differ and which
``torch.func.vmap`` cannot batch).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import random as jr
from ..device import resolve_device
from .layers import _normal, inv_sqrt, sqrt_f32

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LstmConfig:
    vocab: int = 90
    embed_dim: int = 8
    hidden: int = 256
    n_layers: int = 2
    seq_len: int = 80


def _init_lstm_layer(key, in_dim: int, hidden: int) -> dict:
    k1, k2 = jr.split(key)
    s = inv_sqrt(in_dim + hidden, key.device)     # 1.0 / jnp.sqrt(in + H)
    b = torch.zeros(4 * hidden, dtype=_F32, device=key.device)
    b[:hidden] = 1.0                               # forget-gate bias 1
    return {"wx": _normal(k1, (in_dim, 4 * hidden), s, _F32),
            "wh": _normal(k2, (hidden, 4 * hidden), s, _F32),
            "b": b}


def init_params(cfg: LstmConfig, key: torch.Tensor, device=None) -> dict:
    """The parameters JAX's ``rnn.init_params`` draws from ``key``
    (``split(key, n_layers + 2)``: embed, out_w, then one key a layer)."""
    device = resolve_device(device)
    keys = jr.split(key.to(device), cfg.n_layers + 2)
    tenth = torch.tensor(0.1, dtype=_F32, device=device)
    params = {
        "embed": _normal(keys[0], (cfg.vocab, cfg.embed_dim), tenth, _F32),
        "out_w": _normal(keys[1], (cfg.hidden, cfg.vocab),
                         sqrt_f32(cfg.hidden, device), _F32, divide=True),
        "out_b": torch.zeros(cfg.vocab, dtype=_F32, device=device)}
    in_dim, layers = cfg.embed_dim, []
    for i in range(cfg.n_layers):
        layers.append(_init_lstm_layer(keys[2 + i], in_dim, cfg.hidden))
        in_dim = cfg.hidden
    params["lstm"] = layers
    return params


def _lstm_layer(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, H).  The input projection of every step is
    one matmul before the loop; each step adds ``h @ wh`` and ``b`` in
    JAX's order, ``(x_t wx + h wh) + b``.  The steps are taken apart with
    ``unbind`` and the gates with ``split`` (whose backward passes are one
    ``stack`` and one ``cat``: indexing would zero-fill a full-size
    gradient at every step)."""
    B = x.shape[0]
    H = p["wh"].shape[0]
    h = torch.zeros(B, H, dtype=x.dtype, device=x.device)
    c = torch.zeros(B, H, dtype=x.dtype, device=x.device)
    hs = []
    for xw_t in (x @ p["wx"]).unbind(dim=1):
        gates = xw_t + h @ p["wh"] + p["b"]
        sig, g = gates.split([3 * H, H], dim=-1)
        f, i, o = torch.sigmoid(sig).chunk(3, dim=-1)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def forward(cfg: LstmConfig, params: dict, tokens: torch.Tensor):
    x = params["embed"][tokens.long()]
    for p in params["lstm"]:
        x = _lstm_layer(p, x)
    return x @ params["out_w"] + params["out_b"]


def loss_fn(cfg: LstmConfig, params: dict, batch: dict):
    """Mean next-character cross-entropy."""
    tokens = batch["tokens"]
    logits = forward(cfg, params, tokens)[:, :-1, :]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tokens[:, 1:].long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def accuracy(cfg: LstmConfig, params: dict, batch: dict):
    tokens = batch["tokens"]
    logits = forward(cfg, params, tokens)[:, :-1, :]
    return torch.mean((torch.argmax(logits, -1) == tokens[:, 1:].long())
                      .to(_F32))
