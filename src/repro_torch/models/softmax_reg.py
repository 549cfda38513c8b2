"""Paper's Synthetic(alpha, alpha) model: multinomial logistic (softmax)
regression — w in R^{d x c}, b in R^c (port of
``repro.models.softmax_reg``; parameters are a dict of tensors)."""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class SoftmaxRegConfig:
    dim: int = 60
    n_classes: int = 10
    l2: float = 1e-4


def init_params(cfg: SoftmaxRegConfig, key, device=None) -> dict:
    """Zeros, as the JAX package's ``init_params`` (the key is unused)."""
    device = resolve_device(device)
    return {"w": torch.zeros((cfg.dim, cfg.n_classes), dtype=torch.float32,
                             device=device),
            "b": torch.zeros((cfg.n_classes,), dtype=torch.float32,
                             device=device)}


def forward(cfg: SoftmaxRegConfig, params: dict, x: torch.Tensor):
    return x @ params["w"] + params["b"]


def loss_fn(cfg: SoftmaxRegConfig, params: dict, batch: dict):
    x, y = batch["x"], batch["y"]
    logits = forward(cfg, params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    reg = 0.5 * cfg.l2 * (torch.sum(params["w"] ** 2)
                          + torch.sum(params["b"] ** 2))
    return torch.mean(logz - gold) + reg


def accuracy(cfg: SoftmaxRegConfig, params: dict, batch: dict):
    logits = forward(cfg, params, batch["x"])
    return torch.mean((torch.argmax(logits, -1) == batch["y"].long())
                      .to(torch.float32))
