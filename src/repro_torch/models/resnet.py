"""The paper's CIFAR100 model: ResNet-18 with GroupNorm in place of
BatchNorm (port of ``repro.models.resnet``).  NHWC activations, HWIO
convolution weights, as in the JAX package.

The parameter tree is JAX's (``stem``, ``gn_stem``, ``blocks`` — a list
of ``{conv1, gn1, conv2, gn2[, proj, gn_proj]}`` — ``fc_w``, ``fc_b``),
drawn down JAX's key tree with the port's ``random.normal``, so the same
key gives JAX's parameters bit for bit.  The weights stay in JAX's HWIO
layout; each convolution views them as OIHW and the activations as NCHW
(a ``channels_last`` tensor), so no copy is made.

XLA's ``padding="SAME"`` pads ``total // 2`` before and the rest after: a
3×3 stride-2 convolution of an even input pads (0, 1), not the (1, 1) of
``F.conv2d(padding=1)``; ``_conv`` spells the pad out.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import random as jr
from .. import xla_math
from ..device import resolve_device
from .layers import _normal, sqrt_f32

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    n_classes: int = 100
    width: int = 64                  # first-stage channels (paper: 64)
    stages: Sequence[int] = (2, 2, 2, 2)   # ResNet-18
    groups: int = 8                  # GroupNorm groups (divides width)


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """NHWC x, HWIO w -> NHWC, XLA's SAME padding."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pads(x.shape[1], kh, stride)
    left, right = _same_pads(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    if (top, left) == (bottom, right):
        y = F.conv2d(xc, wc, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), wc,
                     stride=stride)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of NHWC ``x`` over (H, W, C // g) with the population
    variance; ``g`` steps down from ``groups`` until it divides C."""
    B, H, W, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xg = x.reshape(B, H, W, g, C // g).to(_F32)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    centered = xg - mean
    var = (centered * centered).mean(dim=(1, 2, 4), keepdim=True)
    xn = (centered * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return (xn * scale + bias).to(x.dtype)


def block_strides(cfg: ResNetConfig) -> tuple:
    """The static stride of each block: 2 at the first block of every
    stage after the first."""
    return tuple(2 if (bi == 0 and si > 0) else 1
                 for si, n in enumerate(cfg.stages) for bi in range(n))


def _init_conv(key, kh: int, kw: int, cin: int, cout: int):
    # jnp.sqrt(2.0 / fan_in): the float64 quotient rounded to float32, then
    # a float32 root
    scale = xla_math.sqrt(torch.tensor(2.0 / (kh * kw * cin), dtype=_F32,
                                       device=key.device))
    return _normal(key, (kh, kw, cin, cout), scale, _F32)


def _init_gn(c: int, device) -> dict:
    return {"scale": torch.ones(c, dtype=_F32, device=device),
            "bias": torch.zeros(c, dtype=_F32, device=device)}


def _init_block(key, cin: int, cout: int, stride: int) -> dict:
    k1, k2, k3 = jr.split(key, 3)
    dev = key.device
    p = {"conv1": _init_conv(k1, 3, 3, cin, cout), "gn1": _init_gn(cout, dev),
         "conv2": _init_conv(k2, 3, 3, cout, cout), "gn2": _init_gn(cout, dev)}
    if stride != 1 or cin != cout:
        p["proj"] = _init_conv(k3, 1, 1, cin, cout)
        p["gn_proj"] = _init_gn(cout, dev)
    return p


def init_params(cfg: ResNetConfig, key: torch.Tensor, device=None):
    """(params, strides) as JAX's ``resnet.init_params`` draws them from
    ``key`` (``split(key, 2 + sum(stages))``: stem, one key a block, fc)."""
    device = resolve_device(device)
    keys = jr.split(key.to(device), 2 + sum(cfg.stages))
    w = cfg.width
    strides = block_strides(cfg)
    params = {"stem": _init_conv(keys[0], 3, 3, 3, w),
              "gn_stem": _init_gn(w, device), "blocks": []}
    cin, ki = w, 1
    for si, n in enumerate(cfg.stages):
        cout = w * (2 ** si)
        for _ in range(n):
            params["blocks"].append(
                _init_block(keys[ki], cin, cout, strides[ki - 1]))
            cin = cout
            ki += 1
    params["fc_w"] = _normal(keys[ki], (cin, cfg.n_classes),
                             sqrt_f32(cin, device), _F32, divide=True)
    params["fc_b"] = torch.zeros(cfg.n_classes, dtype=_F32, device=device)
    return params, strides


def _block(p: dict, x: torch.Tensor, stride: int, groups: int):
    y = _conv(x, p["conv1"], stride)
    y = F.relu(group_norm(y, p["gn1"]["scale"], p["gn1"]["bias"], groups))
    y = _conv(y, p["conv2"], 1)
    y = group_norm(y, p["gn2"]["scale"], p["gn2"]["bias"], groups)
    if "proj" in p:
        x = group_norm(_conv(x, p["proj"], stride),
                       p["gn_proj"]["scale"], p["gn_proj"]["bias"], groups)
    return F.relu(x + y)


def forward(cfg: ResNetConfig, params: dict, strides, images: torch.Tensor):
    """(B, H, W, 3) images -> (B, n_classes) logits."""
    x = _conv(images, params["stem"], 1)
    x = F.relu(group_norm(x, params["gn_stem"]["scale"],
                          params["gn_stem"]["bias"], cfg.groups))
    for p, s in zip(params["blocks"], strides):
        x = _block(p, x, s, cfg.groups)
    x = x.mean(dim=(1, 2))
    return x @ params["fc_w"] + params["fc_b"]


def make_loss_fn(cfg: ResNetConfig, strides):
    def loss_fn(params, batch):
        logits = forward(cfg, params, strides, batch["x"])
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch["y"].long()[..., None])[..., 0]
        return torch.mean(logz - gold)
    return loss_fn


def accuracy(cfg: ResNetConfig, params: dict, strides, batch: dict):
    logits = forward(cfg, params, strides, batch["x"])
    return torch.mean((torch.argmax(logits, -1) == batch["y"].long())
                      .to(_F32))
