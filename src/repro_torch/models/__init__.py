"""Model zoo of the port: the paper's task models (softmax regression, the
Shakespeare LSTM ``rnn``, ResNet-18 with GroupNorm ``resnet``) and, of the
assigned architectures, the dense, moe, ssm (Mamba-2), hybrid (RG-LRU and
local attention) and vlm decoder families (``transformer``, ``ssm``).

``get_model_api(cfg)`` returns a uniform API namespace for a ModelConfig,
as ``repro.models.get_model_api`` does; families this port does not run
yet raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import types

from . import losses, resnet, rnn, softmax_reg, ssm, transformer
from .layers import ModelConfig


def get_model_api(cfg: ModelConfig):
    T = transformer
    T.check_supported(cfg)
    return types.SimpleNamespace(
        init_params=lambda key, device=None: T.init_params(cfg, key, device),
        forward=lambda params, batch: T.forward(cfg, params, batch),
        loss_fn=lambda params, batch: T.loss_fn(cfg, params, batch),
        prefill=lambda params, batch: T.prefill(cfg, params, batch),
        init_decode_state=lambda batch, max_len, device=None:
            T.init_decode_state(cfg, batch, max_len, device),
        decode_step=lambda params, state, tok: T.decode_step(cfg, params,
                                                             state, tok),
        module=T,
    )


__all__ = ["ModelConfig", "get_model_api", "losses", "resnet", "rnn",
           "softmax_reg", "ssm", "transformer"]
