"""Model zoo of the port: the paper's task models (softmax regression, the
Shakespeare LSTM ``rnn``, ResNet-18 with GroupNorm ``resnet``) and the
assigned architectures: the dense, moe, ssm (Mamba-2), hybrid (RG-LRU
and local attention) and vlm decoder families (``transformer``, ``ssm``)
and the audio encoder-decoder (``encdec``).

``get_model_api(cfg)`` returns a uniform API namespace for a ModelConfig,
as ``repro.models.get_model_api`` does, with ``prefill(params, batch)``,
the last position's logits, beside it.
"""
from __future__ import annotations

import types

from . import encdec, losses, resnet, rnn, softmax_reg, ssm, transformer
from .layers import ModelConfig


def get_model_api(cfg: ModelConfig):
    if cfg.family == "audio":
        mod, prefill = encdec, encdec.prefill_logits
    else:
        transformer.check_supported(cfg)
        mod, prefill = transformer, transformer.prefill
    return types.SimpleNamespace(
        init_params=lambda key, device=None: mod.init_params(cfg, key, device),
        forward=lambda params, batch: mod.forward(cfg, params, batch),
        loss_fn=lambda params, batch: mod.loss_fn(cfg, params, batch),
        prefill=lambda params, batch: prefill(cfg, params, batch),
        init_decode_state=lambda batch, max_len, device=None:
            mod.init_decode_state(cfg, batch, max_len, device),
        decode_step=lambda params, state, tok: mod.decode_step(cfg, params,
                                                               state, tok),
        module=mod,
    )


__all__ = ["ModelConfig", "get_model_api", "encdec", "losses", "resnet",
           "rnn", "softmax_reg", "ssm", "transformer"]
