"""Shapes and dtypes of every program input, without allocation (port of
``repro.launch.specs``): the train, prefill and decode programs of every
assigned architecture.

``jax.ShapeDtypeStruct`` becomes :class:`ShapeDtype`, a (shape, dtype)
named tuple.  ``param_specs`` walks ``init_params`` with the parameter
draws replaced by empty meta tensors (``models.layers.shapes_only``), so
the full configs are counted in about a second each; the norms and
constant leaves, which are small, are made on the CPU.
``decode_state_specs`` builds ``init_decode_state`` under
``FakeTensorMode``: llama3.2-1b's KV cache alone at ``decode_32k`` would
take ~137 GB.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .. import random as jr
from ..configs.common import INPUT_SHAPES, ArchSpec
from ..models import get_model_api
from ..models.layers import shapes_only
from ..tree import tree_leaves, tree_map

__all__ = ["ShapeDtype", "cohort_batch_specs", "prefill_batch_specs",
           "decode_tok_specs", "decode_state_specs", "param_specs",
           "count_params", "is_shape"]


class ShapeDtype(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def _shape(shape_name: str, kind: str) -> dict:
    shp = INPUT_SHAPES.get(shape_name)
    if shp is None or shp["kind"] != kind:
        names = sorted(n for n, s in INPUT_SHAPES.items()
                       if s["kind"] == kind)
        raise ValueError(f"{shape_name!r} is not a {kind} shape; the {kind} "
                         f"shapes: {names}")
    return shp


def _batch(cfg, lead: tuple, seq_len: int) -> Dict:
    """{"tokens": lead + (S,) int32}; a vlm's S counts its image prefix:
    S - n_patches text tokens and "patch_embeds" lead + (n_patches,
    vit_dim); the audio family's "frames" are lead + (enc_seq, d_model);
    both in the model's dtype."""
    if cfg.family == "vlm":
        return {"tokens": ShapeDtype(lead + (seq_len - cfg.n_patches,),
                                     torch.int32),
                "patch_embeds": ShapeDtype(lead + (cfg.n_patches,
                                                   cfg.vit_dim),
                                           cfg.torch_dtype)}
    batch = {"tokens": ShapeDtype(lead + (seq_len,), torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = ShapeDtype(lead + (cfg.enc_seq, cfg.d_model),
                                     cfg.torch_dtype)
    return batch


def cohort_batch_specs(arch: ArchSpec, shape_name: str) -> Dict:
    """Training cohort batch: {"tokens": (K, E, B_loc, S) int32}, and a
    vlm's patch embeddings (K, E, B_loc, n_patches, vit_dim) or the audio
    family's frames (K, E, B_loc, enc_seq, d_model)."""
    shp = _shape(shape_name, "train")
    K, E = arch.fed.cohort_size, arch.fed.local_steps
    B = arch.fed.local_batch_for(shp["global_batch"])
    return _batch(arch.model_for_shape(shape_name), (K, E, B),
                  shp["seq_len"])


def prefill_batch_specs(arch: ArchSpec, shape_name: str) -> Dict:
    """Prefill batch: {"tokens": (B, S) int32}, and a vlm's patch
    embeddings (B, n_patches, vit_dim) or the audio family's frames
    (B, enc_seq, d_model)."""
    shp = _shape(shape_name, "prefill")
    return _batch(arch.model_for_shape(shape_name), (shp["global_batch"],),
                  shp["seq_len"])


def _decode_cfg(arch: ArchSpec, shape_name: str):
    _shape(shape_name, "decode")
    cfg = arch.model_for_shape(shape_name)
    if cfg is None:
        raise ValueError(f"{arch.arch_id} skips {shape_name!r} "
                         f"(long_context={arch.long_context!r}); its shapes: "
                         f"{arch.supported_shapes()}")
    return cfg


def decode_tok_specs(arch: ArchSpec, shape_name: str) -> ShapeDtype:
    """The decode step's token: (B, 1) int32."""
    _decode_cfg(arch, shape_name)
    return ShapeDtype((INPUT_SHAPES[shape_name]["global_batch"], 1),
                      torch.int32)


def decode_state_specs(arch: ArchSpec, shape_name: str) -> Dict:
    """``init_decode_state(B, S)``'s tree with a :class:`ShapeDtype` at
    each leaf, built under ``FakeTensorMode``: nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shp = INPUT_SHAPES[shape_name]
    api = get_model_api(_decode_cfg(arch, shape_name))
    with FakeTensorMode():
        state = api.init_decode_state(shp["global_batch"], shp["seq_len"],
                                      "cpu")
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), state)


def _shape_tree(cfg):
    with shapes_only():
        return get_model_api(cfg).init_params(jr.PRNGKey(0, device="cpu"),
                                              "cpu")


def param_specs(cfg) -> Dict:
    """``init_params``'s tree with a :class:`ShapeDtype` at each leaf."""
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype),
                    _shape_tree(cfg))


def count_params(cfg) -> int:
    return int(sum(t.numel() for t in tree_leaves(_shape_tree(cfg))))


def is_shape(x) -> bool:
    """Whether ``x`` is a :class:`ShapeDtype` (a leaf of a shapes tree)."""
    return isinstance(x, ShapeDtype)
