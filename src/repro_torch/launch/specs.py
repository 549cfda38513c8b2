"""Shapes and dtypes of every program input, without allocation (port of
``repro.launch.specs`` for the train and prefill programs of the dense,
moe, ssm, hybrid and vlm families).

``jax.ShapeDtypeStruct`` becomes :class:`ShapeDtype`, a (shape, dtype)
named tuple.  ``param_specs`` walks ``init_params`` with the parameter
draws replaced by empty meta tensors (``models.layers.shapes_only``), so
the full configs are counted in about a second each; the norms and
constant leaves, which are small, are made on the CPU.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .. import random as jr
from ..configs.common import INPUT_SHAPES, ArchSpec
from ..models import transformer
from ..models.layers import shapes_only
from ..tree import tree_leaves, tree_map

__all__ = ["ShapeDtype", "cohort_batch_specs", "prefill_batch_specs",
           "param_specs", "count_params"]


class ShapeDtype(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def _shape(shape_name: str, kind: str) -> dict:
    shp = INPUT_SHAPES.get(shape_name)
    if shp is None or shp["kind"] != kind:
        names = sorted(n for n, s in INPUT_SHAPES.items()
                       if s["kind"] == kind)
        raise ValueError(f"{shape_name!r} is not a {kind} shape; the ported "
                         f"{kind} shapes: {names}")
    return shp


def _batch(cfg, lead: tuple, seq_len: int) -> Dict:
    """{"tokens": lead + (S,) int32}; a vlm's S counts its image prefix:
    S - n_patches text tokens and "patch_embeds" lead + (n_patches,
    vit_dim) in the model's dtype."""
    if cfg.family != "vlm":
        return {"tokens": ShapeDtype(lead + (seq_len,), torch.int32)}
    return {"tokens": ShapeDtype(lead + (seq_len - cfg.n_patches,),
                                 torch.int32),
            "patch_embeds": ShapeDtype(lead + (cfg.n_patches, cfg.vit_dim),
                                       cfg.torch_dtype)}


def cohort_batch_specs(arch: ArchSpec, shape_name: str) -> Dict:
    """Training cohort batch: {"tokens": (K, E, B_loc, S) int32}, and a
    vlm's patch embeddings (K, E, B_loc, n_patches, vit_dim)."""
    shp = _shape(shape_name, "train")
    cfg = arch.model_for_shape(shape_name)
    transformer.check_supported(cfg)
    K, E = arch.fed.cohort_size, arch.fed.local_steps
    B = arch.fed.local_batch_for(shp["global_batch"])
    return _batch(cfg, (K, E, B), shp["seq_len"])


def prefill_batch_specs(arch: ArchSpec, shape_name: str) -> Dict:
    """Prefill batch: {"tokens": (B, S) int32}, and a vlm's patch
    embeddings (B, n_patches, vit_dim)."""
    shp = _shape(shape_name, "prefill")
    cfg = arch.model_for_shape(shape_name)
    transformer.check_supported(cfg)
    return _batch(cfg, (shp["global_batch"],), shp["seq_len"])


def _shape_tree(cfg):
    with shapes_only():
        return transformer.init_params(cfg, jr.PRNGKey(0, device="cpu"),
                                       device="cpu")


def param_specs(cfg) -> Dict:
    """``init_params``'s tree with a :class:`ShapeDtype` at each leaf."""
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype),
                    _shape_tree(cfg))


def count_params(cfg) -> int:
    return int(sum(t.numel() for t in tree_leaves(_shape_tree(cfg))))
