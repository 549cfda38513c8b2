"""The prefill program of an (arch x input shape) pair (port of
``repro.launch.steps.build_prefill_step``), on one card: no mesh and no
shardings.  ``build_train_step`` and ``build_decode_step`` with shardings
are ROADMAP.md queue 1 item 11.
"""
from __future__ import annotations

import torch

from ..configs.common import INPUT_SHAPES, ArchSpec
from ..models import get_model_api


def build_prefill_step(arch: ArchSpec, shape_name: str):
    """Returns ``(prefill, batch_shapes)``: ``prefill(params, batch)`` gives
    the last position's logits (B, 1, V), and ``batch_shapes`` is
    ``{"tokens": ((B, S), torch.int32)}`` (``specs.prefill_batch_specs``
    of the dense and ssm families)."""
    if shape_name not in INPUT_SHAPES:
        raise ValueError(f"{shape_name!r}: only the prefill shapes "
                         f"{sorted(INPUT_SHAPES)} are ported (train and "
                         f"decode with shardings: ROADMAP.md queue 1 item 11)")
    shp = INPUT_SHAPES[shape_name]
    api = get_model_api(arch.model)
    batch_shapes = {"tokens": ((shp["global_batch"], shp["seq_len"]),
                               torch.int32)}
    return api.prefill, batch_shapes
