"""ArchSpec: one assigned architecture as a selectable config (port of
``repro.configs.common``, the part the serving slice reads).

Each ``repro_torch/configs/<arch>.py`` exposes ``SPEC: ArchSpec`` with
  * the exact full-size ModelConfig of the JAX package,
  * a reduced smoke variant for CPU tests.

Only the prefill input shape is ported.  The federated execution mode
(``FedExec``), the train and decode shapes and the long-context variants
come with the programs that read them (ROADMAP.md queue 1 items 11-12).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.layers import ModelConfig

INPUT_SHAPES: Dict[str, dict] = {
    "prefill_32k": dict(kind="prefill", seq_len=32_768, global_batch=32),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    source: str               # citation bracket from the assignment
    model: ModelConfig
    smoke_model: ModelConfig
    notes: str = ""
