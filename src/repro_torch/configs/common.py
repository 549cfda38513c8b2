"""ArchSpec: one assigned architecture as a selectable config (port of
``repro.configs.common``).

Each ``repro_torch/configs/<arch>.py`` exposes ``SPEC: ArchSpec`` with
  * the exact full-size ModelConfig of the JAX package,
  * the federated execution mode (``FedExec``, parallel or sequential
    cohort),
  * a reduced smoke variant for CPU tests.

The train and prefill input shapes are ported.  The decode shapes
(``decode_32k``, ``long_500k``) and the long-context variants come with
``build_decode_step``: ROADMAP.md queue 1 item 12 step 6.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.layers import ModelConfig

INPUT_SHAPES: Dict[str, dict] = {
    "train_4k":    dict(kind="train",   seq_len=4_096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768,  global_batch=32),
}

# the JAX package's other input shapes: ROADMAP.md queue 1 item 12 step 6
DEFERRED_SHAPES = ("decode_32k", "long_500k")


@dataclasses.dataclass(frozen=True)
class FedExec:
    """Federated round execution parameters for the training shapes."""
    cohort_mode: str          # "parallel" | "sequential"
    cohort_size: int          # K clients per round in the cohort
    local_steps: int = 2      # E
    remat: bool = True        # activation checkpointing in local steps
    server_opt: str = "adam"  # adam | sgd | yogi
    acc_dtype: str = "float32"  # delta-accumulator dtype (bf16 for 100B+)
    seq_parallel: bool = True   # sequence-parallel residual stream

    @property
    def local_batch_for(self):
        def f(global_batch: int) -> int:
            assert global_batch % self.cohort_size == 0, (global_batch,
                                                          self.cohort_size)
            return global_batch // self.cohort_size
        return f


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    source: str               # citation bracket from the assignment
    model: ModelConfig
    fed: FedExec
    smoke_model: ModelConfig
    # long-context handling: "native" (sub-quadratic), "swa_variant"
    # (documented sliding-window override, long_context_window set), "skip"
    long_context: str = "swa_variant"
    long_context_window: int = 8192
    notes: str = ""

    def model_for_shape(self, shape_name: str) -> ModelConfig:
        """ModelConfig of an input shape: the full model for the train and
        prefill shapes; the decode shapes raise ``NotImplementedError``
        naming their ROADMAP.md item, and any other name ``KeyError``."""
        if shape_name in DEFERRED_SHAPES:
            raise NotImplementedError(
                f"input shape {shape_name!r} is not ported to repro_torch "
                f"yet (ROADMAP.md queue 1 item 12 step 6)")
        if shape_name not in INPUT_SHAPES:
            raise KeyError(f"unknown input shape {shape_name!r}; known: "
                           f"{sorted(INPUT_SHAPES)}")
        return self.model

    def supported_shapes(self):
        return list(INPUT_SHAPES)
