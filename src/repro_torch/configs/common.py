"""ArchSpec: one assigned architecture as a selectable config (port of
``repro.configs.common``).

Each ``repro_torch/configs/<arch>.py`` exposes ``SPEC: ArchSpec`` with
  * the exact full-size ModelConfig of the JAX package,
  * the federated execution mode (``FedExec``, parallel or sequential
    cohort),
  * per-input-shape applicability (long_500k needs sub-quadratic
    attention, or the documented sliding-window variant),
  * a reduced smoke variant for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..models.layers import ModelConfig

INPUT_SHAPES: Dict[str, dict] = {
    "train_4k":    dict(kind="train",   seq_len=4_096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32_768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524_288, global_batch=1),
}


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

    def model_for_shape(self, shape_name: str) -> Optional[ModelConfig]:
        """ModelConfig of an input shape (None: the arch skips it), as the
        JAX package's: the full model, except at ``long_500k``, where a
        ``swa_variant`` arch takes ``long_context_window`` and a ``skip``
        arch gives None.  An unknown name raises ``KeyError``."""
        if shape_name not in INPUT_SHAPES:
            raise KeyError(f"unknown input shape {shape_name!r}; known: "
                           f"{sorted(INPUT_SHAPES)}")
        if shape_name != "long_500k" or self.long_context == "native":
            return self.model
        if self.long_context == "swa_variant":
            return self.model.replace(
                long_context_window=self.long_context_window)
        return None

    def supported_shapes(self):
        return [s for s in INPUT_SHAPES if self.model_for_shape(s) is not None]
