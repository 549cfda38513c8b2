"""Configs of the port: the paper's tasks and the assigned architectures
(``--arch <id>`` resolution).  Of the JAX package's ten architectures
the four dense ones (llama3.2-1b, qwen3-8b, qwen3-14b, gemma-7b),
mamba2-2.7b and the two moe ones (mixtral-8x22b, grok-1-314b) are
ported; the others raise ``NotImplementedError`` naming their ROADMAP.md
item."""
from __future__ import annotations

from ..registry import lookup
from . import (gemma_7b, grok_1_314b, llama3_2_1b, mamba2_2_7b,
               mixtral_8x22b, qwen3_8b, qwen3_14b)
from .common import INPUT_SHAPES, ArchSpec
from .paper_tasks import (CIFAR, PAPER_TASKS, SHAKESPEARE, SYNTHETIC,
                          PaperTask)

ARCHS = {m.SPEC.arch_id: m.SPEC
         for m in (llama3_2_1b, qwen3_8b, qwen3_14b, gemma_7b, mamba2_2_7b,
                   mixtral_8x22b, grok_1_314b)}

# the JAX package's other architectures: ROADMAP.md queue 1 item 12
DEFERRED_ARCHS = ("llava-next-34b", "recurrentgemma-2b", "whisper-small")


def get_arch(arch_id: str) -> ArchSpec:
    return ARCHS[lookup("arch", arch_id, ARCHS, DEFERRED_ARCHS, 12)]


__all__ = ["ARCHS", "DEFERRED_ARCHS", "get_arch", "ArchSpec",
           "INPUT_SHAPES", "PAPER_TASKS", "PaperTask", "SYNTHETIC",
           "SHAKESPEARE", "CIFAR"]
