"""Configs of the port: the paper's tasks and the assigned architectures
(``--arch <id>`` resolution).  All ten of the JAX package's architectures
are ported: the four dense ones (llama3.2-1b, qwen3-8b, qwen3-14b,
gemma-7b), mamba2-2.7b, the two moe ones (mixtral-8x22b, grok-1-314b),
the hybrid recurrentgemma-2b, the vlm llava-next-34b and the audio
whisper-small."""
from __future__ import annotations

from ..registry import lookup
from . import (gemma_7b, grok_1_314b, llama3_2_1b, llava_next_34b,
               mamba2_2_7b, mixtral_8x22b, qwen3_8b, qwen3_14b,
               recurrentgemma_2b, whisper_small)
from .common import INPUT_SHAPES, ArchSpec
from .paper_tasks import (CIFAR, PAPER_TASKS, SHAKESPEARE, SYNTHETIC,
                          PaperTask)

ARCHS = {m.SPEC.arch_id: m.SPEC
         for m in (llama3_2_1b, qwen3_8b, qwen3_14b, gemma_7b, mamba2_2_7b,
                   mixtral_8x22b, grok_1_314b, recurrentgemma_2b,
                   llava_next_34b, whisper_small)}

# architectures of the JAX package not ported yet: none
DEFERRED_ARCHS = ()


def get_arch(arch_id: str) -> ArchSpec:
    return ARCHS[lookup("arch", arch_id, ARCHS, DEFERRED_ARCHS)]


__all__ = ["ARCHS", "DEFERRED_ARCHS", "get_arch", "ArchSpec",
           "INPUT_SHAPES", "PAPER_TASKS", "PaperTask", "SYNTHETIC",
           "SHAKESPEARE", "CIFAR"]
