"""Where the port runs: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises
    ``RuntimeError``: the port never moves to the CPU on its own; pass
    ``device="cpu"`` for the CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"repro_torch runs on cuda or cpu, got {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class OnDevice:
    """Base of the frozen dataclasses that hold tensors (availability
    processes, budget schedules, completion processes): a keyword-only
    ``device`` (None: CUDA), resolved once."""

    device: Optional[torch.device] = dataclasses.field(default=None,
                                                       kw_only=True)

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A numpy array (built as the JAX package builds it) on the
        device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
