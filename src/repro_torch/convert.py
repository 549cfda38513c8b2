"""Carry parameters across from the JAX package.

The JAX package's parameters are a pytree of arrays; as a dict of numpy
arrays (``jax.tree.map(np.asarray, params)``) they become the port's dict
of tensors on a given device, byte for byte, and back.  The parity tests
start both packages from the same weights this way.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .device import resolve_device


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device=None) -> dict:
    """{name: numpy array} -> {name: tensor on ``device``} (default CUDA),
    same bytes."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in params.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict:
    """{name: tensor} -> {name: numpy array} (for comparisons)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
