"""Carry parameters across from the JAX package, and back.

The JAX package's parameters are a pytree of arrays; as nested dicts and
lists of numpy arrays (``jax.tree.map(np.asarray, params)``) they become
the port's nested dicts and lists of tensors on a given device, byte for
byte, and back.  The tree is kept as it is: the stacked layer axis of the
transformer's blocks, the LSTM's list of layers and the ResNet's list of
blocks included.  The parity tests start both packages from the same weights
this way.

bfloat16: ``np.asarray`` of a JAX bf16 array has the ``ml_dtypes``
bfloat16 dtype, which ``torch.from_numpy`` refuses; its bits go across as
uint16 (viewed as int16, then as ``torch.bfloat16``), which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .tree import tree_map


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # the ml_dtypes bfloat16 type is what the JAX package hands out;
        # it is needed only to compare with, or pass back to, JAX
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(params, device=None):
    """Nested dicts and lists of numpy arrays -> the same tree of tensors
    on ``device`` (default CUDA), same bytes."""
    device = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, device), params)


def params_to_numpy(params):
    """Nested dicts and lists of tensors -> the same tree of numpy arrays
    (for comparisons), same bytes."""
    return tree_map(_leaf_to_numpy, params)
