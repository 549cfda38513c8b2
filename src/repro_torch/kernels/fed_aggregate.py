"""The F3AST aggregation step (Alg. 1 line 9): Δ[d] = Σ_k w_k · v[k, d].

Port of ``repro.kernels.fed_aggregate``.  On a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/fed_aggregate.cu`` (float32
accumulation, result in the delta dtype, float32 or bfloat16); on a CPU
tensor it runs the plain version in ``kernels/ref.py``.  Any other device
raises; nothing falls back.  ``fed_aggregate.launches`` counts launches.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map
from . import _build
from . import ref as _ref

__all__ = ["fed_aggregate", "fed_aggregate_tree"]

_DTYPES = (torch.float32, torch.bfloat16)


def fed_aggregate(deltas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(K, D) cohort deltas, (K,) float32 weights -> (D,) in
    ``deltas.dtype``."""
    if deltas.device.type == "cpu":
        return _ref.fed_aggregate_ref(deltas, weights)
    if deltas.device.type != "cuda":
        raise RuntimeError(f"fed_aggregate runs on cuda or cpu tensors, got "
                           f"{deltas.device}")
    if deltas.dim() != 2:
        raise ValueError(f"deltas must be (K, D), got {tuple(deltas.shape)}")
    k_rows, d_cols = deltas.shape
    if deltas.dtype not in _DTYPES:
        raise TypeError(f"deltas must be one of {_DTYPES}, got {deltas.dtype}")
    if weights.dtype != torch.float32 or tuple(weights.shape) != (k_rows,):
        raise ValueError(f"weights must be float32 ({k_rows},), got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    if weights.device != deltas.device:
        raise ValueError(f"weights on {weights.device}, deltas on "
                         f"{deltas.device}")
    if not (deltas.is_contiguous() and weights.is_contiguous()):
        raise ValueError("deltas and weights must be contiguous")
    lib = _build.load("fed_aggregate")
    out = torch.empty(d_cols, dtype=deltas.dtype, device=deltas.device)
    fn = (lib.fed_aggregate_f32 if deltas.dtype == torch.float32
          else lib.fed_aggregate_bf16)
    err = fn(deltas.data_ptr(), weights.data_ptr(), out.data_ptr(), k_rows,
             d_cols, torch.cuda.current_stream(deltas.device).cuda_stream)
    _build.check(err, "fed_aggregate kernel launch")
    fed_aggregate.launches += 1
    return out


fed_aggregate.launches = 0


def fed_aggregate_tree(deltas, weights: torch.Tensor):
    """Alg. 1 line 9 over a parameter tree (nested dicts and lists) of
    (K, ...) leaves: the leaves are flattened into one (K, D) buffer in
    JAX's leaf order, reduced by ONE :func:`fed_aggregate` call, and split
    back to the leaf shapes and dtypes.  A tree of mixed dtypes is reduced
    in float32 (the buffer takes the widest) and each leaf's sum is cast
    back once."""
    leaves = tree_leaves(deltas)
    k_rows = leaves[0].shape[0]
    flat = torch.cat([x.reshape(k_rows, -1) for x in leaves], dim=1)
    pieces = iter(torch.split(fed_aggregate(flat, weights),
                              [x[0].numel() for x in leaves]))
    return tree_map(lambda x: next(pieces).reshape(x.shape[1:]).to(x.dtype),
                    deltas)
