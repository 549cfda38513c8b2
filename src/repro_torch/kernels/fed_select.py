"""The fused F3AST selection step (Alg. 1 lines 4, 5 and 9):

    mask  = top-min(K_t, |C_t|) available clients by score   (line 4)
    r(t)  = (1 − β) r(t−1) + β · 1_{S_t}                     (line 5)
    w_k   = weight rule on the cohort (p_k / r_k, 1/|S|, …)  (line 9)

Port of ``repro.kernels.fed_select``.  On a CUDA tensor the wrappers launch
the hand-written kernel in ``csrc/fed_select.cu`` once a call (a radix-select
threshold cut with the stable (score, id) tie-break, then the EMA and
weights in the same kernel: one block up to its crossover N, one
cooperative launch across the SMs above it); on a CPU tensor they run the
plain version in ``kernels/ref.py``.  Any other device raises; nothing
falls back.

Bit-parity contract, as in the JAX package: the mask, r_k and the
``unbiased``, ``unbiased_frozen`` and ``uniform`` weights are bitwise the
unfused cut → ``update_rates`` → weight rule.  ``fedavg`` divides by a float
sum whose order differs between backends, so it is held to allclose.

Each wrapper counts its kernel launches in ``.launches`` (``fed_select``
also by weight mode, in ``.launches_by_mode``).
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref
from .ref import SELECT_WEIGHT_MODES

__all__ = ["fed_select", "fed_select_mask", "reset_launches"]

_MODES = {"unbiased": 1, "unbiased_frozen": 2, "uniform": 3, "fedavg": 4}


def _check_vec(name: str, x: torch.Tensor, n: int, dtype, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, scores on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != (n,):
        raise ValueError(f"{name} must have shape ({n},), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _k_arg(k, device):
    """(tensor or None, value): the budget as the kernel reads it, from
    device memory (one int32 element: no host sync) or by value (an
    int)."""
    if torch.is_tensor(k):
        if k.device != device or k.numel() != 1:
            raise ValueError(f"k must be one value on {device}, got "
                             f"{tuple(k.shape)} on {k.device}")
        return (k if k.dtype == torch.int32 else k.to(torch.int32)), 0
    return None, int(k)


# the kernel's client count is an int32
_N_MAX = 2 ** 31 - 1

# path: 0 by N (the kernel's crossover), 1 the one-block path, 2 the
# cooperative one; anything but 0 is for measuring the two
_PATHS = {None: 0, "small": 1, "large": 2}


def _launch(scores, avail, k, r, p, rw, beta: float, mode: int,
            path: str | None = None):
    """One launch of the CUDA kernel; returns (mask, new_r, w) (the last
    two None in mask-only mode)."""
    if path not in _PATHS:
        raise ValueError(f"unknown path {path!r}; known: small, large")
    dev = scores.device
    n = scores.shape[0]
    if n > _N_MAX:
        raise ValueError(f"fed_select takes N <= {_N_MAX} clients (the "
                         f"kernel indexes them with int32), got {n}")
    lib = _build.load("fed_select")
    k_dev, k_value = _k_arg(k, dev)
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    full = mode != 0
    new_r = torch.empty(n, dtype=torch.float32, device=dev) if full else None
    w = torch.empty(n, dtype=torch.float32, device=dev) if full else None
    ws = ws_words = None
    if path == "large" or (path is None and n > lib.fed_select_small_max()):
        ws_words = lib.fed_select_workspace_words()
        floats = lib.fed_select_workspace_floats()
        if ws_words < 0 or floats < 0:
            raise RuntimeError("fed_select: the device's SM count or the "
                               "kernel's occupancy could not be read")
        # one allocation: the 32-bit words, then the floats
        ws = torch.empty(ws_words + floats, dtype=torch.int32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    # the current stream's handle without building a torch Stream object
    # (torch.cuda.current_stream costs several microseconds a call, more
    # than this kernel at the main path's N)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = lib.fed_select_launch(
        ptr(scores), ptr(avail), ptr(k_dev), k_value, ptr(r), ptr(p),
        ptr(rw), ptr(mask), ptr(new_r), ptr(w), n, float(beta),
        1.0 - float(beta), mode, ptr(ws),
        None if ws is None else ws.data_ptr() + 4 * ws_words,
        _PATHS[path], stream)
    _build.check(err, "fed_select kernel launch")
    return mask, new_r, w


def _device_of(scores: torch.Tensor) -> str:
    if scores.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"fed_select runs on cuda or cpu tensors, got "
                           f"{scores.device}")
    return scores.device.type


def fed_select_mask(scores: torch.Tensor, avail: torch.Tensor, k, *,
                    path: str | None = None) -> torch.Tensor:
    """The top-k cut alone: drop-in for ``core.selection._topk_mask`` (used
    when a completion hook separates the cut from the EMA and weights).
    ``path`` ("small", "large") forces one of the kernel's two paths, for
    measuring them; by default N decides."""
    if _device_of(scores) == "cpu":
        return _ref.topk_threshold_mask(scores, avail,
                                        torch.as_tensor(k, dtype=torch.int32))
    n = scores.shape[0]
    _check_vec("scores", scores, n, torch.float32, scores.device)
    _check_vec("avail", avail, n, torch.bool, scores.device)
    mask, _, _ = _launch(scores, avail, k, None, None, None, 0.0, 0, path)
    fed_select_mask.launches += 1
    return mask


fed_select_mask.launches = 0


def fed_select(scores: torch.Tensor, avail: torch.Tensor, k, r: torch.Tensor,
               p: torch.Tensor, beta: float, *, weight_mode: str = "unbiased",
               r_weight: torch.Tensor | None = None,
               path: str | None = None):
    """The fused selection step: ``(mask, new_r, weights)`` in one call.

    ``scores``/``avail``/``r``/``p``: (N,) round inputs (float32, bool);
    ``k``: the round budget K_t (an int32 scalar tensor on the same device,
    or an int); ``beta``: the rate-EMA step (a Python float, folded with
    1 − β in float64 and cast to float32 once, as JAX folds it).
    ``weight_mode="unbiased_frozen"`` also needs ``r_weight``; ``path`` as
    in :func:`fed_select_mask`.
    """
    if weight_mode not in SELECT_WEIGHT_MODES:
        raise ValueError(f"unknown weight_mode {weight_mode!r}; "
                         f"known: {SELECT_WEIGHT_MODES}")
    if weight_mode == "unbiased_frozen" and r_weight is None:
        raise ValueError("weight_mode='unbiased_frozen' needs r_weight= "
                         "(the frozen target rate)")
    beta = float(beta)
    if _device_of(scores) == "cpu":
        return _ref.fed_select_ref(scores, avail,
                                   torch.as_tensor(k, dtype=torch.int32),
                                   r, p, beta, weight_mode=weight_mode,
                                   r_weight=r_weight)
    n = scores.shape[0]
    dev = scores.device
    _check_vec("scores", scores, n, torch.float32, dev)
    _check_vec("avail", avail, n, torch.bool, dev)
    _check_vec("r", r, n, torch.float32, dev)
    _check_vec("p", p, n, torch.float32, dev)
    if r_weight is not None:
        _check_vec("r_weight", r_weight, n, torch.float32, dev)
    out = _launch(scores, avail, k, r, p,
                  r_weight if weight_mode == "unbiased_frozen" else None,
                  beta, _MODES[weight_mode], path)
    fed_select.launches += 1
    fed_select.launches_by_mode[weight_mode] += 1
    return out


fed_select.launches = 0
# the same launches by weight mode; reset with ``reset_launches``
fed_select.launches_by_mode = dict.fromkeys(SELECT_WEIGHT_MODES, 0)


def reset_launches() -> None:
    """Set both wrappers' launch counts to 0."""
    fed_select.launches = fed_select_mask.launches = 0
    fed_select.launches_by_mode = dict.fromkeys(SELECT_WEIGHT_MODES, 0)
