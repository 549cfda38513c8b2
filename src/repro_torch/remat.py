"""Activation checkpointing that composes with ``torch.func`` (the port's
``jax.checkpoint``).

``checkpoint(fn, static, *tensors)`` returns ``fn(tensors, static)`` (a
tensor, or a tuple of tensors such as a layer's output and its MoE
load-balancing loss) and keeps nothing of its forward for the backward
but ``tensors``: the backward runs ``fn`` again under ``vjp``.  It works under
``torch.func.grad`` and ``vmap`` (``torch.utils.checkpoint`` does not), so
the federated round's per-step remat, the model's per-layer remat and the
fused loss's per-chunk remat share it.  ``static`` is handed to ``fn`` as
it is and gets no gradient (token ids, masks, a batch dict).  A
checkpoint has a first derivative only.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import vjp

__all__ = ["checkpoint"]


class Remat(torch.autograd.Function):
    """``fn(tensors, static)`` with its forward recomputed in the
    backward; ``fn`` returns a tensor or a tuple of tensors."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, static, *tensors):
        return fn(tensors, static)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, static, *tensors = inputs
        ctx.fn, ctx.static = fn, static
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        # torch.func.grad runs the backward with create_graph=True, which
        # would record the recomputed forward and its vjp for a second
        # derivative and keep their intermediates (and every activation
        # gradient they touch) alive to the end of the whole backward.
        # Under no_grad they are freed as soon as this returns; vjp
        # differentiates inside all the same.  No second derivative is
        # taken through a checkpoint.
        with torch.no_grad():
            out, pull = vjp(lambda *ts: ctx.fn(ts, ctx.static),
                            *ctx.saved_tensors)
            return (None, None) + tuple(
                pull(grads if isinstance(out, tuple) else grads[0]))


def checkpoint(fn: Callable, static, *tensors: torch.Tensor):
    """``fn(tensors, static)``, its activations recomputed in the backward
    instead of kept; the same values and gradients, for each output."""
    return Remat.apply(fn, static, *tensors)
