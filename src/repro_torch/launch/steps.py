"""The train and prefill programs of an (arch x input shape) pair (port of
``repro.launch.steps``), on one card: no mesh and no shardings.  The
shardings of ``build_train_step`` and ``build_decode_step`` are ROADMAP.md
queue 1 item 11; the decode shapes, item 12 step 6.
"""
from __future__ import annotations

import torch

from ..configs.common import INPUT_SHAPES, ArchSpec
from ..core.fedstep import make_fed_round
from ..models import get_model_api
from ..optim import make_optimizer
from . import specs as S

_ACC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_trainable(cfg, device=None) -> None:
    """Raise ``NotImplementedError`` where the port cannot train ``cfg``:
    the ssm family on a CUDA device, whose ``ssd_chunk`` kernel has no
    backward yet (ROADMAP.md queue 1 item 15).  On the CPU it trains on
    the plain path.  The other families train on both: their attention's
    gradient is the flash_attention_bwd kernel, and the hybrid's RG-LRU
    is plain torch.  Decided before anything is built."""
    on_cuda = torch.device("cuda" if device is None else device).type \
        == "cuda"
    if cfg.family == "ssm" and on_cuda:
        raise NotImplementedError(
            f"{cfg.name}: training the ssm family on CUDA needs a backward "
            f"for the ssd_chunk kernel, which is not written yet (ROADMAP.md "
            f"queue 1 item 15); pass device='cpu' for the plain path")


def build_train_step(arch: ArchSpec, shape_name: str, device=None):
    """The F3AST federated round of ``arch`` at a train shape, as the JAX
    package builds it: ``cfg.remat`` from ``arch.fed.remat`` (per-layer
    checkpoints), ``arch.fed.server_opt`` (lr 1.0 for sgd, else 1e-3), the
    round in ``arch.fed.cohort_mode`` with ``arch.fed.acc_dtype``.

    Returns ``(fed_round, server_opt, batch_shapes)``:
    ``fed_round(params, opt_state, cohort_batch, weights, client_lr)`` as
    ``core.fedstep.make_fed_round`` gives it, the optimizer whose
    ``init(params)`` makes ``opt_state``, and
    ``{"tokens": ShapeDtype((K, E, B, S), torch.int32)}``.  ``device``
    (default CUDA) is where the round will run; only the refusal of
    :func:`check_trainable` reads it.  A vlm's batch also holds its
    ``patch_embeds`` (``specs.cohort_batch_specs``)."""
    cfg = arch.model_for_shape(shape_name).replace(remat=arch.fed.remat)
    check_trainable(cfg, device)
    batch_shapes = S.cohort_batch_specs(arch, shape_name)
    api = get_model_api(cfg)
    sgd = arch.fed.server_opt == "sgd"
    opt = make_optimizer(arch.fed.server_opt, lr=1.0 if sgd else 1e-3)
    fed_round = make_fed_round(api.loss_fn, opt, mode=arch.fed.cohort_mode,
                               remat=False,
                               acc_dtype=_ACC_DTYPES[arch.fed.acc_dtype])
    return fed_round, opt, batch_shapes


def build_prefill_step(arch: ArchSpec, shape_name: str):
    """Returns ``(prefill, batch_shapes)``: ``prefill(params, batch)`` gives
    the last position's logits (B, 1, V), and ``batch_shapes`` is
    ``{"tokens": ShapeDtype((B, S), torch.int32)}``, with a vlm's
    ``patch_embeds`` (``specs.prefill_batch_specs``)."""
    if INPUT_SHAPES.get(shape_name, {}).get("kind") != "prefill":
        names = sorted(n for n, s in INPUT_SHAPES.items()
                       if s["kind"] == "prefill")
        raise ValueError(f"{shape_name!r}: the prefill shapes are {names} "
                         f"(decode with shardings: ROADMAP.md queue 1 "
                         f"item 11)")
    api = get_model_api(arch.model)
    return api.prefill, S.prefill_batch_specs(arch, shape_name)
