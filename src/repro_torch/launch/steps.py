"""The programs of an (arch x input shape) pair (port of
``repro.launch.steps``), one a kind of shape:

  train   — the F3AST federated round (``build_train_step``)
  prefill — full-sequence forward, last-position logits
            (``build_prefill_step``)
  decode  — one serve step against the KV caches or recurrent state
            (``build_decode_step``)

``build_step`` dispatches by the shape's kind.  All run on one card: a
``mesh=`` (JAX's sharded programs) raises ``NotImplementedError`` (the
step builders with shardings are ROADMAP.md queue 1 item 11, its second
half).
"""
from __future__ import annotations

import torch

from ..configs.common import INPUT_SHAPES, ArchSpec
from ..core.fedstep import make_fed_round
from ..models import get_model_api
from ..optim import make_optimizer
from . import specs as S

_ACC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _one_card(name: str, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{name}(mesh=...): the step builders with shardings are not "
            f"ported yet (ROADMAP.md queue 1 item 11, its second half); "
            f"without a mesh the program runs on one card")


def build_train_step(arch: ArchSpec, shape_name: str, mesh=None):
    """The F3AST federated round of ``arch`` at a train shape, as the JAX
    package builds it: ``cfg.remat`` from ``arch.fed.remat`` (per-layer
    checkpoints), ``arch.fed.server_opt`` (lr 1.0 for sgd, else 1e-3), the
    round in ``arch.fed.cohort_mode`` with ``arch.fed.acc_dtype``.

    Returns ``(fed_round, server_opt, batch_shapes)``:
    ``fed_round(params, opt_state, cohort_batch, weights, client_lr)`` as
    ``core.fedstep.make_fed_round`` gives it, the optimizer whose
    ``init(params)`` makes ``opt_state``, and
    ``{"tokens": ShapeDtype((K, E, B, S), torch.int32)}``.  The round
    runs where its tensors lie, every family on the CPU and on CUDA: the
    attention's gradient is the flash_attention_bwd kernel, the ssm
    family's the ssd_chunk_bwd kernel, and the hybrid's RG-LRU is plain
    torch.  A vlm's batch also holds its ``patch_embeds``, the audio
    family's its ``frames`` (``specs.cohort_batch_specs``)."""
    _one_card("build_train_step", mesh)
    cfg = arch.model_for_shape(shape_name).replace(remat=arch.fed.remat)
    batch_shapes = S.cohort_batch_specs(arch, shape_name)
    api = get_model_api(cfg)
    sgd = arch.fed.server_opt == "sgd"
    opt = make_optimizer(arch.fed.server_opt, lr=1.0 if sgd else 1e-3)
    fed_round = make_fed_round(api.loss_fn, opt, mode=arch.fed.cohort_mode,
                               remat=False,
                               acc_dtype=_ACC_DTYPES[arch.fed.acc_dtype])
    return fed_round, opt, batch_shapes


_STEP_FNS = {"train": "build_train_step", "prefill": "build_prefill_step",
             "decode": "build_decode_step"}


def _check_kind(shape_name: str, kind: str) -> None:
    got = INPUT_SHAPES.get(shape_name, {}).get("kind")
    if got != kind:
        names = sorted(n for n, s in INPUT_SHAPES.items()
                       if s["kind"] == kind)
        where = (f"; {shape_name!r} is a {got} shape: {_STEP_FNS[got]}"
                 if got else "")
        raise ValueError(f"the {kind} shapes are {names}{where}")


def build_prefill_step(arch: ArchSpec, shape_name: str, mesh=None):
    """Returns ``(prefill, batch_shapes)``: ``prefill(params, batch)`` gives
    the last position's logits (B, 1, V), and ``batch_shapes`` is
    ``{"tokens": ShapeDtype((B, S), torch.int32)}``, with a vlm's
    ``patch_embeds`` or the audio family's ``frames``
    (``specs.prefill_batch_specs``)."""
    _one_card("build_prefill_step", mesh)
    _check_kind(shape_name, "prefill")
    api = get_model_api(arch.model_for_shape(shape_name))
    return api.prefill, S.prefill_batch_specs(arch, shape_name)


def build_decode_step(arch: ArchSpec, shape_name: str, mesh=None):
    """Returns ``(decode_step, state_shapes, tok_shape)`` at a decode
    shape: ``decode_step(params, state, tok)`` -> (logits (B, 1, V),
    state), the model's ``decode_step`` for ``arch.model_for_shape``
    (at ``long_500k`` a ``swa_variant`` arch's attention is a ring of
    ``long_context_window`` slots); the state's shapes and dtypes
    (``specs.decode_state_specs``, nothing allocated) and the token's,
    (B, 1) int32.  An arch that skips the shape raises ``ValueError``."""
    _one_card("build_decode_step", mesh)
    _check_kind(shape_name, "decode")
    state_shapes = S.decode_state_specs(arch, shape_name)
    api = get_model_api(arch.model_for_shape(shape_name))
    return (api.decode_step, state_shapes,
            S.decode_tok_specs(arch, shape_name))


def build_step(arch: ArchSpec, shape_name: str, mesh=None):
    """Dispatch by the shape's kind: ``build_train_step``,
    ``build_prefill_step`` or ``build_decode_step``."""
    _one_card("build_step", mesh)
    kind = INPUT_SHAPES[shape_name]["kind"]
    if kind == "train":
        return build_train_step(arch, shape_name)
    if kind == "prefill":
        return build_prefill_step(arch, shape_name)
    return build_decode_step(arch, shape_name)
