"""The programs of an (arch x input shape) pair (port of
``repro.launch.steps``), one a kind of shape:

  train   — the F3AST federated round (``build_train_step``)
  prefill — full-sequence forward, last-position logits
            (``build_prefill_step``)
  decode  — one serve step against the KV caches or recurrent state
            (``build_decode_step``)

``build_step`` dispatches by the shape's kind.  Without a mesh each runs
on one card.

**Over a (data, model) mesh** (``mesh=``, a ``launch.mesh.FedMesh`` over
axes named ``data`` and ``model``, or ``pod``, ``data`` and ``model``)
``build_prefill_step`` and ``build_decode_step`` return a
:class:`MeshStep`: a program each rank runs on its own blocks, which
unpacks as JAX's ``(fn, arg_structs, in_shardings, out_shardings)`` with
spec trees for the shardings.  The dense family only; the other families
with a mesh, ``build_train_step(mesh=)`` and
``make_fed_round(param_shardings=)`` raise ``NotImplementedError``
(ROADMAP.md queue 1 item 11).

Where JAX pins activations (``_configure_hooks``) and lets XLA partition,
each rank computes Megatron-style with explicit collectives
(``models.layers``): the parameters stored by ``param_shardings`` (JAX's
specs) over the model axis, replicated over the data axes; the batch
split over the data axes where it divides (``batch_shardings``), else
replicated; each rank runs the flash_attention kernel on its H/m query
heads, all-reduces the partial sums after ``wo`` and ``w2`` over the
model axis (in float32), looks the embedding up vocab-parallel and
returns its block of the last position's logits: its rows over the data
axes (where the batch divides) and its vocab slice over ``model`` (where
the vocabulary divides), as JAX's ``out_shardings``.

What a rank computes on whole leaves instead (gathered over the model
axis from their stored blocks at each call): the attention where the
query heads do not divide the axis (qwen3-14b's smoke config at m = 4,
10 heads; JAX maps ``q_seq`` to ``model`` there, the port runs the
layer's attention replicated over the axis), ``wk``/``wv`` where the kv
heads do not divide it (every rank computes every kv head and reads the
ones its queries share), the MLP where d_ff does not, the embedding where
the vocabulary does not.

**The decode state departs from ``decode_state_shardings``**, which puts
the model axis on a cache's last dim, head_dim: the program holds each
rank's cache by kv heads, (layers, B/d, M, KV/m, hd), since its
attention reads whole heads (all KV heads where KV does not divide the
axis).  A batch that does not divide the data axes (``long_500k``'s B =
1) is replicated over them; JAX splits the cache's longest dim there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..configs.common import INPUT_SHAPES, ArchSpec
from ..core.fedstep import make_fed_round
from ..models import get_model_api, transformer
from ..models.layers import ModelConfig
from ..optim import make_optimizer
from ..sharding import hooks
from ..sharding.rules import (P, _axis_size, batch_shardings, gather_full,
                              local_blocks, model_dim, param_shardings,
                              specs_up_to)
from ..tree import tree_leaves_with_path, tree_unflatten
from . import specs as S
from .mesh import data_axes

__all__ = ["MeshStep", "build_train_step", "build_prefill_step",
           "build_decode_step", "build_step"]

_ACC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MESH_FAMILIES = ("dense",)


def _unported_mesh(name: str, what: str) -> None:
    raise NotImplementedError(
        f"{name}(mesh=...) {what} is not ported yet (ROADMAP.md queue 1 "
        f"item 11); without a mesh the program runs on one card")


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
    family's its ``frames`` (``specs.cohort_batch_specs``).  A ``mesh``
    raises ``NotImplementedError``."""
    if mesh is not None:
        _unported_mesh("build_train_step", "the training program over a "
                       "mesh (the backward kernels on local heads, the "
                       "sequential mode's FSDP carries)")
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


# ---------------------------------------------------------------------------
# The programs over a (data, model) mesh
# ---------------------------------------------------------------------------

def _configure_hooks(mesh, cfg: ModelConfig) -> dict:
    """The logical -> mesh-axis mapping the layers read: ``heads`` and
    ``kv_heads`` to ``model`` where the head counts divide it and
    ``tensor`` to ``model``, as JAX's ``_configure_hooks`` maps them,
    plus the port's ``vocab`` (to ``model`` where the vocabulary divides
    it: JAX splits the embeddings by their ``param_shardings`` alone).
    JAX's ``batch``, ``sequence``, ``expert`` and ``q_seq`` pin layouts
    that these programs hold by their specs (the batch) or do not split
    (the sequence, the experts; the queries where the heads do not
    divide, which run on every rank).  Returned, not left configured: a
    program configures it around each call (``hooks.configured``)."""
    msize = mesh.shape["model"]
    heads_ok = cfg.n_heads and cfg.n_heads % msize == 0
    kv_ok = cfg.n_kv_heads and cfg.n_kv_heads % msize == 0
    return {
        "tensor": "model",
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "vocab": "model" if cfg.vocab % msize == 0 else None,
    }


def _compute_dims(cfg: ModelConfig, mapping: dict, msize: int) -> dict:
    """{leaf name: the dim of a stacked block leaf (or a top-level leaf)
    the rank computes on its model-axis block of}; the leaves not named
    are computed whole.  The attention runs on the rank's query heads
    where they divide the axis and the kv heads either divide it too or
    each rank's queries read one kv head (H/KV a multiple of H/m)."""
    dims = {}
    if mapping["vocab"]:
        dims["embed"] = 0
        dims["unembed"] = 1
    if mapping["heads"]:
        n_q = cfg.n_heads // msize
        group = cfg.n_heads // cfg.n_kv_heads
        if mapping["kv_heads"] or group % n_q == 0:
            dims.update({"attn/wq": 2, "attn/wo": 1})
            if mapping["kv_heads"]:
                dims.update({"attn/wk": 2, "attn/wv": 2})
    if cfg.d_ff % msize == 0:
        dims.update({"mlp/w1": 2, "mlp/w3": 2, "mlp/w2": 1})
    return dims


def _leaf_name(path) -> str:
    keys = [str(k) for k in path]
    return "/".join(keys[1:] if keys[0] == "blocks" else keys)


@dataclasses.dataclass(frozen=True)
class MeshStep:
    """A serving program over a (data, model) mesh, as one rank runs it.

    ``fn`` takes and returns this rank's blocks: ``prefill(params,
    batch) -> logits (B/d, 1, V/m)``, or ``decode_step(params, state,
    tok) -> (logits, state)``.  ``args`` are the global shapes (JAX's
    ``arg_structs``), ``param_specs`` the parameters' layout, ``batch``
    the shape's global batch; ``in_specs`` and ``out_specs`` are the
    layouts ``fn`` takes and returns at that batch (JAX's shardings'
    specs; the decode state's is the program's own, by kv heads).
    Iterating gives ``(fn, args,
    in_specs, out_specs)``, as JAX's builders return.  At a cut batch,
    :meth:`specs` gives the layouts; :meth:`shard` carves a rank's blocks
    out of full inputs, :meth:`gather` the full logits back."""

    kind: str
    batch: int
    fn: Callable
    args: tuple
    param_specs: Any
    mesh: Any
    cfg: ModelConfig
    mapping: dict

    @property
    def in_specs(self) -> tuple:
        return self.specs(self.batch)[0]

    @property
    def out_specs(self):
        return self.specs(self.batch)[1]

    def __iter__(self):
        return iter((self.fn, self.args, self.in_specs, self.out_specs))

    def _bshard(self, batch: int):
        daxes = data_axes(self.mesh)
        return daxes if batch % _axis_size(self.mesh, daxes) == 0 else None

    def specs(self, batch: int):
        """``(in_specs, out_specs)`` at a global batch of ``batch`` rows."""
        bshard = self._bshard(batch)
        vshard = self.mapping["vocab"]
        logits = P(bshard, None, vshard)
        p_specs = self.param_specs
        if self.kind == "prefill":
            b = batch_shardings(_with_batch(self.args[1], batch), self.mesh,
                                batch_dim_axes=data_axes(self.mesh),
                                batch_dim=0)
            return (p_specs, b), logits
        st = _state_specs(self.args[1], bshard, self.mapping, self.mesh)
        return (p_specs, st, P(bshard, None)), (logits, st)

    def shard(self, args, batch: Optional[int] = None):
        """This rank's blocks of the full inputs ``args`` (``(params,
        batch)`` or ``(params, state, tok)``) at a global batch of
        ``batch`` rows (default: the shape's)."""
        in_specs, _ = self.specs(batch or self.batch)
        return tuple(local_blocks(a, s, self.mesh)
                     for a, s in zip(args, in_specs))

    def gather(self, logits: torch.Tensor,
               batch: Optional[int] = None) -> torch.Tensor:
        """The full logits from every rank's block (every rank of the
        mesh calls it)."""
        _, out = self.specs(batch or self.batch)
        spec = out[0] if self.kind == "decode" else out
        return gather_full(logits, spec, self.mesh)

    def init_state(self, batch: int, max_len: int, device=None):
        """This rank's zero decode state at a global batch of ``batch``
        rows and ``max_len`` positions."""
        bshard = self._bshard(batch)
        local = batch // _axis_size(self.mesh, bshard) if bshard else batch
        with hooks.configured(self.mesh, self.mapping):
            return transformer.init_decode_state(self.cfg, local, max_len,
                                                 device)

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy tokens (B/d, 1) int32 of this rank's logits block:
        the argmax over the whole vocabulary, gathered over the model
        axis, the lowest index among equal maxima (``torch.argmax``'s
        rule: each rank's first maximum, then the first rank's)."""
        idx = torch.argmax(logits, dim=-1)
        if not self.mapping["vocab"] or self.mesh.shape["model"] == 1:
            return idx.to(torch.int32)
        ax = self.mesh.axis_mesh("model")
        val = torch.gather(logits, -1, idx[..., None]).to(torch.float32)
        idx = idx[..., None] + ax.rank * logits.shape[-1]
        vals = ax.all_gather(val, dim=-1)
        idxs = ax.all_gather(idx, dim=-1)
        best = torch.argmax(vals, dim=-1, keepdim=True)
        return torch.gather(idxs, -1, best)[..., 0].to(torch.int32)


def _with_batch(shapes, batch: int):
    """The ShapeDtype tree with its leading dim set to ``batch``."""
    leaves = [x for _, x in tree_leaves_with_path(shapes, S.is_shape)]
    return tree_unflatten(shapes, [S.ShapeDtype((batch,) + s.shape[1:],
                                                s.dtype) for s in leaves],
                          S.is_shape)


def _state_specs(state, bshard, mapping: dict, mesh):
    """The decode state's layout as the program holds it: each KV cache
    (layers, B, M, KV, hd) by batch over the data axes and by kv heads
    over ``model`` (where they divide it; no axis of one rank named, as
    in ``decode_state_shardings``), the index replicated."""
    if _axis_size(mesh, data_axes(mesh)) == 1:
        bshard = None
    kv = mapping["kv_heads"] if mesh.shape["model"] > 1 else None

    flat = tree_leaves_with_path(state, S.is_shape)
    return tree_unflatten(state, [P() if len(s.shape) == 0 else
                                  P(None, bshard, None, kv, None)
                                  for _, s in flat], S.is_shape)


def _compute_specs(params, p_specs, dims: dict):
    """``(gather, carve)`` spec trees that take the stored blocks to the
    blocks a rank computes on: where a leaf's stored model-axis dim is not
    its compute dim (``dims``), its stored spec (all-gathered whole), then
    the compute dim's (cut to the rank's block); elsewhere no split (the
    stored block is the compute block)."""
    gather, carve = [], []
    flat = tree_leaves_with_path(params, S.is_shape)
    for (path, x), spec in zip(flat, specs_up_to(params, p_specs)):
        want = dims.get(_leaf_name(path))
        if model_dim(spec, "model") == want:
            gather.append(P())
            carve.append(P())
            continue
        gather.append(spec)
        c = [None] * len(x.shape)
        if want is not None:
            c[want] = "model"
        carve.append(P(*c))
    return (tree_unflatten(params, gather, S.is_shape),
            tree_unflatten(params, carve, S.is_shape))


def _mesh_program(arch: ArchSpec, shape_name: str, mesh, kind: str):
    cfg = arch.model_for_shape(shape_name)
    if cfg is None or cfg.family not in _MESH_FAMILIES:
        fam = cfg.family if cfg is not None else "skipped"
        _unported_mesh(f"build_{kind}_step",
                       f"for the {fam} family ({arch.arch_id}): the "
                       f"serving programs over a mesh cover the dense "
                       f"family; the {fam} family's")
    if "model" not in mesh.shape:
        raise ValueError(f"mesh {mesh.axis_names} has no 'model' axis")
    B = INPUT_SHAPES[shape_name]["global_batch"]
    mapping = _configure_hooks(mesh, cfg)
    dims = _compute_dims(cfg, mapping, mesh.shape["model"])
    p_shapes = S.param_specs(cfg)
    p_specs = param_shardings(p_shapes, mesh, fsdp_axes=None)
    gather, carve = _compute_specs(p_shapes, p_specs, dims)

    def local_params(params):
        """The rank's parameters as it computes on them."""
        return local_blocks(gather_full(params, gather, mesh), carve, mesh)

    if kind == "prefill":
        def fn(params, batch):
            with hooks.configured(mesh, mapping):
                return transformer.prefill(cfg, local_params(params), batch)
        args = (p_shapes, S.prefill_batch_specs(arch, shape_name))
    else:
        def fn(params, state, tok):
            with hooks.configured(mesh, mapping):
                return transformer.decode_step(cfg, local_params(params),
                                               state, tok)
        args = (p_shapes, S.decode_state_specs(arch, shape_name),
                S.decode_tok_specs(arch, shape_name))
    return MeshStep(kind=kind, batch=B, fn=fn, args=args,
                    param_specs=p_specs, mesh=mesh, cfg=cfg,
                    mapping=mapping)


def build_prefill_step(arch: ArchSpec, shape_name: str, mesh=None):
    """Returns ``(prefill, batch_shapes)``: ``prefill(params, batch)`` gives
    the last position's logits (B, 1, V), and ``batch_shapes`` is
    ``{"tokens": ShapeDtype((B, S), torch.int32)}``, with a vlm's
    ``patch_embeds`` or the audio family's ``frames``
    (``specs.prefill_batch_specs``).  With a (data, model) ``mesh``: the
    :class:`MeshStep` of the dense family."""
    _check_kind(shape_name, "prefill")
    if mesh is not None:
        return _mesh_program(arch, shape_name, mesh, "prefill")
    api = get_model_api(arch.model_for_shape(shape_name))
    return api.prefill, S.prefill_batch_specs(arch, shape_name)


def build_decode_step(arch: ArchSpec, shape_name: str, mesh=None):
    """Returns ``(decode_step, state_shapes, tok_shape)`` at a decode
    shape: ``decode_step(params, state, tok)`` -> (logits (B, 1, V),
    state), the model's ``decode_step`` for ``arch.model_for_shape``
    (at ``long_500k`` a ``swa_variant`` arch's attention is a ring of
    ``long_context_window`` slots); the state's shapes and dtypes
    (``specs.decode_state_specs``, nothing allocated) and the token's,
    (B, 1) int32.  An arch that skips the shape raises ``ValueError``.
    With a (data, model) ``mesh``: the :class:`MeshStep` of the dense
    family."""
    _check_kind(shape_name, "decode")
    if mesh is not None:
        S.decode_tok_specs(arch, shape_name)      # a skipped shape raises
        return _mesh_program(arch, shape_name, mesh, "decode")
    state_shapes = S.decode_state_specs(arch, shape_name)
    api = get_model_api(arch.model_for_shape(shape_name))
    return (api.decode_step, state_shapes,
            S.decode_tok_specs(arch, shape_name))


def build_step(arch: ArchSpec, shape_name: str, mesh=None):
    """Dispatch by the shape's kind: ``build_train_step``,
    ``build_prefill_step`` or ``build_decode_step``."""
    kind = INPUT_SHAPES[shape_name]["kind"]
    if kind == "train":
        return build_train_step(arch, shape_name, mesh)
    if kind == "prefill":
        return build_prefill_step(arch, shape_name, mesh)
    return build_decode_step(arch, shape_name, mesh)
