"""The meshes of the sharded engine over ``torch.distributed`` (port of
``repro.launch.mesh``'s ``make_client_mesh`` and ``make_fed_mesh``).

JAX runs one process over a ``shard_map``; the port runs one process a
rank, each with the same round body.  A :class:`ClientMesh` is one mesh
axis as a rank sees it: its index on the axis (``axis_index``), the
axis' size and name, and the axis' process group.  Its three collectives
are the ones the engine's round is made of:

* :meth:`ClientMesh.all_reduce` — ``psum`` (a sum over the axis);
* :meth:`ClientMesh.all_gather` — ``all_gather(tiled=True)`` (the axis'
  blocks concatenated in axis order, along any dim);
* :meth:`ClientMesh.exchange` — ``ppermute`` (a paired ``send``/``recv``
  through ``batch_isend_irecv``; the peers are axis indices, mapped to
  their global ranks).

A 1-D ``(c,)`` mesh is the :class:`ClientMesh` of its one axis over the
default group.  A 2-D ``(c, m)`` mesh is a :class:`FedMesh`: c × m ranks
laid out row-major as JAX's ``_grid_mesh`` lays its devices out (global
rank = client index × m + model index), with a ``ClientMesh`` for each
axis (:meth:`FedMesh.axis_mesh`): the clients axis over the c ranks that
share a model index, the model axis over the m ranks that share a client
index.  An axis of one rank needs no process group (every collective is
the identity); an axis over every rank takes the default group.  The
others are ``dist.new_group`` groups, which every rank creates, all of
them in the same order.  ``torch.distributed.device_mesh`` is not used:
it binds each rank to a card of its own, and the gloo ranks of a mesh on
one card share it.

:func:`spawn_ranks` starts the ranks of a mesh on this host
(``torch.multiprocessing``, start method ``spawn``), each with its own
process group, and returns what each rank's function returned.

The serving programs' meshes are :class:`FedMesh` es too, over axes named
``("data", "model")`` or ``("pod", "data", "model")``
(``make_fed_mesh(shape, axis_names=)``, :func:`make_debug_mesh`,
:func:`make_production_mesh`); a mesh of three or more axes also holds
one group over its leading axes together (:meth:`FedMesh.axes_mesh` of
``("pod", "data")``), which the batch's split spans.  :func:`data_axes`
names the axes that carry the batch.
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import tempfile
import traceback
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ClientMesh", "FedMesh", "make_client_mesh", "make_fed_mesh",
           "make_production_mesh", "make_debug_mesh", "data_axes",
           "spawn_ranks"]

@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """One mesh axis as this process sees it: its index ``rank`` of the
    axis' ``size`` ranks, named ``axis``, over the process ``group``
    (None for one rank), whose ``backend`` is ``"gloo"`` or ``"nccl"``.
    ``ranks`` are the axis' members' global ranks in axis order (None: the
    default group, whose index is the global rank)."""

    rank: int = 0
    size: int = 1
    axis: str = "clients"
    group: Any = None
    backend: Optional[str] = None
    ranks: Optional[tuple] = None

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return {self.axis: self.size}

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    def axis_mesh(self, name: str) -> "ClientMesh":
        """The mesh's axis ``name``: this mesh itself."""
        if name != self.axis:
            raise ValueError(f"mesh {self.axis_names} has no {name!r} axis")
        return self

    def axes_mesh(self, names) -> "ClientMesh":
        """The axes ``names`` together (a name, or a tuple of names):
        this mesh itself, when they are its axis."""
        names = (names,) if isinstance(names, str) else tuple(names)
        if names not in ((self.axis,), self.axis):
            raise ValueError(f"mesh {self.axis_names} has no axes {names!r}")
        return self

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``psum``: the elementwise sum of ``t`` over the axis, the same
        on every rank of it."""
        if self.size == 1:
            return t
        buf = t.clone()
        dist.all_reduce(buf, group=self.group)
        return buf

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``all_gather(tiled=True)``: the axis' ``t`` concatenated along
        ``dim`` in axis order."""
        if self.size == 1:
            return t
        if t.dtype == torch.bool:          # gathered as bytes
            return self.all_gather(t.to(torch.uint8), dim).to(torch.bool)
        src = t.contiguous()
        bufs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(bufs, src, group=self.group)
        return torch.cat(bufs, dim=dim)

    def exchange(self, t: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """One step of ``ppermute``: send ``t`` to the axis' index ``dst``
        and receive a tensor of its shape and dtype from index ``src``."""
        if self.size == 1:
            return t
        # gloo's point-to-point ops take host tensors only (its
        # all_reduce and all_gather take CUDA tensors): the (score, id)
        # candidates (<= k_max of them) are copied to the host for the
        # exchange and back after it
        host = self.backend == "gloo" and t.is_cuda
        out = t.cpu() if host else t.contiguous()
        buf = torch.empty_like(out)
        # a P2POp's peer is a global rank, also in a group of a few ranks
        to, frm = ((dst, src) if self.ranks is None
                   else (self.ranks[dst], self.ranks[src]))
        ops = [dist.P2POp(dist.isend, out, to, self.group),
               dist.P2POp(dist.irecv, buf, frm, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return buf.to(t.device) if host else buf


@dataclasses.dataclass(frozen=True)
class FedMesh:
    """A mesh of two or more axes as this process sees it: its global
    ``rank`` of ``size``, one :class:`ClientMesh` an axis (``axes``, in
    the mesh's order) and, with three or more axes, one over the leading
    axes together (``merged``: its ``axis`` the tuple of their names, its
    index theirs in row-major order)."""

    axes: tuple
    rank: int = 0
    backend: Optional[str] = None
    merged: tuple = ()

    @property
    def size(self) -> int:
        return math.prod(a.size for a in self.axes)

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return {a.axis: a.size for a in self.axes}

    @property
    def axis_names(self) -> tuple:
        return tuple(a.axis for a in self.axes)

    def axis_mesh(self, name: str) -> ClientMesh:
        """The :class:`ClientMesh` of axis ``name``: this rank's index on
        it and its collectives."""
        for a in self.axes:
            if a.axis == name:
                return a
        raise ValueError(f"mesh {self.axis_names} has no {name!r} axis")

    def axes_mesh(self, names) -> ClientMesh:
        """The :class:`ClientMesh` over the axes ``names`` together (a
        name, or a tuple of names in mesh order): one axis' own, or the
        leading axes' merged one."""
        names = (names,) if isinstance(names, str) else tuple(names)
        if len(names) == 1:
            return self.axis_mesh(names[0])
        for a in self.merged:
            if a.axis == names:
                return a
        raise ValueError(f"mesh {self.axis_names} has no group over the "
                         f"axes {names!r} together")


def _validate_axis_names(axis_names) -> tuple:
    names = tuple(axis_names)
    if not all(isinstance(a, str) and a for a in names):
        raise ValueError(f"mesh axis names must be non-empty strings: "
                         f"{names!r}")
    if len(set(names)) != len(names):
        raise ValueError(f"mesh axis names collide: {names!r}")
    return names


def _group_size() -> Optional[int]:
    """The default group's size, None when no group is initialized."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    return dist.get_world_size(dist.group.WORLD)


def make_client_mesh(num_shards: Optional[int] = None, *,
                     axis_name: str = "clients") -> ClientMesh:
    """The 1-D mesh over the default process group (no group at all for
    one shard).  ``num_shards`` (None or <= 0: the group's size) must
    equal the group's size: each process is one shard."""
    size = _group_size()
    if size is None:
        if num_shards not in (None, 0, 1) and (num_shards or 0) > 0:
            raise RuntimeError(
                f"a client mesh of {num_shards} shards needs an initialized "
                f"torch.distributed process group of {num_shards} ranks "
                f"(run_spec launches them itself when none is initialized)")
        return ClientMesh(axis=axis_name)
    group = dist.group.WORLD
    if num_shards is not None and num_shards > 0 and num_shards != size:
        raise ValueError(f"mesh of {num_shards} shards over a process group "
                         f"of {size} ranks: one rank a shard")
    return ClientMesh(rank=dist.get_rank(group), size=size, axis=axis_name,
                      group=group, backend=dist.get_backend(group))


def _axis(index: int, members_by_line: list, line: int, name,
          world: int, backend) -> ClientMesh:
    """This rank's ClientMesh on one axis, whose groups are one a line of
    the grid (``members_by_line``, global ranks in axis order).  Every
    rank calls this for every axis in the same order: ``dist.new_group``
    is collective over the default group."""
    size = len(members_by_line[0])
    if size == 1:
        return ClientMesh(axis=name)
    if size == world:
        return ClientMesh(rank=index, size=size, axis=name,
                          group=dist.group.WORLD, backend=backend)
    groups = [dist.new_group(list(m)) for m in members_by_line]
    return ClientMesh(rank=index, size=size, axis=name, group=groups[line],
                      backend=backend, ranks=tuple(members_by_line[line]))


def _lines(shape: tuple, dims: tuple, rank: int):
    """The lines of the row-major grid ``shape`` along ``dims`` (the
    ranks that share every other coordinate, in the order of those
    coordinates), this rank's line and its index on it (row-major over
    ``dims``)."""
    rest = [k for k in range(len(shape)) if k not in dims]
    lines = np.arange(math.prod(shape)).reshape(shape).transpose(
        rest + list(dims)).reshape(-1, math.prod(shape[k] for k in dims))
    mine, index = (int(i) for i in np.argwhere(lines == rank)[0])
    return lines.tolist(), mine, index


def _grid_mesh(shape: tuple, names: tuple) -> FedMesh:
    """The :class:`FedMesh` of ``shape`` over the default group (its size
    must be the product; with no group initialized, a mesh of one rank),
    its ranks laid out row-major as JAX's ``_grid_mesh`` lays its
    devices out; with three or more axes also the group of the leading
    axes together."""
    total = math.prod(shape)
    world = _group_size()
    if world is None:
        if total != 1:
            raise RuntimeError(
                f"a mesh of shape {shape} needs an initialized "
                f"torch.distributed process group of {total} ranks "
                f"(run_spec launches them itself when none is "
                f"initialized)")
        return FedMesh(axes=tuple(ClientMesh(axis=n) for n in names))
    if total != world:
        raise ValueError(f"mesh of shape {shape} ({total} ranks) over a "
                         f"process group of {world} ranks: one rank a "
                         f"mesh position")
    rank = dist.get_rank(dist.group.WORLD)
    backend = dist.get_backend(dist.group.WORLD)
    axes = []
    for k, name in enumerate(names):
        lines, line, index = _lines(shape, (k,), rank)
        axes.append(_axis(index, lines, line, name, world, backend))
    merged = ()
    if len(shape) >= 3:
        lead = tuple(range(len(shape) - 1))
        lines, line, index = _lines(shape, lead, rank)
        merged = (_axis(index, lines, line, tuple(names[:-1]), world,
                        backend),)
    return FedMesh(axes=tuple(axes), rank=rank, backend=backend,
                   merged=merged)


def make_fed_mesh(mesh_shape, *, axis_names=("clients", "model")):
    """``(c,)`` → :func:`make_client_mesh` (0: the group's size);
    ``(c, m)`` → the :class:`FedMesh` of c × m ranks, row-major, over the
    default group (its size must be c × m; at most one entry may be 0,
    meaning the group's size divided by the other).  With no group
    initialized only a mesh of one rank can be made.  The serving
    programs' (data, model) mesh is ``make_fed_mesh((d, m),
    axis_names=("data", "model"))``."""
    shape = tuple(int(s) for s in mesh_shape)
    if len(shape) not in (1, 2) or any(s < 0 for s in shape):
        raise ValueError(f"mesh_shape must be 1 or 2 non-negative ints, "
                         f"got {mesh_shape!r}")
    names = _validate_axis_names(axis_names)[:len(shape)]
    if len(shape) == 1:
        return make_client_mesh(shape[0], axis_name=names[0])
    if len(names) != 2:
        raise ValueError(f"mesh shape {shape} has 2 dims but "
                         f"{len(names)} axis names: {names!r}")
    if shape.count(0) > 1:
        raise ValueError(f"at most one mesh_shape entry may be 0 (= fill "
                         f"with the group's ranks), got {mesh_shape!r}")
    if 0 in shape:
        world = _group_size()
        fill = (world or 1) // max(shape)
        if fill < 1:
            raise ValueError(f"mesh_shape {mesh_shape!r} cannot be filled: "
                             f"the group has {world or 1} ranks")
        shape = tuple(s if s else fill for s in shape)
    return _grid_mesh(shape, names)


def _sized_mesh(shape: tuple, names: tuple) -> FedMesh:
    """JAX's ``_grid_mesh`` of a fixed shape: ``ValueError`` naming the
    ranks it needs when the group (one process without one) has fewer."""
    total = math.prod(shape)
    world = _group_size() or 1
    if total > world:
        raise ValueError(f"mesh shape {shape} needs {total} ranks but the "
                         f"process group has {world} (launch {total} "
                         f"ranks, as spawn_ranks or torchrun do)")
    return _grid_mesh(shape, names)


def make_production_mesh(*, multi_pod: bool = False) -> FedMesh:
    """The production mesh: (16, 16) over ("data", "model"), or with
    ``multi_pod`` (2, 16, 16) over ("pod", "data", "model"), over a
    process group of 256 or 512 ranks."""
    if multi_pod:
        return _sized_mesh((2, 16, 16), ("pod", "data", "model"))
    return _sized_mesh((16, 16), ("data", "model"))


def make_debug_mesh() -> FedMesh:
    """The (n, 1) ("data", "model") mesh over the group's n ranks (one
    rank without a group)."""
    return _grid_mesh((_group_size() or 1, 1), ("data", "model"))


def data_axes(mesh) -> tuple:
    """The axes carrying the batch and FSDP splits, in mesh order
    ("pod" folds into data)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


# ---------------------------------------------------------------------------
# Launching the ranks of a mesh on this host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, size: int, init_method: str, backend: str,
               threads: int, fn: Callable, inputs, results,
               mesh_shape=None, axis_names=("clients", "model")) -> None:
    """One spawned rank: take ``args`` from ``inputs``, join the group, run
    ``fn(mesh, *args)``, report ``(rank, ok, value or traceback)``."""
    try:
        args = inputs.get()
        torch.set_num_threads(threads)
        if backend == "nccl":          # one card a rank
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=size, rank=rank)
        try:
            mesh = (make_client_mesh(size) if mesh_shape is None else
                    make_fed_mesh(mesh_shape, axis_names=axis_names))
            value = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:          # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, size: int, *args, backend: str = "gloo",
                threads: Optional[int] = None, mesh_shape=None,
                axis_names=("clients", "model")) -> list:
    """Run ``fn(mesh, *args)`` in ``size`` spawned processes, one a shard
    of a ``(size,)`` :class:`ClientMesh` over a new process group
    (``backend``; its store a file in a fresh temporary directory), and
    return the ranks' values in rank order.  With ``mesh_shape`` (c × m
    = ``size``) the mesh is ``make_fed_mesh(mesh_shape, axis_names=)``.
    ``fn`` and ``args`` must pickle (a module-level function).
    ``threads`` is each rank's intra-op thread count (default: this
    process's share).  A rank that
    fails fails the call with its traceback, after every rank is
    stopped."""
    if threads is None:
        threads = max(1, torch.get_num_threads() // size)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    # the arguments go through a queue, not the process objects: a start
    # writes its process object to a pipe the child reads only once it
    # has imported its modules, so large arguments there would start the
    # ranks one after another
    inputs = ctx.Queue()
    for _ in range(size):
        inputs.put(args)
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, size, init, backend, threads, fn,
                                   inputs, results, mesh_shape, axis_names),
                             daemon=True)
                 for r in range(size)]
        for p in procs:
            p.start()
        values, failure = [None] * size, None
        try:
            pending = set(range(size))
            while pending and failure is None:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r in pending
                            if procs[r].exitcode not in (None, 0)]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    continue
                pending.discard(rank)
                if ok:
                    values[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join()
    if failure is not None:
        raise RuntimeError(f"spawn_ranks: {failure}")
    return values
