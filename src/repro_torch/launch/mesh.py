"""The client mesh of the sharded engine over ``torch.distributed`` (port
of ``repro.launch.mesh``'s ``make_client_mesh`` and ``make_fed_mesh``).

JAX runs one process over a ``shard_map``; the port runs one process a
shard, each with the same round body, and a :class:`ClientMesh` carries
what a shard needs to know of the others: its rank (``axis_index``), the
mesh size, the axis name and the process group.  Its three collectives are
the ones the engine's round is made of:

* :meth:`ClientMesh.all_reduce` — ``psum`` (a sum over ranks);
* :meth:`ClientMesh.all_gather` — ``all_gather(tiled=True)`` (the ranks'
  blocks concatenated in rank order);
* :meth:`ClientMesh.exchange` — ``ppermute`` (a paired ``send``/``recv``
  through ``batch_isend_irecv``).

A mesh of one shard needs no process group: every collective is the
identity.  :func:`spawn_ranks` starts the ranks of a mesh on this host
(``torch.multiprocessing``, start method ``spawn``), each with its own
process group, and returns what each rank's function returned.

Only the 1-D ``(c,)`` mesh is ported: the ``(clients, model)`` mesh and
the production meshes are ROADMAP.md queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

__all__ = ["ClientMesh", "make_client_mesh", "make_fed_mesh",
           "spawn_ranks"]


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """A 1-D ``(clients,)`` mesh: this process's ``rank`` of ``size``
    shards over the process ``group`` (the default group; None for one
    shard), whose ``backend`` is ``"gloo"`` or ``"nccl"``."""

    rank: int = 0
    size: int = 1
    axis: str = "clients"
    group: Any = None
    backend: Optional[str] = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``psum``: the elementwise sum of ``t`` over the ranks, the same
        on every rank."""
        if self.size == 1:
            return t
        buf = t.clone()
        dist.all_reduce(buf, group=self.group)
        return buf

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``all_gather(tiled=True)``: the ranks' ``t`` concatenated along
        dim 0 in rank order."""
        if self.size == 1:
            return t
        if t.dtype == torch.bool:          # gathered as bytes
            return self.all_gather(t.to(torch.uint8)).to(torch.bool)
        src = t.contiguous()
        bufs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(bufs, src, group=self.group)
        return torch.cat(bufs)

    def exchange(self, t: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """One step of ``ppermute``: send ``t`` to shard ``dst`` and
        receive a tensor of its shape and dtype from shard ``src``."""
        if self.size == 1:
            return t
        # gloo's point-to-point ops take host tensors only (its
        # all_reduce and all_gather take CUDA tensors): the (score, id)
        # candidates (<= k_max of them) are copied to the host for the
        # exchange and back after it
        host = self.backend == "gloo" and t.is_cuda
        out = t.cpu() if host else t.contiguous()
        buf = torch.empty_like(out)
        ops = [dist.P2POp(dist.isend, out, dst, self.group),
               dist.P2POp(dist.irecv, buf, src, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return buf.to(t.device) if host else buf


def make_client_mesh(num_shards: Optional[int] = None, *,
                     axis_name: str = "clients") -> ClientMesh:
    """The 1-D mesh over the default process group (no group at all for
    one shard).  ``num_shards`` (None or <= 0: the group's size) must
    equal the group's size: each process is one shard."""
    if not dist.is_available() or not dist.is_initialized():
        if num_shards not in (None, 0, 1) and (num_shards or 0) > 0:
            raise RuntimeError(
                f"a client mesh of {num_shards} shards needs an initialized "
                f"torch.distributed process group of {num_shards} ranks "
                f"(run_spec launches them itself when none is initialized)")
        return ClientMesh(axis=axis_name)
    group = dist.group.WORLD
    size = dist.get_world_size(group)
    if num_shards is not None and num_shards > 0 and num_shards != size:
        raise ValueError(f"mesh of {num_shards} shards over a process group "
                         f"of {size} ranks: one rank a shard")
    return ClientMesh(rank=dist.get_rank(group), size=size, axis=axis_name,
                      group=group, backend=dist.get_backend(group))


def make_fed_mesh(mesh_shape, *,
                  axis_names=("clients", "model")) -> ClientMesh:
    """``(c,)`` → :func:`make_client_mesh` (0: the group's size).  A 2-D
    ``(c, m)`` mesh raises ``NotImplementedError``."""
    shape = tuple(int(s) for s in mesh_shape)
    if len(shape) == 2:
        raise NotImplementedError(
            f"mesh_shape {shape}: the (clients, model) mesh is not ported "
            f"to repro_torch yet (ROADMAP.md queue 1 item 11); use a 1-D "
            f"mesh_shape (c,)")
    if len(shape) != 1 or shape[0] < 0:
        raise ValueError(f"mesh_shape must be (c,) with c >= 0, got "
                         f"{mesh_shape!r}")
    return make_client_mesh(shape[0], axis_name=axis_names[0])


# ---------------------------------------------------------------------------
# Launching the ranks of a mesh on this host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, size: int, init_method: str, backend: str,
               threads: int, fn: Callable, args: tuple, results) -> None:
    """One spawned rank: join the group, run ``fn(mesh, *args)``, report
    ``(rank, ok, value or traceback)``."""
    try:
        torch.set_num_threads(threads)
        if backend == "nccl":          # one card a rank
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=size, rank=rank)
        try:
            value = fn(make_client_mesh(size), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:          # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, size: int, *args, backend: str = "gloo",
                threads: Optional[int] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``size`` spawned processes, one a shard
    of a ``(size,)`` :class:`ClientMesh` over a new process group
    (``backend``; its store a file in a fresh temporary directory), and
    return the ranks' values in rank order.  ``fn`` and ``args`` must
    pickle (a module-level function).  ``threads`` is each rank's
    intra-op thread count (default: this process's share).  A rank that
    fails fails the call with its traceback, after every rank is
    stopped."""
    if threads is None:
        threads = max(1, torch.get_num_threads() // size)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, size, init, backend, threads, fn, args,
                                   results), daemon=True)
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
