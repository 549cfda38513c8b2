"""Logical-axis hooks of the serving programs over a mesh (port of
``repro.sharding.hooks``).

JAX's model code calls ``constrain(x, ("batch", None, "tensor"))`` at key
intermediates and XLA lays the tensor out over the mesh; the launcher
configures the logical -> mesh-axis mapping first.  The port runs each
rank's blocks with explicit collectives instead (``launch.steps``), so
here the mapping is what the layers consult to choose their compute
layout: :func:`axis_for` gives the mesh axis a logical axis maps to, as
this rank sees it (its ``launch.mesh.ClientMesh``: index, size, group),
or None, with JAX's divisibility gate.  :func:`constrain` keeps JAX's
signature and is the identity (the rank's tensor already is its block).

Unconfigured (one card, the tests) every query answers None.  The mapping
holds for the calls made inside :func:`configured` and between
:func:`configure` and :func:`clear`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple, Union

from .rules import _axis_size

Axes = Union[str, Tuple[str, ...], None]

__all__ = ["configure", "clear", "configured", "current_mesh", "constrain",
           "axis_for"]

_STATE: Dict[str, object] = {"mesh": None, "axes": {}}


def configure(mesh, mapping: Dict[str, Axes]) -> None:
    """Set the logical -> mesh-axis mapping of the calls that follow."""
    _STATE["mesh"] = mesh
    _STATE["axes"] = dict(mapping)


def clear() -> None:
    configure(None, {})


@contextlib.contextmanager
def configured(mesh, mapping: Dict[str, Axes]):
    """The mapping for the body's calls; the previous one after it."""
    before = (_STATE["mesh"], _STATE["axes"])
    configure(mesh, mapping)
    try:
        yield
    finally:
        configure(*before)


def current_mesh():
    return _STATE["mesh"]


def constrain(x, logical: Sequence[Optional[str]]):
    """JAX's layout pin.  The identity: the rank's tensor is its block,
    and the layers chose that layout through :func:`axis_for`."""
    return x


def axis_for(name: str, dim: Optional[int] = None):
    """The ``ClientMesh`` of the mesh axis (or the leading axes together)
    that logical axis ``name`` maps to, as this rank sees it; None when
    unconfigured, unmapped, of size 1, or when ``dim`` is given and the
    axis' size does not divide it (JAX's divisibility gate)."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    ax = _STATE["axes"].get(name)
    if ax is None:
        return None
    size = _axis_size(mesh, ax)
    if size == 1 or (dim is not None and dim % size):
        return None
    return mesh.axes_mesh(ax)
