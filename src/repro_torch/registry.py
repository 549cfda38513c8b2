"""Registry lookups shared by the port's string-keyed registries."""
from __future__ import annotations

from typing import Container, Mapping


def lookup(kind: str, name: str, registry: Mapping,
           deferred: Container = (), item: int = 0) -> str:
    """The registry key for ``name``.  A name the JAX package has but this
    port does not yet raises ``NotImplementedError`` naming its ROADMAP.md
    queue 1 item; an unknown name raises ``KeyError`` listing the known."""
    key = str(name).lower()
    if key in registry:
        return key
    if key in deferred:
        raise NotImplementedError(
            f"{kind} {name!r} is not ported to repro_torch yet (ROADMAP.md "
            f"queue 1 item {item}); ported: {sorted(registry)}")
    raise KeyError(f"unknown {kind} {name!r}; known: {sorted(registry)}")
