"""Central registry of ``fold_in`` stream constants (the KEY_FOLD registry).

The port's copy of ``repro.core.keys``: every derived PRNG stream in the
round path is produced by ``repro_torch.random.fold_in(parent_key,
<constant>)``, and the constants are the JAX package's own, so both
packages derive the same streams from the same key.  The constant names
the stream: two call sites that fold the same constant into the same
parent key deliberately share a stream, and two distinct streams must
never alias.

The registered values are part of the bit-parity contract — changing one
changes every trajectory derived from it.  In particular:

  COMPLETION — must stay ``0x5E1EC7`` so ``completion="always"`` keeps
               reproducing pre-completion trajectories bit-for-bit.
  NONEMPTY   — must stay ``1`` so the all-down fallback tie-break keeps
               matching the committed reference trajectories.

``register_key_fold`` fails fast on a duplicate name *or* a duplicate
value (two names for one integer would silently alias streams).
"""
from __future__ import annotations

from typing import Dict

__all__ = [
    "COMPLETION",
    "KEY_FOLDS",
    "NONEMPTY",
    "get_key_fold",
    "register_key_fold",
]

# name -> fold constant.  Populated only via register_key_fold.
KEY_FOLDS: Dict[str, int] = {}


def register_key_fold(name: str, value: int) -> int:
    """Register a named ``fold_in`` constant and return its value.

    Raises ``ValueError`` if ``name`` is already registered or ``value``
    collides with an existing stream (aliasing two streams onto one
    integer silently correlates their draws).
    """
    if not isinstance(value, int) or isinstance(value, bool):
        raise ValueError(
            f"key fold {name!r} must be an int, got {type(value).__name__}")
    if name in KEY_FOLDS:
        raise ValueError(
            f"duplicate key fold name {name!r} (registered: "
            f"{sorted(KEY_FOLDS)})")
    for other, val in KEY_FOLDS.items():
        if val == value:
            raise ValueError(
                f"key fold {name!r} collides with {other!r} "
                f"(both fold {value:#x}); streams must not alias")
    KEY_FOLDS[name] = value
    return value


def get_key_fold(name: str) -> int:
    """Look up a registered fold constant; fail fast on unknown names."""
    try:
        return KEY_FOLDS[name]
    except KeyError:
        raise KeyError(
            f"unknown key fold {name!r}; registered: "
            f"{sorted(KEY_FOLDS)}") from None


# --- Streams used by the round path -----------------------------------
# Engines derive the per-round completion / arrival key as
# fold_in(k_sel, COMPLETION): a side stream off the selection key that
# consumes nothing from the main split, keeping completion="always"
# bit-identical to pre-completion runs.
COMPLETION = register_key_fold("completion", 0x5E1EC7)

# Availability processes derive the all-down fallback tie-break key as
# fold_in(step_key, NONEMPTY): the common non-empty path consumes
# nothing, so the fallback never perturbs the main availability stream.
NONEMPTY = register_key_fold("nonempty", 1)
