"""The import guard: the port's run must load no JAX.

Module names are compared by their top-level name (the part before the
first dot) as whole strings, so `orbslam3_tpu_torch` (the port) does not
match `orbslam3_tpu` (the JAX package).
"""

from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "orbslam3_tpu")


def banned_modules(names=None) -> list[str]:
    """The loaded modules (default: `sys.modules`) whose top-level name is
    one of BANNED, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)
