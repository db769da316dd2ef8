"""The check that no JAX module was loaded in the process that prints a result."""

from __future__ import annotations

from typing import Iterable, List

# compared whole against the part of a module's name before its first dot:
# the port, scail_tpu_torch, begins with the JAX package's name and is no match
FORBIDDEN = ("jax", "jaxlib", "flax", "scail_tpu")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The names among `names` (such as sys.modules) whose top-level package
    is one of FORBIDDEN."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
