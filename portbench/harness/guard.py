"""The import guard: no module of JAX, or of the JAX package beside the
port, may be loaded in a run.

Names are compared by their top-level part (before the first dot),
whole: the port's package ``repro_torch`` begins with the JAX package's
name ``repro`` and passes.
"""

from __future__ import annotations

from typing import Iterable, List

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The names among ``names`` (module names, as ``sys.modules`` keys)
    whose top-level part is forbidden, sorted."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
