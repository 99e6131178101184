"""The import guard: which loaded modules belong to JAX or the JAX
package.  A module matches when its top-level name (the part before the
first dot) is one of ``FORBIDDEN`` as a whole, so ``repro_torch`` passes
and ``repro.config`` does not."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
