"""The run's check that neither JAX nor the JAX package was loaded.

A module counts by its whole top-level name, the part before the first
dot: the port, ``genome_assembler_tpu_torch``, begins with the JAX
package's name and is not a match.
"""

from __future__ import annotations

from collections.abc import Iterable

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "genome_assembler_tpu"})


def forbidden_modules(names: Iterable[str]) -> list[str]:
    """The names among ``names`` (as in ``sys.modules``) whose top-level
    name is one of FORBIDDEN, sorted."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
