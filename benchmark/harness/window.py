"""The window's arithmetic: one rate over all its work and all its time,
and a tail over every assembly in it."""

from __future__ import annotations

import math


def mean_wall(starts: list[float], ends: list[float]) -> float:
    """Seconds an assembly over the whole window: from the start of its
    first assembly to the end of its last, over the assemblies it
    completed (stalls and the gaps between calls included)."""
    if not starts or len(starts) != len(ends):
        raise ValueError("a window needs one end for each of its starts")
    return (ends[-1] - starts[0]) / len(starts)


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100 * len(ordered))) - 1]
