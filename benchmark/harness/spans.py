"""The program's host spans inside the traced assemblies: their seconds
by name, and the device's idle time by the innermost span over it.

Spans are the ``record_function`` ranges of the trace (``Trace.stages``),
on the clock of the device's intervals; times in microseconds.
"""

from __future__ import annotations

from . import trace as tr


def seconds_in(trace: tr.Trace, names, spans) -> float | None:
    """Seconds of the host spans named ``names`` that start inside
    ``spans`` (the traced assemblies), cut to them, per assembly; None
    where there is none."""
    total, seen = 0.0, False
    for name in names:
        for a, b in trace.stages.get(name, []):
            for lo, hi in spans:
                if lo <= a < hi:
                    total += min(b, hi) - a
                    seen = True
    return total / 1e6 / len(spans) if seen else None


def idle_by_span(trace: tr.Trace, spans) -> dict:
    """Microseconds of the device's idle time inside ``spans`` (the gaps
    of ``busy_and_gaps``, as the idle share reads them), by the name of
    the innermost (shortest) host span that covers each stretch; None
    for a stretch that no span covers."""
    host = [(a, b, name) for name, ss in trace.stages.items()
            for a, b in ss]
    out: dict = {}
    for lo, hi in spans:
        inside = [(a, b, n) for a, b, n in host if a < hi and b > lo]
        cuts = sorted({lo, hi} | {t for a, b, _ in inside for t in (a, b)
                                  if lo < t < hi})
        # the stretches between two consecutive span boundaries, each
        # with its innermost span
        segs = []
        for x, y in zip(cuts, cuts[1:]):
            cover = [(b - a, n) for a, b, n in inside if a <= x and y <= b]
            segs.append((x, y, min(cover)[1] if cover else None))
        j = 0
        for g0, g1 in tr.busy_and_gaps(trace.device, lo, hi)[1]:
            while segs[j][1] <= g0:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < g1:
                x, y, name = segs[k]
                out[name] = out.get(name, 0.0) + min(y, g1) - max(x, g0)
                k += 1
    return out
