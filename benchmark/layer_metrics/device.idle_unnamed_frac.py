"""device.idle_unnamed_frac: the share of the device's idle time inside
the traced assemblies (as ``device.idle_frac`` reads it) that no span of
the program names: idle whose innermost host span is the assembly's own
(between stages) or ``count`` itself (outside every span inside it).
Without device work in the trace the whole wall is idle."""

from harness import runner
from harness import spans as sp

UNNAMED = (runner.ASSEMBLY_SPAN, "count", None)


def read(ctx):
    if ctx.trace is None or not ctx.spans:
        return None
    idle = sp.idle_by_span(ctx.trace, ctx.spans)
    total = sum(idle.values())
    if total <= 0:
        return 0.0
    return sum(idle.get(name, 0.0) for name in UNNAMED) / total
