"""count.busy_frac: the device's busy time (the union of its kernels,
copies and memsets over all streams) inside the traced assemblies'
``count`` spans, over those spans' wall (the trace holds only the
traced assemblies)."""

from harness import trace as tr


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    busy, wall = tr.busy_in(ctx.trace.device,
                            ctx.trace.stages.get("count", []))
    return busy / wall if wall > 0 else None
