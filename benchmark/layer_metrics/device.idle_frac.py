"""device.idle_frac: 1 minus the union of the device's kernels, copies
and memsets over each traced assembly's wall, summed over them."""

from harness import trace as tr


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.spans:
        return None
    busy, wall = tr.busy_in(ctx.trace.device, ctx.spans)
    return 1.0 - busy / wall
