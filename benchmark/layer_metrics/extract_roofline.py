"""extract_roofline: the extraction kernel's share of its roofline, in
percent: the least time its work takes on the card (the benchmark's own
byte count, ``harness/roofline.py``, of every read of each traced
assembly) over the device time of the kernels named
``extract_canonical_kernel`` in those assemblies."""

from harness import roofline
from harness import trace as tr


def read(ctx):
    if ctx.trace is None or not ctx.spans:
        return None
    busy_us = tr.device_time(ctx.trace.device, ctx.spans,
                             match=roofline.EXTRACT_KERNEL)
    if busy_us <= 0:
        return None
    bound_s = len(ctx.spans) * roofline.extract_bound_s(
        ctx.reads, ctx.read_len, ctx.k)
    return 100.0 * bound_s / (busy_us / 1e6)
