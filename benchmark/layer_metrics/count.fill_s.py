"""count.fill_s: the host copying each batch of reads into the upload
ring's pinned slot, the ``count.fill`` spans, seconds per traced
assembly."""

from harness import spans as sp


def read(ctx):
    if ctx.trace is None or not ctx.spans:
        return None
    return sp.seconds_in(ctx.trace, ("count.fill",), ctx.spans)
