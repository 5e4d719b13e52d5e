"""reads.scan_s: the host's scans of the reads for ambiguous bases, the
``scan`` span (``assemble_torch``, before ``count``) and ``count.scan``
(``count_reads_device``'s own), seconds per traced assembly."""

from harness import spans as sp


def read(ctx):
    if ctx.trace is None or not ctx.spans:
        return None
    return sp.seconds_in(ctx.trace, ("scan", "count.scan"), ctx.spans)
