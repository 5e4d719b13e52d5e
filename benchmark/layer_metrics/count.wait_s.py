"""count.wait_s: the host blocked on the card inside ``count``: the
upload ring's waits for a copy (``count.wait``) and the stage's closing
synchronise (``count.sync``), seconds per traced assembly."""

from harness import spans as sp


def read(ctx):
    if ctx.trace is None or not ctx.spans:
        return None
    return sp.seconds_in(ctx.trace, ("count.wait", "count.sync"), ctx.spans)
