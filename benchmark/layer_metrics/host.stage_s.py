"""host.stage_s: the port's ``simplify`` plus ``traverse`` spans
(``host/simplify_arrays.py``, ``host/traverse.py``), the mean over the
window's assemblies, in seconds."""

import statistics


def read(ctx):
    spans = [st["simplify"] + st["traverse"] for st in ctx.stages
             if "simplify" in st and "traverse" in st]
    return statistics.fmean(spans) if spans else None
