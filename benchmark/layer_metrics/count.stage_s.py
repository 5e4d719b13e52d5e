"""count.stage_s: the port's ``count`` span (``models/pipeline.py::
timed_stage``, closed by a sync of every stream), the mean over the
window's assemblies, in seconds."""

import statistics


def read(ctx):
    spans = [st["count"] for st in ctx.stages if "count" in st]
    return statistics.fmean(spans) if spans else None
