"""spell.stage_s: the port's ``spell`` span (``host/dbg.py::
spell_device_arrays``), the mean over the window's assemblies, in
seconds."""

import statistics


def read(ctx):
    spans = [st["spell"] for st in ctx.stages if "spell" in st]
    return statistics.fmean(spans) if spans else None
