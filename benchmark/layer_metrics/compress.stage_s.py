"""compress.stage_s: the port's ``compress`` span (``ops/unitig_torch.py``),
the mean over the window's assemblies, in seconds."""

import statistics


def read(ctx):
    spans = [st["compress"] for st in ctx.stages if "compress" in st]
    return statistics.fmean(spans) if spans else None
