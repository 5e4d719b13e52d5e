"""device.peak_gib: ``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``, the highest over the window's assemblies,
in GiB (2^30 bytes)."""


def read(ctx):
    return max(ctx.peaks) / float(1 << 30) if ctx.peaks else None
