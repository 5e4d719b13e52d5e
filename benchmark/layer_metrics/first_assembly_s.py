"""first_assembly_s: the wall seconds of the process's first
``assemble_torch`` call, after CUDA is initialised and the kernel is
loaded, before the window (part of ``setup_s``): the allocator's growth,
the pinned upload slots and the libraries' first calls land here."""


def read(ctx):
    return ctx.first_s
