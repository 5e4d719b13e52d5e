"""The benchmark's yardstick for ``genome_assembler_tpu_torch``.

Everything here is frozen for later changes of the program: the read
generator, the reading of traces and spans into metrics, the byte count
of the extraction kernel and the card's peaks, the window's arithmetic,
and the check that no module of JAX or of the JAX package is loaded.
"""
