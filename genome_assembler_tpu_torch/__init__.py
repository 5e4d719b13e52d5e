"""PyTorch/CUDA port of the de novo genome assembler.

A second package beside ``genome_assembler_tpu`` (the JAX reference, which
stays unchanged). The port runs the single-device main path
(``genome_assembler_tpu.models.pipeline.assemble_tpu``) end to end in
PyTorch: 2-bit-packed reads -> canonical k-mers (a hand-written CUDA
kernel, ``csrc/kmer_extract.cu``) -> sort/segment-reduce counts ->
coverage filter -> unitig compression by pointer doubling -> spelling
reduction -> host simplification and traversal -> contigs.

  * ``utils``  -- explicit device resolution, the int64 key-limb layout,
                  the 2-bit data model (``dna``), ``AssemblyConfig``,
                  ``Metrics`` and ``torch.profiler`` tracing, the upload
                  ring of the streamed counters (``upload``), the read
                  simulator, the native read loader.
  * ``ops``    -- extraction kernel + plain torch version, counting, key
                  word ops, unitig compression, the NumPy extraction
                  oracle (``kmer_ref``).
  * ``host``   -- graph semantics, simplification, traversal, stats and
                  the spelling step (NumPy and pure Python).
  * ``models`` -- the pipeline entry point ``assemble_torch``, the
                  NumPy oracle ``assemble_oracle`` and the acceptance
                  runners (``acceptance``).
  * ``parallel`` -- the mesh of shards, the sharded count and graph.
  * ``cli``, ``verify_reference`` -- the ``ga-torch`` command line and the
                  parity harness against an upstream checkout.

The package imports ``torch`` and never ``jax``, and nothing of
``genome_assembler_tpu``: the framework-free host half of the reference
package (``utils.dna``, ``utils.config``, ``utils.metrics``,
``utils.simulate``, ``utils.io_native``, ``host.*``, ``ops.kmer_ref``,
``models.oracle``) lives here as copies under the same names, held equal
to their originals by ``tests/test_torch_host.py``.
"""

__version__ = "0.1.0"
