"""The framework-free pieces the port is checked against.

One place that names what the port's on-card checks use to test it: the
seeded genome and read simulator, the NumPy oracle assembler, contig
comparison and the 2-bit packers. All are the port's own modules (copies
of the reference package's, held equal to them by
``tests/test_torch_host.py``), so they run on a machine that has only
PyTorch.
"""

from .host.traverse import contigs_equal
from .models.oracle import assemble_oracle
from .utils.config import AssemblyConfig
from .utils.dna import decode_seq, pack_codes, pack_invalid_mask
from .utils.simulate import simulate_genome, simulate_reads

__all__ = [
    "AssemblyConfig",
    "assemble_oracle",
    "contigs_equal",
    "decode_seq",
    "pack_codes",
    "pack_invalid_mask",
    "simulate_genome",
    "simulate_reads",
]
