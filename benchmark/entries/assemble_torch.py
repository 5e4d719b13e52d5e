"""The window's call: ``genome_assembler_tpu_torch.models.pipeline.
assemble_torch``, the port's single-device entry point that ``ga-torch
assemble`` calls, from the reads as a host uint8 array to the contigs as
host strings, with the graph they came from (``return_graph=True``, as
``ga-torch assemble`` asks for it).

The configuration gives ``AssemblyConfig``'s fields under ``assembly``
and the ``table_capacity``; everything else is the program's default.
"""

from __future__ import annotations

import torch


class Entry:
    """One assembler on one device; a call is one whole assembly."""

    def __init__(self, config: dict, read_len: int, device):
        from genome_assembler_tpu_torch.models.pipeline import assemble_torch
        from genome_assembler_tpu_torch.utils.config import AssemblyConfig
        from genome_assembler_tpu_torch.utils.metrics import Metrics

        self._assemble = assemble_torch
        self._metrics = Metrics
        self.device = torch.device(device)
        self.cfg = AssemblyConfig(read_len=read_len, **config["assembly"])
        self.capacity = config.get("table_capacity")

    def load_kernels(self) -> None:
        """Build (first run in a checkout) or load the extraction kernel."""
        if self.device.type == "cuda":
            from genome_assembler_tpu_torch.ops._build import kmer_extract_fn

            kmer_extract_fn()

    def __call__(self, reads):
        """One assembly with a fresh ``Metrics``: ((contigs, unitig rows),
        the stage spans in seconds). A unitig row is (sequence, edges,
        cov_sum)."""
        m = self._metrics()
        contigs, graph = self._assemble(
            reads, self.cfg, device=self.device,
            table_capacity=self.capacity, metrics=m, return_graph=True,
        )
        return (contigs, graph), dict(m.stages)

    @staticmethod
    def unitig_rows(graph):
        return [(u.seq, u.edges, u.cov_sum) for u in graph.unitigs]

    def close(self) -> None:
        pass
