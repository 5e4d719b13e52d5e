"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that skip where no card is visible (decided inside the test)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: requires an NVIDIA GPU (CUDA)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_cell(name="ecoli_k12_k31.50x", genome_length=20_000, coverage=20,
              batch_reads=2048):
    """A cell of BENCHMARK.json cut to a size the CPU runs in a second:
    the same files, its chromosomes and repeats scaled to a genome of
    about ``genome_length`` (each chromosome at least 300 bases), and
    batches small enough that the count streams and merges."""
    from harness import cells

    cell = cells.find_cell(cells.load_benchmark(), name)
    chroms = cell.config["chromosomes"]
    scale = genome_length / sum(chroms)
    cell.config = dict(
        cell.config,
        chromosomes=[max(int(n * scale), 300) for n in chroms],
        repeats=[dict(r, length=max(int(r["length"] * scale), 150))
                 for r in cell.config.get("repeats", [])],
        table_capacity=4 * genome_length,
        assembly=dict(cell.config["assembly"], batch_reads=batch_reads),
    )
    cell.traffic = dict(cell.traffic, coverage=coverage)
    return cell
