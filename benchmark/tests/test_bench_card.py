"""On a card only: a whole run of each cell's path at a small size,
traced, comes out correct with every per-layer metric read."""

import pytest
from conftest import tiny_cell

from harness import runner


@pytest.mark.cuda
def test_small_traced_run_on_the_card(cuda_device):
    cell = tiny_cell(genome_length=200_000, coverage=30, batch_reads=16_384)
    out, _ = runner.run(cell, 2**33 + 21, 1.0, True, cuda_device)
    assert out["correct"] is True
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < out["metrics"]["extract_roofline"]["value"] <= 105
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
