"""The sharded deployment's check on the CPU: the benchmark's streamed
reference (``benchmark/references/exact_dbg_streamed.py``) against
``exact_dbg``, and ``assemble_distributed_sharded`` on a 4-shard mesh
against it, on the Release 6 configuration's eight chromosomes and its
``roo`` family scaled to about 60 kb; and the sharded path's spans.

The generator and the references are the benchmark's own, loaded by
path as its harness loads them."""

import json
import os
import sys

import numpy as np
import pytest

from genome_assembler_tpu_torch.parallel import mesh as mesh_mod
from genome_assembler_tpu_torch.parallel import pipeline
from genome_assembler_tpu_torch.utils.config import AssemblyConfig
from genome_assembler_tpu_torch.utils.metrics import Metrics

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import cells, generate  # noqa: E402

exact = cells.load_module("references", "exact_dbg")
streamed = cells.load_module("references", "exact_dbg_streamed")

SMALL = {"chromosomes": [6_000, 2_500], "gc": 0.42,
         "repeats": [{"name": "r", "length": 400, "copies": 2, "reverse": 1}],
         "assembly": {"k": 31, "min_count": 1}}
TRAFFIC = {"coverage": 15, "read_len": 100, "error_rate": 0.0,
           "n_rate": 0.0}


def _fly_config(genome_length=60_000):
    """The Release 6 configuration scaled to about ``genome_length``: each
    chromosome cut in proportion (at least 300 bases), ``roo`` as eleven
    300-base copies, one reversed. At 60 kb no copy lies within 600 bases
    of a chromosome's end (none within 31 kb at full size), so the graph
    has no tip for the program's simplification to remove, which the
    reference leaves out."""
    with open(os.path.join(BENCH, "configs",
                           "drosophila_r6_k31_4card.json")) as fh:
        config = json.load(fh)
    scale = genome_length / sum(config["chromosomes"])
    return dict(
        config,
        chromosomes=[max(int(n * scale), 300) for n in config["chromosomes"]],
        repeats=[dict(config["repeats"][0], length=300, copies=11,
                      reverse=1)],
        table_capacity=4 * genome_length,
    )


@pytest.mark.parametrize("chunk_reads", [7, 64, 1 << 22])
@pytest.mark.parametrize("n_rate", [0.0, 0.003])
def test_streamed_answer_equals_exact_dbg(monkeypatch, chunk_reads, n_rate):
    reads = generate.make_reads(SMALL, dict(TRAFFIC, n_rate=n_rate), 2**33 + 7,
                                "cpu")
    # the small chunks merge into the running table many times
    assert reads.shape[0] > 10 * chunk_reads or chunk_reads > reads.shape[0]
    monkeypatch.setattr(streamed, "CHUNK_READS", chunk_reads)
    got = streamed.answer(reads, SMALL, "cpu")
    want = exact.answer(reads, SMALL, "cpu")
    assert got.contigs == want.contigs
    assert got.unitigs == want.unitigs
    assert len(want.unitigs) >= 4


def test_streamed_count_equals_exact_count_with_errors():
    traffic = dict(TRAFFIC, error_rate=0.01, n_rate=0.002)
    reads = generate.make_reads(SMALL, traffic, 41, "cpu")
    keys, counts = streamed.count_canonical(reads, 31, "cpu", chunk_reads=33)
    want_keys, want_counts = exact.count_canonical(reads, 31, "cpu")
    assert np.array_equal(keys.numpy(), want_keys.numpy())
    assert np.array_equal(counts.numpy(), want_counts.numpy())


def test_control_fails_where_keys_collide(monkeypatch):
    # a hash of a few bits makes the control's collisions certain here
    monkeypatch.setattr(exact, "hash32", lambda keys: keys & 0xFF)
    config = _fly_config()
    reads = generate.make_reads(config, dict(TRAFFIC, coverage=10), 5, "cpu")
    want = streamed.answer(reads, config, "cpu")
    ctl = streamed.control(reads, config, "cpu")
    rows = [(s, e, c) for s, (e, c) in ctl.unitigs.items()]
    got = streamed.compare(ctl.contigs, rows, want)
    assert got["contigs_unmatched"] > 0 and got["unitigs_unmatched"] > 0


@pytest.mark.parametrize("streamed_count", [False, True],
                         ids=["one_step", "streamed"])
def test_sharded_assembly_matches_the_streamed_reference(
        monkeypatch, streamed_count):
    config = _fly_config()
    assert len(config["chromosomes"]) == 8
    reads = generate.make_reads(config, dict(TRAFFIC, coverage=12),
                                2**32 + 17, "cpu")
    assembly = dict(config["assembly"])
    if streamed_count:
        monkeypatch.setattr(pipeline, "DIST_STREAM_WINDOWS", 0)
        assembly["batch_reads"] = 2048
    cfg = AssemblyConfig(read_len=100, **assembly)
    m = Metrics()
    contigs, graph = pipeline.assemble_distributed_sharded(
        reads, cfg, mesh_mod.build_mesh(4, devices=["cpu"]),
        table_capacity=config["table_capacity"], metrics=m,
        return_graph=True)
    want = streamed.answer(reads, config, "cpu")
    rows = [(u.seq, u.edges, u.cov_sum) for u in graph.unitigs]
    assert streamed.compare(contigs, rows, want) == {
        "contigs_unmatched": 0, "unitigs_unmatched": 0}
    assert len(want.unitigs) >= 14
    # the sharded path's own spans: no host N scan, a barrier a stage
    assert "shard.scan" not in m.spans
    assert m.spans["shard.barrier"][1] == len(m.stages) == 6
    assert m.counters["a2a_bytes_count"] > 0
