"""The plain reference: its count against a dictionary, its contigs and
unitigs against the genome and against the port's ``assemble_torch`` on
the CPU, and the reference importing nothing of the port or of JAX."""

import ast
import collections
import os

import numpy as np
import pytest
import torch
from conftest import BENCH

from harness import cells, generate

ref = cells.load_module("references", "exact_dbg")
CONFIG = {"chromosomes": [6_000], "gc": 0.5,
          "assembly": {"k": 31, "min_count": 1}, "table_capacity": 65_536}
TRAFFIC = {"coverage": 15, "read_len": 100, "error_rate": 0.0,
           "n_rate": 0.0}


def _decode(codes):
    return "".join("ACGTN"[c] for c in codes)


def _dict_count(reads, k):
    out = collections.Counter()
    for row in reads:
        s = _decode(row)
        for i in range(len(s) - k + 1):
            w = s[i: i + k]
            if "N" not in w:
                out[ref.canonical(w)] += 1
    return out


def test_count_equals_a_dictionary():
    traffic = dict(TRAFFIC, error_rate=0.01, n_rate=0.002)
    reads = generate.make_reads(CONFIG, traffic, 77, "cpu")[:300]
    keys, counts = ref.count_canonical(reads, 31, "cpu")
    want = _dict_count(reads, 31)
    got = {_decode([(int(x) >> (2 * (30 - i))) & 3 for i in range(31)]): int(c)
           for x, c in zip(keys, counts)}
    assert got == dict(want)


def test_one_contig_equal_to_the_genome():
    reads = generate.make_reads(CONFIG, TRAFFIC, 91, "cpu")
    gen = torch.Generator()
    gen.manual_seed(91)
    genome = _decode(generate.make_genome(CONFIG, gen, "cpu")[0].numpy())
    want = ref.answer(reads, CONFIG, "cpu")
    assert want.contigs == [ref.canonical(genome)]
    edges, cov = want.unitigs[want.contigs[0]]
    assert edges == 6_000 - 30
    assert cov == reads.shape[0] * 70  # every window counted once


def test_branching_paths():
    # two copies of a 40-base repeat split the genome into paths
    rng = np.random.default_rng(3)
    a, rep, b, c = (rng.integers(0, 4, n, dtype=np.uint8)
                    for n in (300, 40, 300, 300))
    genome = np.concatenate([a, rep, b, rep, c])
    reads = np.stack([genome[i: i + 100] for i in range(len(genome) - 99)])
    want = ref.answer(reads, CONFIG, "cpu")
    assert len(want.contigs) == 4
    assert sum(e for e, _ in want.unitigs.values()) == len(
        {ref.canonical(_decode(genome[i: i + 31]))
         for i in range(len(genome) - 30)})


def test_reference_matches_the_port_on_the_cpu():
    from genome_assembler_tpu_torch.models.pipeline import assemble_torch
    from genome_assembler_tpu_torch.utils.config import AssemblyConfig

    reads = generate.make_reads(CONFIG, TRAFFIC, 2**31 + 5, "cpu")
    cfg = AssemblyConfig(k=31, min_count=1, batch_reads=256)
    contigs, graph = assemble_torch(reads, cfg, device="cpu",
                                    table_capacity=65_536, return_graph=True)
    rows = [(u.seq, u.edges, u.cov_sum) for u in graph.unitigs]
    got = ref.compare(contigs, rows, ref.answer(reads, CONFIG, "cpu"))
    assert got == {"contigs_unmatched": 0, "unitigs_unmatched": 0}


@pytest.mark.parametrize("name", ["ecoli_k12_k31.50x",
                                  "yeast_s288c_k31.100x"])
def test_reference_matches_the_port_on_each_cells_genome(name):
    """Each configuration's genome scaled down (E. coli's rrn repeats on
    both strands, yeast's 17 chromosomes): many unitigs and junctions,
    and the reference and the port agree on every one."""
    from conftest import tiny_cell
    from genome_assembler_tpu_torch.models.pipeline import assemble_torch
    from genome_assembler_tpu_torch.utils.config import AssemblyConfig

    cell = tiny_cell(name, genome_length=60_000)
    reads = generate.make_reads(cell.config, cell.traffic, 2**32 + 17, "cpu")
    cfg = AssemblyConfig(read_len=100, **cell.config["assembly"])
    contigs, graph = assemble_torch(
        reads, cfg, device="cpu", table_capacity=cell.config["table_capacity"],
        return_graph=True)
    want = ref.answer(reads, cell.config, "cpu")
    assert len(want.contigs) >= 14
    rows = [(u.seq, u.edges, u.cov_sum) for u in graph.unitigs]
    assert ref.compare(contigs, rows, want) == {
        "contigs_unmatched": 0, "unitigs_unmatched": 0}


def test_compare_counts_what_differs():
    want = ref.Answer(contigs=["AAAC", "ACGG"],
                      unitigs={"AAAC": (2, 10), "ACGG": (2, 9)})
    rows = [("AAAC", 2, 10), ("GTTT", 2, 10), ("CCGT", 2, 9)]
    assert ref.compare(["AAAC", "ACGG"], rows, want) == {
        "contigs_unmatched": 0, "unitigs_unmatched": 0}
    assert ref.compare(["AAAC", "ACGA"], rows, want)["contigs_unmatched"] == 2
    assert ref.compare(["AAAC"], rows, want)["contigs_unmatched"] == 1
    rows[2] = ("CCGT", 2, 8)
    assert ref.compare(["AAAC", "ACGG"], rows, want)["unitigs_unmatched"] == 1
    rows[1] = ("GTTT", 2, 11)  # the two strands disagree
    assert ref.compare(["AAAC", "ACGG"], rows, want)["unitigs_unmatched"] == 2


def test_yardstick_imports_nothing_of_the_program():
    """The reference, the generator and the trace reading import neither
    JAX nor either package; the entries are the only way to the port."""
    banned = {"jax", "jaxlib", "flax", "genome_assembler_tpu",
              "genome_assembler_tpu_torch"}
    for sub in ("references", "harness", "layer_metrics"):
        folder = os.path.join(BENCH, sub)
        for name in os.listdir(folder):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(folder, name)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    tops = {node.module.split(".")[0]}
                else:
                    continue
                assert not tops & banned, (sub, name, tops)


def test_cycles_and_long_keys_are_refused():
    ring = np.random.default_rng(1).integers(0, 4, 200, dtype=np.uint8)
    circ = np.concatenate([ring, ring[:99]])
    reads = np.stack([circ[i: i + 100] for i in range(200)])
    with pytest.raises(NotImplementedError):
        ref.answer(reads, CONFIG, "cpu")
    with pytest.raises(NotImplementedError):
        ref.answer(reads, dict(CONFIG, assembly={"k": 41, "min_count": 1}),
                   "cpu")
