"""``ga-torch assemble --backend dist`` as several processes, one rank a
process over ``torch.distributed`` with gloo on the CPU, against the port's
oracle and the JAX package's distributed paths.

The counterpart of ``tests/test_multiprocess.py``: the same reads (a 4,000
bp genome at 12x in 80 bp reads, numpy seeds 71 and 72, k=25) go through
the command line started by ``parallel/launch.py::spawn`` as 2 ranks x 2
local shards and 4 ranks x 1, gathered and with ``--sharded-graph``, and
in-process through the JAX package's ``assemble_distributed`` and
``assemble_distributed_sharded`` on its 4-device CPU mesh. Contigs are
compared for exact equality (strings: the tolerance is zero). Every spawn
ends after ``SPAWN_LIMIT_S`` at the latest.
"""

import json

import numpy as np
import pytest

import genome_assembler_tpu.parallel.pipeline as jax_pp
from genome_assembler_tpu.parallel.mesh import build_mesh as jax_mesh
from genome_assembler_tpu.utils.config import AssemblyConfig as JaxConfig
from genome_assembler_tpu_torch import cli
from genome_assembler_tpu_torch.host.traverse import contigs_equal
from genome_assembler_tpu_torch.models.oracle import assemble_oracle
from genome_assembler_tpu_torch.parallel.launch import spawn
from genome_assembler_tpu_torch.utils.config import AssemblyConfig
from genome_assembler_tpu_torch.utils.dna import decode_seq
from genome_assembler_tpu_torch.utils.simulate import (
    simulate_genome,
    simulate_reads,
)

SPAWN_LIMIT_S = 300.0
K = 25


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    genome = simulate_genome(4000, seed=71)
    reads = simulate_reads(genome, coverage=12, read_len=80, seed=72).codes
    path = tmp_path_factory.mktemp("reads") / "reads.txt"
    path.write_text("\n".join(decode_seq(r) for r in reads) + "\n")
    return reads, decode_seq(genome), str(path)


@pytest.fixture(scope="module")
def jax_contigs(workload):
    """{sharded graph?: the JAX package's contigs on its 4-device mesh}."""
    reads = workload[0]
    cfg = JaxConfig(k=K, read_len=80)
    return {
        False: jax_pp.assemble_distributed(reads, cfg, jax_mesh(4)),
        True: jax_pp.assemble_distributed_sharded(reads, cfg, jax_mesh(4)),
    }


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["gathered", "sharded_graph"])
@pytest.mark.parametrize("world", [2, 4], ids=["2x2", "4x1"])
def test_ranks_assemble_to_the_oracle_and_jax_contigs(
        tmp_path, workload, jax_contigs, world, sharded):
    reads, genome, reads_file = workload
    out = str(tmp_path / "contigs.fa")
    res = spawn(
        world,
        ["assemble", "--reads", reads_file, "-k", str(K), "--backend", "dist",
         "--devices", "4", "--out", out, "--metrics-out",
         str(tmp_path / "m.json"), "--gfa", str(tmp_path / "g.gfa"),
         *(["--sharded-graph"] if sharded else [])],
        device="cpu", timeout_s=SPAWN_LIMIT_S,
    )
    assert res.ok, res.describe()
    outs = [cli._rank_path(out, r) for r in range(world)]
    contig_sets = [cli.read_sequences(o) for o in outs]
    assert all(c == contig_sets[0] for c in contig_sets)  # every rank the same
    with open(outs[0]) as a, open(outs[-1]) as b:
        assert a.read() == b.read()  # coverages in the headers included
    want = assemble_oracle(reads, AssemblyConfig(k=K, read_len=80))
    assert contig_sets[0] == want
    assert contig_sets[0] == jax_contigs[sharded]
    assert contigs_equal(contig_sets[0], [genome])
    # rank 0 alone writes the graph; every rank its metrics
    assert (tmp_path / "g.gfa").exists()
    assert not (tmp_path / "g.gfa.rank1").exists()
    for r in range(world):
        with open(cli._rank_path(str(tmp_path / "m.json"), r)) as fh:
            report = json.load(fh)
        assert report["hosts"] == world and report["rank"] == r
        assert report["shards"] == 4
        per = 4 // world
        assert report["local_shards"] == list(range(r * per, (r + 1) * per))
        assert report["counters"]["hosts"] == world
        derived = report["derived"]
        assert derived["reads_per_s_per_host"] == pytest.approx(
            derived["reads_per_s"] / world, rel=1e-3)
        assert report["kernel_launches"] == 0  # the CPU runs the plain version
        assert report["pack_launches"] == 0
        # a rank uploads its own rows only
        assert report["counters"]["h2d_bytes_reads"] == reads.size // world
    assert all("process(es)" in err for err in res.stderr)


def test_ranks_write_one_checkpoint_that_a_single_process_resumes(
        tmp_path, workload):
    """``--checkpoint`` in a 2-rank run: rank 0 writes the one
    ``"hash_shards"`` file of all 4 shards; the single-process mesh and the
    JAX package resume it with zeroed reads to the same contigs."""
    reads, genome, reads_file = workload
    ck = str(tmp_path / "shards.npz")
    res = spawn(
        2,
        ["assemble", "--reads", reads_file, "-k", str(K), "--backend", "dist",
         "--devices", "4", "--sharded-graph", "--checkpoint", ck, "--out",
         str(tmp_path / "c.fa")],
        device="cpu", timeout_s=SPAWN_LIMIT_S,
    )
    assert res.ok, res.describe()
    want = cli.read_sequences(str(tmp_path / "c.fa"))
    assert contigs_equal(want, [genome])
    zeros = tmp_path / "zeros.txt"
    zeros.write_text("\n".join("A" * 80 for _ in range(len(reads))) + "\n")
    assert cli.main([
        "assemble", "--reads", str(zeros), "-k", str(K), "--backend", "dist",
        "--devices", "4", "--sharded-graph", "--resume-from", ck, "--device",
        "cpu", "--out", str(tmp_path / "resumed.fa"),
    ]) == 0
    assert cli.read_sequences(str(tmp_path / "resumed.fa")) == want
    assert jax_pp.assemble_distributed_sharded(
        np.zeros_like(reads), JaxConfig(k=K, read_len=80), jax_mesh(4),
        resume_from=ck,
    ) == want


def test_a_failing_rank_fails_the_run(tmp_path, workload):
    """Even k with ``--sharded-graph`` is refused on every rank: exit 2
    from each, none left waiting."""
    res = spawn(
        2,
        ["assemble", "--reads", workload[2], "-k", "24", "--backend", "dist",
         "--devices", "4", "--sharded-graph", "--out", str(tmp_path / "c.fa")],
        device="cpu", timeout_s=SPAWN_LIMIT_S,
    )
    assert not res.ok and not res.timed_out
    assert 2 in res.returncodes
    assert "odd k" in res.describe()
