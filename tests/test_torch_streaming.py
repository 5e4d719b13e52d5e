"""The port's streaming counter against single shot and the JAX package,
overflow, stage-boundary table checkpoints across the two packages, and
the ``ga-torch`` CLI."""

import json

import numpy as np
import pytest
import torch

from genome_assembler_tpu.models import pipeline as jax_pipeline
from genome_assembler_tpu.models.oracle import assemble_oracle
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import decode_seq
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch import cli
from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.ops import count_torch

# xdist workers share the cores: one intra-op thread each keeps the plain
# versions' many small CPU ops from oversubscribing them
torch.set_num_threads(1)


def _reads(genome_len, coverage, k, error_rate, seed=11):
    genome = simulate_genome(genome_len, seed=seed)
    rs = simulate_reads(genome, coverage=coverage, read_len=100,
                        seed=seed + 1, error_rate=error_rate, tile_k=k)
    return rs.codes


def test_streaming_matches_single_shot_and_reference():
    reads = _reads(5000, 60, 31, 0.01)
    cfg = AssemblyConfig(k=31, min_count=3, read_len=100, batch_reads=700)
    cap = 1 << 17
    got = pipeline.count_reads_device(reads, cfg, device="cpu",
                                      table_capacity=cap)
    want = jax_pipeline.count_reads_device(reads, cfg, table_capacity=cap)
    words, counts, num, over = count_torch.count_table_to_numpy(got, 31)
    assert int(num) == int(want.num_unique) and not over
    np.testing.assert_array_equal(words[:num], np.asarray(want.words)[:num])
    np.testing.assert_array_equal(counts, np.asarray(want.counts))
    single = pipeline.assemble_torch(reads, cfg, device="cpu")
    streamed = pipeline.assemble_torch(reads, cfg, device="cpu",
                                       table_capacity=cap)
    assert streamed == single == jax_pipeline.assemble_tpu(
        reads, cfg, table_capacity=cap
    )


def test_streaming_overflow_is_an_error():
    reads = _reads(3000, 30, 25, 0.0)
    cfg = AssemblyConfig(k=25, read_len=100, batch_reads=300)
    table = pipeline.count_reads_device(reads, cfg, device="cpu",
                                        table_capacity=1000)
    assert bool(table.overflow)
    with pytest.raises(RuntimeError, match="overflow"):
        pipeline.assemble_torch(reads, cfg, device="cpu", table_capacity=1000)


def test_table_checkpoints_cross_packages(tmp_path):
    reads = _reads(3000, 40, 25, 0.01)
    cfg = AssemblyConfig(k=25, min_count=2, read_len=100)
    want = assemble_oracle(reads, cfg)
    jax_ckpt = str(tmp_path / "jax.npz")
    port_ckpt = str(tmp_path / "port.npz")
    assert jax_pipeline.assemble_tpu(reads, cfg, checkpoint=jax_ckpt) == want
    # a JAX-counted table resumes in the port ...
    assert pipeline.assemble_torch(reads, cfg, device="cpu",
                                   resume_from=jax_ckpt,
                                   checkpoint=port_ckpt) == want
    # ... and the port writes the same file contents the reference reads
    with np.load(jax_ckpt) as a, np.load(port_ckpt) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])
    assert jax_pipeline.assemble_tpu(reads, cfg, resume_from=port_ckpt) == want
    # mid-stream checkpoints are refused, never half-read
    mid = str(tmp_path / "mid.npz")
    jax_pipeline.save_stream_checkpoint(
        jax_pipeline.load_table(jax_ckpt), mid, next_start=10,
        params={"k": 25},
    )
    with pytest.raises(ValueError, match="mid-stream"):
        pipeline.load_table(mid, "cpu")
    with pytest.raises(ValueError, match="another k"):
        pipeline.assemble_torch(
            reads, AssemblyConfig(k=41, read_len=100), device="cpu",
            resume_from=jax_ckpt,
        )


def test_cli_assemble_and_resume(tmp_path):
    reads = _reads(3000, 30, 25, 0.0)
    reads_file = tmp_path / "reads.txt"
    reads_file.write_text("\n".join(decode_seq(r) for r in reads) + "\n")
    out, metrics, ckpt = (str(tmp_path / n) for n in ("c.fa", "m.json", "t.npz"))
    base = ["assemble", "--reads", str(reads_file), "-k", "25",
            "--device", "cpu"]
    assert cli.main(base + ["--out", out, "--metrics-out", metrics,
                            "--checkpoint", ckpt]) == 0
    from genome_assembler_tpu.cli import read_sequences

    got = read_sequences(out)
    assert got == assemble_oracle(reads, AssemblyConfig(k=25, read_len=100))
    report = json.loads(open(metrics).read())
    assert report["device"] == "cpu" and "count" in report["stages_s"]
    # the reference's report (stages_s, counters, derived) with the
    # count stage's byte rate derived
    assert report["counters"]["count_bytes"] > 0
    assert 0 <= report["derived"]["hbm_roofline_frac"] < 1
    out2 = str(tmp_path / "c2.fa")
    assert cli.main(base + ["--out", out2, "--resume-from", ckpt]) == 0
    assert read_sequences(out2) == got
    # a table counted by `ga-tpu --checkpoint` resumes in ga-torch
    from genome_assembler_tpu.cli import main as ga_tpu

    jax_ckpt = str(tmp_path / "jax.npz")
    assert ga_tpu(["assemble", "--reads", str(reads_file), "-k", "25",
                   "--backend", "tpu", "--checkpoint", jax_ckpt,
                   "--out", str(tmp_path / "tpu.fa")]) == 0
    assert cli.main(base + ["--out", out2, "--resume-from", jax_ckpt]) == 0
    assert read_sequences(out2) == got
    # simulate-and-assemble front end, euler emission
    out3 = str(tmp_path / "c3.fa")
    assert cli.main(["assemble", "--genome-len", "2000", "--coverage", "30",
                     "-k", "21", "--emit", "euler", "--device", "cpu",
                     "--out", out3]) == 0
    assert len(read_sequences(out3)) == 1
