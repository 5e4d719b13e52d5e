"""Mid-stream checkpoints of the port's streaming counters, on one device
and sharded: a stopped run resumes to the uninterrupted run's table bit
for bit, a checkpoint written by either package resumes in the other,
a mismatched run is refused, and a sharded checkpoint reshards to
another shard count. The JAX package's fault hook is its environment
variable; the port's is the ``abort_after_batch`` argument."""

import numpy as np
import pytest
import torch

import genome_assembler_tpu.parallel.pipeline as jax_pp
import genome_assembler_tpu_torch.parallel.pipeline as pp
from genome_assembler_tpu.models import pipeline as jax_pipeline
from genome_assembler_tpu.models.oracle import count_canonical_fast
from genome_assembler_tpu.parallel.mesh import build_mesh as jax_mesh
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import decode_seq
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch import cli
from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.ops import count_torch
from genome_assembler_tpu_torch.parallel.mesh import build_mesh

torch.set_num_threads(1)

CFG = AssemblyConfig(k=15, read_len=60, batch_reads=64)
CAP = 8192


def cpu_mesh(d):
    return build_mesh(d, devices=["cpu"])


def _reads(genome_len=2000, coverage=12, read_len=60, seed=77):
    genome = simulate_genome(genome_len, seed=seed)
    return simulate_reads(genome, coverage=coverage, read_len=read_len,
                          seed=seed + 1).codes


@pytest.fixture(scope="module")
def reads():
    return _reads()


def _assert_tables_equal(a, b):
    """Port tables, or a port table and a reference one (numpy arrays)."""
    wa = count_torch.count_table_to_numpy(a, CFG.k)
    wb = (
        count_torch.count_table_to_numpy(b, CFG.k)
        if isinstance(b, count_torch.CountTable)
        else (np.asarray(b.words), np.asarray(b.counts), b.num_unique,
              b.overflow)
    )
    assert int(wa[2]) == int(wb[2]) and bool(wa[3]) == bool(wb[3])
    np.testing.assert_array_equal(wa[0], wb[0])
    np.testing.assert_array_equal(wa[1], wb[1])


def _assert_files_equal(path_a, path_b):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])


def _jax_abort(fn, after, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GA_STREAM_ABORT_AFTER_BATCH", str(after))
        with pytest.raises(RuntimeError, match="fault injection"):
            fn(**kw)


@pytest.fixture(scope="module")
def jax_single(reads, tmp_path_factory):
    """The JAX package's full streamed table and its mid-stream snapshot
    (stopped after 3 batches, snapshot every 2)."""
    ck = str(tmp_path_factory.mktemp("jax1") / "mid.npz")
    full = jax_pipeline.count_reads_device(reads, CFG, table_capacity=CAP)
    _jax_abort(
        jax_pipeline.count_reads_device, 3, reads=reads, cfg=CFG,
        table_capacity=CAP, stream_checkpoint=ck, stream_checkpoint_every=2,
    )
    return full, ck


def test_single_device_abort_and_resume(reads, jax_single, tmp_path):
    full = pipeline.count_reads_device(reads, CFG, device="cpu",
                                       table_capacity=CAP)
    ck = str(tmp_path / "mid.npz")
    with pytest.raises(RuntimeError, match="fault injection"):
        pipeline.count_reads_device(
            reads, CFG, device="cpu", table_capacity=CAP,
            stream_checkpoint=ck, stream_checkpoint_every=2,
            abort_after_batch=3,
        )
    assert pipeline.is_stream_checkpoint(ck)
    resumed = pipeline.count_reads_device(
        reads, CFG, device="cpu", table_capacity=CAP, resume_stream_from=ck
    )
    _assert_tables_equal(resumed, full)
    jax_full, jax_ck = jax_single
    _assert_tables_equal(full, jax_full)
    # the port wrote the very file the reference wrote at the same point
    _assert_files_equal(ck, jax_ck)


def test_single_device_checkpoints_cross_packages(reads, jax_single, tmp_path):
    jax_full, jax_ck = jax_single
    # written by the JAX package, resumed by the port ...
    resumed = pipeline.count_reads_device(
        reads, CFG, device="cpu", table_capacity=CAP,
        resume_stream_from=jax_ck,
    )
    _assert_tables_equal(resumed, jax_full)
    # ... and the reverse
    ck = str(tmp_path / "port_mid.npz")
    with pytest.raises(RuntimeError, match="fault injection"):
        pipeline.count_reads_device(
            reads, CFG, device="cpu", table_capacity=CAP,
            stream_checkpoint=ck, stream_checkpoint_every=1,
            abort_after_batch=4,
        )
    assert jax_pipeline.is_stream_checkpoint(ck)
    _assert_tables_equal(
        resumed,
        jax_pipeline.count_reads_device(reads, CFG, table_capacity=CAP,
                                        resume_stream_from=ck),
    )


@pytest.mark.parametrize("stop", [1, 2, 6])
def test_single_device_checkpoint_at_each_cursor(reads, jax_single, tmp_path,
                                                 stop):
    """A snapshot after batch ``stop`` of 7, taken while the upload ring
    is already past it (two batches ahead, or at the stream's end): the
    file equals the reference's at the same cursor, and both packages
    resume it to the uninterrupted table."""
    jax_full, _ = jax_single
    ck, jax_ck = str(tmp_path / "mid.npz"), str(tmp_path / "jax_mid.npz")
    with pytest.raises(RuntimeError, match="fault injection"):
        pipeline.count_reads_device(
            reads, CFG, device="cpu", table_capacity=CAP,
            stream_checkpoint=ck, stream_checkpoint_every=stop,
            abort_after_batch=stop,
        )
    _jax_abort(
        jax_pipeline.count_reads_device, stop, reads=reads, cfg=CFG,
        table_capacity=CAP, stream_checkpoint=jax_ck,
        stream_checkpoint_every=stop,
    )
    _assert_files_equal(ck, jax_ck)
    with np.load(ck) as z:
        assert int(z["next_start"]) == stop * CFG.batch_reads
    _assert_tables_equal(
        pipeline.count_reads_device(reads, CFG, device="cpu",
                                    table_capacity=CAP,
                                    resume_stream_from=ck),
        jax_full,
    )
    _assert_tables_equal(
        pipeline.count_reads_device(reads, CFG, device="cpu",
                                    table_capacity=CAP,
                                    resume_stream_from=jax_ck),
        jax_pipeline.count_reads_device(reads, CFG, table_capacity=CAP,
                                        resume_stream_from=ck),
    )


def test_single_device_resume_refuses_mismatch(reads, jax_single):
    _, ck = jax_single
    with pytest.raises(ValueError, match="mismatch"):
        pipeline.count_reads_device(reads, CFG, device="cpu",
                                    table_capacity=2 * CAP,
                                    resume_stream_from=ck)
    with pytest.raises(ValueError, match="streaming path"):
        pipeline.count_reads_device(reads, CFG, device="cpu",
                                    resume_stream_from=ck)


def test_assemble_torch_resumes_mid_stream(reads, tmp_path):
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=128)
    baseline = pipeline.assemble_torch(reads, cfg, device="cpu",
                                       table_capacity=CAP)
    ck = str(tmp_path / "mid.npz")
    with pytest.raises(RuntimeError, match="fault injection"):
        pipeline.count_reads_device(
            reads, cfg, device="cpu", table_capacity=CAP,
            stream_checkpoint=ck, stream_checkpoint_every=1,
            abort_after_batch=2,
        )
    assert pipeline.assemble_torch(reads, cfg, device="cpu",
                                   table_capacity=CAP,
                                   resume_from=ck) == baseline
    # a run that completes overwrites the snapshot with the finished table
    done = str(tmp_path / "done.npz")
    assert pipeline.assemble_torch(reads, cfg, device="cpu",
                                   table_capacity=CAP, checkpoint=done,
                                   stream_checkpoint_every=1) == baseline
    assert not pipeline.is_stream_checkpoint(done)
    assert pipeline.assemble_torch(reads, cfg, device="cpu",
                                   resume_from=done) == baseline


@pytest.fixture(scope="module")
def jax_sharded(reads, tmp_path_factory):
    """JAX sharded snapshots (4 and 2 shards, stopped after 3 batches,
    snapshot every 2) and the full per-key counts."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
        for d in (2, 4):
            ck = str(tmp_path_factory.mktemp(f"jax{d}") / "mid.npz")
            _jax_abort(
                jax_pp.distributed_count_table, 3, reads=reads, cfg=CFG,
                mesh=jax_mesh(d), table_capacity=CAP, stream_checkpoint=ck,
                stream_checkpoint_every=2,
            )
            out[d] = ck
    return out


def _sharded_abort(reads, d, ck, after=3, every=2, **kw):
    with pytest.raises(RuntimeError, match="fault injection"):
        pp.distributed_count_table(
            reads, CFG, cpu_mesh(d), table_capacity=CAP,
            stream_checkpoint=ck, stream_checkpoint_every=every,
            abort_after_batch=after, **kw,
        )
    assert pp.is_sharded_stream_checkpoint(ck)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_abort_and_resume(reads, jax_sharded, monkeypatch, tmp_path, d):
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    full = pp.distributed_count_table(reads, CFG, cpu_mesh(d),
                                      table_capacity=CAP)
    ck = str(tmp_path / "mid.npz")
    _sharded_abort(reads, d, ck)
    _assert_files_equal(ck, jax_sharded[d])
    resumed = pp.distributed_count_table(reads, CFG, cpu_mesh(d),
                                         table_capacity=CAP,
                                         resume_stream_from=ck)
    _assert_tables_equal(resumed, full)
    assert pipeline.table_to_host_counts(full, CFG.k) == count_canonical_fast(
        reads, CFG.k
    )


def test_sharded_checkpoint_at_the_last_cursor(reads, monkeypatch, tmp_path):
    """The snapshot before the last batch (the ring has nothing left to
    prefetch) and after the first (it is one batch ahead), on 2 shards:
    equal to the reference's files, resumed by the port."""
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    monkeypatch.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
    full = pp.distributed_count_table(reads, CFG, cpu_mesh(2),
                                      table_capacity=CAP)
    batches = -(-reads.shape[0] // CFG.batch_reads)
    for stop in (1, batches - 1):
        ck, jax_ck = str(tmp_path / "mid.npz"), str(tmp_path / "jax_mid.npz")
        _sharded_abort(reads, 2, ck, after=stop, every=stop)
        _jax_abort(
            jax_pp.distributed_count_table, stop, reads=reads, cfg=CFG,
            mesh=jax_mesh(2), table_capacity=CAP, stream_checkpoint=jax_ck,
            stream_checkpoint_every=stop,
        )
        _assert_files_equal(ck, jax_ck)
        _assert_tables_equal(
            pp.distributed_count_table(reads, CFG, cpu_mesh(2),
                                       table_capacity=CAP,
                                       resume_stream_from=jax_ck),
            full,
        )


def test_sharded_checkpoints_cross_packages(reads, jax_sharded, monkeypatch,
                                            tmp_path):
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    want = count_canonical_fast(reads, CFG.k)
    resumed = pp.distributed_count_table(
        reads, CFG, cpu_mesh(4), table_capacity=CAP,
        resume_stream_from=jax_sharded[4],
    )
    assert pipeline.table_to_host_counts(resumed, CFG.k) == want
    ck = str(tmp_path / "port_mid.npz")
    _sharded_abort(reads, 4, ck, after=4, every=1)
    monkeypatch.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
    table = jax_pp.distributed_count_table(
        reads, CFG, jax_mesh(4), table_capacity=CAP, resume_stream_from=ck
    )
    assert jax_pipeline.table_to_host_counts(table, CFG.k) == want


def test_sharded_resume_refuses_mismatch(reads, jax_sharded, monkeypatch):
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    for kw in ({"mesh": cpu_mesh(2)}, {"mesh": cpu_mesh(4), "minimizer_len": 7}):
        with pytest.raises(ValueError, match="mismatch"):
            pp.distributed_count_table(reads, CFG, table_capacity=CAP,
                                       resume_stream_from=jax_sharded[4], **kw)


def test_resume_refuses_the_other_backends_checkpoint(reads, jax_single,
                                                     jax_sharded):
    """A mid-stream checkpoint resumes only on the backend that wrote it;
    the other backend refuses it and names the one that resumes it."""
    cfg = AssemblyConfig(k=15, read_len=60, batch_reads=64)
    _, single = jax_single
    sharded = jax_sharded[4]
    with pytest.raises(ValueError, match="--backend dist"):
        pipeline.assemble_torch(reads, cfg, device="cpu", table_capacity=CAP,
                                resume_from=sharded)
    with pytest.raises(ValueError, match="--backend dist"):
        pipeline.count_reads_device(reads, CFG, device="cpu",
                                    table_capacity=CAP,
                                    resume_stream_from=sharded)
    with pytest.raises(ValueError, match="--backend torch"):
        pp.assemble_distributed(reads, cfg, cpu_mesh(4), table_capacity=CAP,
                                resume_from=single)
    with pytest.raises(ValueError, match="--backend torch"):
        pp.distributed_count_table(reads, CFG, cpu_mesh(4),
                                   table_capacity=CAP,
                                   resume_stream_from=single)


def test_reshard_4_to_2(reads, jax_sharded, monkeypatch, tmp_path):
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    want = count_canonical_fast(reads, CFG.k)
    ck = str(tmp_path / "mid.npz")
    _sharded_abort(reads, 4, ck)
    for src in (ck, jax_sharded[4]):
        out = str(tmp_path / "two.npz")
        pp.reshard_sharded_stream_checkpoint(src, out, reads.shape, CFG, 2,
                                             table_capacity=CAP)
        # the port's resharder writes what the reference's writes
        ref_out = str(tmp_path / "two_ref.npz")
        jax_pp.reshard_sharded_stream_checkpoint(src, ref_out, reads.shape,
                                                 CFG, 2, table_capacity=CAP)
        _assert_files_equal(out, ref_out)
        table = pp.distributed_count_table(reads, CFG, cpu_mesh(2),
                                           table_capacity=CAP,
                                           resume_stream_from=out)
        assert pipeline.table_to_host_counts(table, CFG.k) == want
    with pytest.raises(ValueError, match="align"):
        pp.reshard_sharded_stream_checkpoint(ck, str(tmp_path / "x.npz"),
                                             reads.shape, CFG, 3,
                                             table_capacity=CAP)
    with pytest.raises(ValueError, match="total_reads"):
        pp.reshard_sharded_stream_checkpoint(
            ck, str(tmp_path / "x.npz"), (reads.shape[0] - 1, 60), CFG, 2,
            table_capacity=CAP,
        )
    mini = str(tmp_path / "mini.npz")
    _sharded_abort(reads, 4, mini, minimizer_len=7)
    with pytest.raises(ValueError, match="minimizer"):
        pp.reshard_sharded_stream_checkpoint(mini, str(tmp_path / "x.npz"),
                                             reads.shape, CFG, 2,
                                             table_capacity=CAP)


def test_reshard_cli_roundtrip(reads, monkeypatch, tmp_path):
    """ga-torch reshard rewrites a 4-shard snapshot for 2 shards, and the
    resumed dist assembly gives the uninterrupted run's contigs."""
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    reads_file = str(tmp_path / "reads.txt")
    with open(reads_file, "w") as fh:
        fh.write("\n".join(decode_seq(r) for r in reads) + "\n")
    base = ["assemble", "--reads", reads_file, "-k", "15", "--backend",
            "dist", "--device", "cpu", "--batch-reads", "64",
            "--table-capacity", str(CAP)]
    out1 = str(tmp_path / "full.fa")
    assert cli.main(base + ["--devices", "4", "--out", out1]) == 0
    ck = str(tmp_path / "mid.npz")
    _sharded_abort(reads, 4, ck)
    ck2 = str(tmp_path / "mid2.npz")
    assert cli.main(["reshard", ck, "--out", ck2, "--devices", "2",
                     "--reads", reads_file, "-k", "15", "--batch-reads",
                     "64", "--table-capacity", str(CAP)]) == 0
    out2 = str(tmp_path / "resumed.fa")
    assert cli.main(base + ["--devices", "2", "--resume-from", ck2,
                            "--out", out2]) == 0
    from genome_assembler_tpu.cli import read_sequences

    assert read_sequences(out2) == read_sequences(out1)
