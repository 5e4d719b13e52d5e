"""Deferred merges (the merge stride) of the port's streamed counters
against the JAX package's ``merge_stride=``.

The mirror of ``tests/test_merge_stride.py``: the same reads (a 3,000 bp
genome at 20x in 60 bp reads, numpy seeds 91 and 92, 1% Ns from seed 5)
cut to 300, 350 and 427 reads stream in batches of 50, so the batches
fill the last stride, leave a partial stride, and leave a short last
batch as well. At strides 1-4, in the flat and the bucketed layout (the
JAX side's under ``GA_BUCKETED=1 GA_BUCKETS=8 GA_BUCKET_ACCUM=3``), one
device's table equals the JAX package's array for array, with an
overflowing capacity too (flag and table); at D in {2, 4} on the JAX
package's CPU mesh (350 reads in global batches of 48) the per-shard
tables do, and routing overflow raises at the stream's end. The layout
``auto`` picks under a stride, the checkpoint params and the snapshot
cursors are the reference's: strided mid-stream checkpoints, one device and sharded, flat
and bucketed, are the same files and resume in either package, a stride
mismatch is refused, and a strided checkpoint reshards to the reference's
file. The command line takes ``--merge-stride`` (and refuses 0), and two
gloo ranks equal the single-process mesh. Exact everywhere.
"""

import os

import numpy as np
import pytest
import torch

import genome_assembler_tpu.parallel.pipeline as jax_pp
from genome_assembler_tpu.models import pipeline as jax_pipeline
from genome_assembler_tpu.parallel.mesh import build_mesh as jax_mesh
from genome_assembler_tpu.parallel.mesh import mesh_axes
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import decode_seq
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch import cli
from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.models.oracle import assemble_oracle
from genome_assembler_tpu_torch.ops import stream_table
from genome_assembler_tpu_torch.parallel import pipeline as pp
from genome_assembler_tpu_torch.parallel.launch import spawn
from genome_assembler_tpu_torch.parallel.mesh import build_mesh
from genome_assembler_tpu_torch.utils.keys import limbs_to_words

torch.set_num_threads(1)

CFG = AssemblyConfig(k=21, read_len=60, batch_reads=50)
CAP = 8192
# the JAX side of the bucketed layout; its accumulation is forced to 1
# under a stride, as the port's
JAX_BUCKETED = dict(GA_BUCKETED="1", GA_BUCKETS="8", GA_BUCKET_ACCUM="3")
PORT_BUCKETED = dict(bucketed="on", _buckets=8, _bucket_accum=3)
SPAWN_LIMIT_S = 300.0


@pytest.fixture(scope="module")
def all_reads():
    genome = simulate_genome(3000, seed=91)
    reads = simulate_reads(genome, coverage=20, read_len=60, seed=92).codes
    reads[np.random.default_rng(5).random(reads.shape) < 0.01] = 4
    return reads


def _assert_table_equals_jax(got, want):
    np.testing.assert_array_equal(limbs_to_words(got.limbs.numpy(), CFG.k),
                                  np.asarray(want.words))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert int(got.num_unique) == int(want.num_unique)
    assert bool(got.overflow) == bool(want.overflow)


def _assert_tables_equal(a, b):
    assert torch.equal(a.limbs, b.limbs) and torch.equal(a.counts, b.counts)
    assert int(a.num_unique) == int(b.num_unique)
    assert bool(a.overflow) == bool(b.overflow)


def _assert_files_equal(path_a, path_b):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])


def _env(mp, layout):
    for name, value in (JAX_BUCKETED if layout == "on" else
                        {"GA_BUCKETED": "0"}).items():
        mp.setenv(name, value)


def _port_kw(layout):
    return PORT_BUCKETED if layout == "on" else {"bucketed": "off"}


# ---- one device ----


@pytest.mark.parametrize("layout", ["off", "on"])
@pytest.mark.parametrize("stride", [1, 2, 3, 4])
@pytest.mark.parametrize("n_reads", [300, 350, 427])
def test_one_device_equals_jax(all_reads, monkeypatch, n_reads, stride,
                               layout):
    reads = all_reads[:n_reads]
    _env(monkeypatch, layout)
    base = pipeline.count_reads_device(reads, CFG, device="cpu",
                                       table_capacity=CAP, bucketed="off")
    for cap in (CAP, 128):  # 128: the table overflows
        want = jax_pipeline.count_reads_device(
            reads, CFG, table_capacity=cap, merge_stride=stride)
        got = pipeline.count_reads_device(
            reads, CFG, device="cpu", table_capacity=cap,
            merge_stride=stride, **_port_kw(layout))
        _assert_table_equals_jax(got, want)
        assert bool(got.overflow) == (cap == 128)
        if cap == CAP:  # the same table at every stride and layout
            _assert_tables_equal(got, base)
    with pytest.raises(RuntimeError, match="overflow"):
        pipeline.table_to_host_counts(got, CFG.k)


def test_stride_plan_is_the_references():
    """Deferred merges only with a stride above 1 and more than one batch;
    None and 0 mean 1, as in the reference."""
    assert (stream_table.stride_taken(None, 9)
            == stream_table.stride_taken(0, 9) == 1)
    assert stream_table.stride_taken(4, 9) == 4
    assert stream_table.stride_taken(4, 1) == 1


def _snapshot(run, path, **kw):
    with pytest.raises(RuntimeError, match="fault injection"):
        run(stream_checkpoint=path, stream_checkpoint_every=2, **kw)


@pytest.mark.parametrize("stride,want", [(1, 0), (2, 1), (4, 1)])
def test_auto_layout_under_a_stride_is_the_references(
        all_reads, monkeypatch, tmp_path, stride, want):
    """With the bound between capacity + one batch's windows and capacity
    + two batches', ``auto`` keeps stride 1 flat and takes the buckets at
    stride 2 and 4, in both packages: the snapshots (params, geometry and
    cursor) are the same file."""
    bw = CFG.batch_reads * (CFG.read_len - CFG.k + 1)
    bound = CAP + bw + bw // 2
    monkeypatch.setattr(stream_table, "BUCKETED_MIN_MERGE_ROWS", bound)
    monkeypatch.setattr(jax_pipeline, "BUCKETED_MIN_MERGE_ROWS", bound)
    monkeypatch.setenv("GA_BUCKETED", "auto")
    reads = all_reads[:427]
    port_ck, jax_ck = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    _snapshot(lambda **kw: pipeline.count_reads_device(
        reads, CFG, device="cpu", table_capacity=CAP, merge_stride=stride,
        **kw), port_ck, abort_after_batch=5)
    monkeypatch.setenv("GA_STREAM_ABORT_AFTER_BATCH", "5")
    _snapshot(lambda **kw: jax_pipeline.count_reads_device(
        reads, CFG, table_capacity=CAP, merge_stride=stride, **kw), jax_ck)
    _assert_files_equal(port_ck, jax_ck)
    with np.load(port_ck) as z:
        assert int(z["bucketed"]) == want and int(z["stride"]) == stride
        if want:
            assert int(z["accum"]) == 1


@pytest.mark.parametrize("layout", ["off", "on"])
def test_strided_checkpoints_cross_both_packages(all_reads, monkeypatch,
                                                 tmp_path, layout):
    """Stride 3 over 9 batches, a snapshot asked for every 2 batches, the
    run stopped after 5: the snapshot waits for the merge after batch 3 in
    both packages. Each package resumes the other's to the full table; a
    resume at another stride is refused."""
    reads = all_reads[:427]
    _env(monkeypatch, layout)
    kw = dict(table_capacity=CAP, merge_stride=3)
    full = pipeline.count_reads_device(reads, CFG, device="cpu",
                                       **_port_kw(layout), **kw)
    port_ck, jax_ck = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    _snapshot(lambda **k: pipeline.count_reads_device(
        reads, CFG, device="cpu", **_port_kw(layout), **kw, **k), port_ck,
        abort_after_batch=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GA_STREAM_ABORT_AFTER_BATCH", "5")
        _snapshot(lambda **k: jax_pipeline.count_reads_device(
            reads, CFG, **kw, **k), jax_ck)
    _assert_files_equal(port_ck, jax_ck)
    with np.load(port_ck) as z:
        assert int(z["next_start"]) == 3 * CFG.batch_reads
        assert int(z["stride"]) == 3
    _assert_tables_equal(pipeline.count_reads_device(
        reads, CFG, device="cpu", resume_stream_from=jax_ck,
        **_port_kw(layout), **kw), full)
    _assert_table_equals_jax(full, jax_pipeline.count_reads_device(
        reads, CFG, resume_stream_from=port_ck, **kw))
    with pytest.raises(ValueError, match="mismatch"):
        pipeline.count_reads_device(
            reads, CFG, device="cpu", table_capacity=CAP, merge_stride=2,
            resume_stream_from=port_ck, **_port_kw(layout))


# ---- per shard ----

# a global batch that 2 and 4 shards divide (a resharded cursor must
# align), 8 batches of 350 reads: two full strides of 3 and a tail of 2
SCFG = AssemblyConfig(k=21, read_len=60, batch_reads=48)


def _jax_shards(reads, d, stride, bucket_cap=None):
    words, counts, num = jax_pp._run_distributed_step(
        reads, SCFG, jax_mesh(d), bucket_cap, mesh_axes(jax_mesh(d)),
        table_capacity=CAP, merge_stride=stride)
    return np.asarray(words), np.asarray(counts), np.asarray(num)


@pytest.mark.parametrize("layout", ["off", "on"])
@pytest.mark.parametrize("d", [2, 4])
def test_shard_tables_equal_jax(all_reads, monkeypatch, d, layout):
    reads = all_reads[:350]
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    monkeypatch.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
    _env(monkeypatch, layout)
    words, counts, num = _jax_shards(reads, d, 3)
    mesh = build_mesh(d, devices=["cpu"])
    got = pp._run_distributed_step(reads, SCFG, mesh, table_capacity=CAP,
                                   merge_stride=3, **_port_kw(layout))
    base = pp._run_distributed_step(reads, SCFG, mesh, table_capacity=CAP,
                                    bucketed="off")
    c = got[0].limbs.shape[0]
    for s, (t, b) in enumerate(zip(got, base)):
        np.testing.assert_array_equal(limbs_to_words(t.limbs.numpy(), SCFG.k),
                                      words.reshape(d, c, -1)[s])
        np.testing.assert_array_equal(t.counts.numpy(),
                                      counts.reshape(d, c)[s])
        assert int(t.num_unique) == int(num[s])
        _assert_tables_equal(t, b)


def test_routing_overflow_raises_after_the_last_batch(all_reads,
                                                      monkeypatch):
    """Routing buckets of 64 rows overflow while the keys wait: the flags
    gather per shard and the stream raises at its end, as the reference's."""
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    monkeypatch.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
    monkeypatch.setenv("GA_BUCKETED", "0")
    reads = all_reads[:350]
    for run in (lambda: _jax_shards(reads, 2, 3, bucket_cap=64),
                lambda: pp._run_distributed_step(
                    reads, SCFG, build_mesh(2, devices=["cpu"]), 64,
                    table_capacity=CAP, merge_stride=3, bucketed="off")):
        with pytest.raises(RuntimeError, match="overflow"):
            run()


def test_shard_plan_is_the_references(all_reads):
    """Stride 2 over 4 shards keeps flat where stride 4 goes bucketed at
    the same bound (c_shard + stride x received rows), with the reference's
    params."""
    b = 427
    for stride in (1, 2, 3, 4):
        plan = pp._StreamPlan(b, 60, SCFG, 4, None, None, CAP,
                              merge_stride=stride)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GA_BUCKETED", "auto")
            want = jax_pp._StreamPlan(b, 60, SCFG, 4, None, None, CAP, stride)
        assert plan.ck_params == want.ck_params
        assert plan.recv == want.recv and plan.stride == want.stride
    bound = plan.c_shard + 3 * plan.recv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stream_table, "BUCKETED_MIN_MERGE_ROWS", bound)
        assert pp._StreamPlan(b, 60, SCFG, 4, None, None, CAP,
                              merge_stride=2).buckets is None
        got = pp._StreamPlan(b, 60, SCFG, 4, None, None, CAP, merge_stride=4)
        assert got.buckets is not None and got.buckets.accum == 1


@pytest.mark.parametrize("layout", ["off", "on"])
def test_sharded_strided_checkpoints_cross_and_reshard(
        all_reads, monkeypatch, tmp_path, layout):
    reads = all_reads[:350]
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    monkeypatch.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
    _env(monkeypatch, layout)
    kw = dict(table_capacity=CAP, merge_stride=3)
    mesh4 = build_mesh(4, devices=["cpu"])
    full = pp.distributed_count_table(reads, SCFG, mesh4, **_port_kw(layout),
                                      **kw)
    port_ck, jax_ck = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    _snapshot(lambda **k: pp.distributed_count_table(
        reads, SCFG, mesh4, **_port_kw(layout), **kw, **k), port_ck,
        abort_after_batch=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GA_STREAM_ABORT_AFTER_BATCH", "5")
        _snapshot(lambda **k: jax_pp.distributed_count_table(
            reads, SCFG, jax_mesh(4), **kw, **k), jax_ck)
    _assert_files_equal(port_ck, jax_ck)
    with np.load(port_ck) as z:
        assert int(z["next_batch"]) == 3 and int(z["stride"]) == 3
    for src in (port_ck, jax_ck):
        _assert_tables_equal(pp.distributed_count_table(
            reads, SCFG, mesh4, resume_stream_from=src, **_port_kw(layout),
            **kw), full)
    jt = jax_pp.distributed_count_table(reads, SCFG, jax_mesh(4),
                                        resume_stream_from=port_ck, **kw)
    assert (jax_pipeline.table_to_host_counts(jt, SCFG.k)
            == pipeline.table_to_host_counts(full, SCFG.k))
    with pytest.raises(ValueError, match="mismatch"):
        pp.distributed_count_table(reads, SCFG, mesh4, table_capacity=CAP,
                                   resume_stream_from=port_ck,
                                   **_port_kw(layout))
    # reshard 4 -> 2 at stride 3: the reference's file, and it resumes
    out, ref_out = str(tmp_path / "port2.npz"), str(tmp_path / "jax2.npz")
    pp.reshard_sharded_stream_checkpoint(port_ck, out, reads.shape, SCFG, 2,
                                         **_port_kw(layout), **kw)
    jax_pp.reshard_sharded_stream_checkpoint(jax_ck, ref_out, reads.shape,
                                             SCFG, 2, **kw)
    _assert_files_equal(out, ref_out)
    resumed = pp.distributed_count_table(
        reads, SCFG, build_mesh(2, devices=["cpu"]), resume_stream_from=out,
        **_port_kw(layout), **kw)
    n = int(full.num_unique)
    assert int(resumed.num_unique) == n
    assert torch.equal(resumed.limbs[:n], full.limbs[:n])
    assert torch.equal(resumed.counts[:n], full.counts[:n])


# ---- the command line ----


@pytest.fixture(scope="module")
def reads_file(all_reads, tmp_path_factory):
    path = tmp_path_factory.mktemp("reads") / "reads.txt"
    path.write_text("\n".join(decode_seq(r) for r in all_reads[:427]) + "\n")
    return str(path)


@pytest.mark.parametrize("backend", ["torch", "dist"])
def test_cli_merge_stride(reads_file, all_reads, tmp_path, monkeypatch,
                          capsys, backend):
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    import json

    out, metrics = str(tmp_path / "c.fa"), str(tmp_path / "m.json")
    assert cli.main([
        "assemble", "--reads", reads_file, "-k", "21", "--device", "cpu",
        "--backend", backend, *(["--devices", "2"] if backend == "dist"
                                else []),
        "--batch-reads", "50", "--table-capacity", str(CAP),
        "--merge-stride", "3", "--out", out, "--metrics-out", metrics,
    ]) == 0
    assert cli.read_sequences(out) == assemble_oracle(
        all_reads[:427], AssemblyConfig(k=21, read_len=60))
    with open(metrics) as fh:
        report = json.load(fh)
    assert report["counters"]["merge_stride"] == report["merge_stride"] == 3
    assert "merge stride 3" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="merge-stride must be >= 1"):
        cli.main(["assemble", "--reads", reads_file, "-k", "21", "--device",
                  "cpu", "--backend", backend, "--merge-stride", "0"])


def test_cli_reshard_merge_stride(reads_file, all_reads, monkeypatch,
                                  tmp_path):
    reads = all_reads[:427]
    monkeypatch.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
    monkeypatch.setenv("GA_BUCKETED", "0")
    ck = str(tmp_path / "mid.npz")
    kw = dict(table_capacity=CAP, merge_stride=3)
    monkeypatch.setenv("GA_STREAM_ABORT_AFTER_BATCH", "5")
    _snapshot(lambda **k: jax_pp.distributed_count_table(
        reads, SCFG, jax_mesh(4), **kw, **k), ck)
    out, ref_out = str(tmp_path / "two.npz"), str(tmp_path / "ref.npz")
    assert cli.main(["reshard", ck, "--out", out, "--devices", "2",
                     "--reads", reads_file, "-k", "21", "--batch-reads", "48",
                     "--table-capacity", str(CAP), "--merge-stride", "3"]) == 0
    jax_pp.reshard_sharded_stream_checkpoint(ck, ref_out, reads.shape, SCFG,
                                             2, **kw)
    _assert_files_equal(out, ref_out)
    with pytest.raises(SystemExit, match="merge-stride must be >= 1"):
        cli.main(["reshard", ck, "--out", out, "--devices", "2", "--reads",
                  reads_file, "--merge-stride", "0"])


def test_two_gloo_ranks_equal_the_single_process_mesh(tmp_path):
    """The strided cases of ``tests/test_torch_mesh.py`` (its ``--job
    strided``: flat and bucketed per-shard tables, and a strided
    mid-stream checkpoint that each side resumes) as two ranks."""
    import json

    out = str(tmp_path / "r")
    res = spawn(2, ["--job", "strided", "--out", out], device="cpu",
                timeout_s=SPAWN_LIMIT_S,
                entry=(os.path.join(os.path.dirname(__file__),
                                    "test_torch_mesh.py"),))
    assert res.ok, res.describe()
    for r in range(2):
        with open(f"{out}.rank{r}.json") as fh:
            verdicts = json.load(fh)
        assert len(verdicts) == 3
        for case, v in verdicts.items():
            assert v is None, f"rank {r}, {case}: {v}"
