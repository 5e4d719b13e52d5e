"""The port's multi-process mesh (``parallel/mesh.py``) against its
single-process mesh, on the CPU with gloo.

Every comparison is exact (integers and strings: the tolerance is zero).
Inputs come from numpy seeds: a 4,000 bp genome at 12x in 80 bp reads,
k=25 and a two-limb k=41, and random int64 / int32 / uint8 tensors for
the collectives alone.

The ranks are this file run as a script (``python tests/test_torch_mesh.py
--job checks ...``; with ``--device cuda`` the same cases run over NCCL, a
card a rank, which ``tests/test_torch_cuda.py`` does where there are
cards) through ``parallel/launch.py::spawn``: each rank builds
the mesh of 4 shards over the process group, runs a case on it and on the
single-process mesh of 4 shards in the same process, compares its local
shards with the corresponding global ones, and writes the cases' verdicts
to a JSON file that the parametrised tests read. One spawn a layout (2
ranks x 2 local shards, 4 ranks x 1) serves all its cases; a spawn ends
after ``SPAWN_LIMIT_S`` at the latest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import pytest
import torch

import genome_assembler_tpu_torch.parallel.pipeline as pp
from genome_assembler_tpu_torch.parallel import compress as pc
from genome_assembler_tpu_torch.parallel import mesh as mesh_mod
from genome_assembler_tpu_torch.parallel.launch import spawn
from genome_assembler_tpu_torch.utils.config import AssemblyConfig
from genome_assembler_tpu_torch.utils.metrics import Metrics
from genome_assembler_tpu_torch.utils.simulate import (
    simulate_genome,
    simulate_reads,
)

D = 4
SPAWN_LIMIT_S = 300.0


def flat_mesh(d=D, device="cpu"):
    """The single-process mesh, also inside a rank (``build_mesh`` would
    follow the process group there)."""
    return mesh_mod.Mesh((torch.device(device),) * d)


def small_reads():
    genome = simulate_genome(4000, seed=71)
    return simulate_reads(genome, coverage=12, read_len=80, seed=72).codes


# ---------------------------------------------------------------- rank side


def _local(mesh, xs):
    return [xs[g] for g in mesh.local_shards]


def _assert_tables_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a.limbs, b.limbs)
        assert torch.equal(a.counts, b.counts)
        assert int(a.num_unique) == int(b.num_unique)
        assert bool(a.overflow) == bool(b.overflow)


def _assert_files_equal(path_a, path_b):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])


def case_collectives(dmesh, flat, out, dtype):
    rng = np.random.default_rng(7)

    def rand(*shape):
        return torch.from_numpy(rng.integers(0, 100, size=shape)).to(
            dtype).to(dmesh.devices[0])

    for tail in ((), (3,), (1,)):
        send = [rand(D, 5, *tail) for _ in range(D)]
        want = mesh_mod.all_to_all(flat, send)
        got = mesh_mod.all_to_all(dmesh, _local(dmesh, send))
        assert len(got) == dmesh.local_size
        for g, x in zip(dmesh.local_shards, got):
            assert x.dtype == dtype and torch.equal(x, want[g])
    xs = [rand(6, 2) for _ in range(D)]
    want = mesh_mod.all_gather(flat, xs)
    assert torch.equal(mesh_mod.all_gather(dmesh, _local(dmesh, xs)), want)
    got = mesh_mod.all_gather_replicated(dmesh, _local(dmesh, xs))
    assert len(got) == dmesh.local_size
    assert all(torch.equal(x, want) for x in got)
    host = mesh_mod.gather_to_host(dmesh, _local(dmesh, xs))
    assert len(host) == D
    for a, b in zip(host, mesh_mod.gather_to_host(flat, xs)):
        np.testing.assert_array_equal(a, b)
    for hot in (None, 0, 3):
        flags = [torch.tensor(g == hot, device=dmesh.devices[0])
                 for g in range(D)]
        got = mesh_mod.any_reduce(dmesh, _local(dmesh, flags))
        assert got.dtype == torch.bool
        assert bool(got) == bool(mesh_mod.any_reduce(flat, flags))
    vals = [rand() for _ in range(D)]
    assert int(mesh_mod.max_reduce(dmesh, _local(dmesh, vals))) == int(
        mesh_mod.max_reduce(flat, vals))
    mesh_mod.barrier(dmesh)


def case_tables(dmesh, flat, out, k, minimizer, streamed=False, **layout):
    reads = small_reads()
    cfg = AssemblyConfig(k=k, read_len=80, batch_reads=96)
    pp.DIST_STREAM_WINDOWS = 0 if streamed else 1 << 24
    kw = dict(minimizer_len=minimizer,
              table_capacity=8192 if streamed else None, **layout)
    try:
        m = Metrics()
        got = pp._run_distributed_step(reads, cfg, dmesh, metrics=m, **kw)
        want = pp._run_distributed_step(reads, cfg, flat, **kw)
    finally:
        pp.DIST_STREAM_WINDOWS = 1 << 24
    _assert_tables_equal(got, _local(dmesh, want))
    assert sum(int(t.num_unique) for t in want) > 3000
    # a rank uploads only its own rows
    rows = -(-reads.shape[0] // (96 if streamed else D)) * (
        96 if streamed else D)
    assert m.counters["h2d_bytes_reads"] == rows * 80 // dmesh.hosts


def case_compress(dmesh, flat, out):
    # reads with errors: many unitigs, with heads on every shard
    reads = simulate_reads(simulate_genome(4000, seed=71), coverage=12,
                           read_len=80, seed=72, error_rate=0.01).codes
    cfg = AssemblyConfig(k=25, read_len=80)
    outs = []
    for mesh in (dmesh, flat):
        tables = pp._run_distributed_step(reads, cfg, mesh)
        tables = pp._shard_filter_compact(tables, 1)
        c_shard = 8192
        tables = [pp.count_torch.resize_table(t, c_shard) for t in tables]
        g = pc.make_sharded_compress(mesh, 25, c_shard)(tables)
        ua = pc.spell_sharded_arrays(
            mesh, 25, c_shard, g.num_unitigs, g.valid, g.uid, g.pos, g.cov,
            g.heads, g.edge_limbs)
        outs.append((g, ua))
    (g, ua), (gf, uaf) = outs
    assert (g.num_unitigs, g.overflow, g.query_rounds) == (
        gf.num_unitigs, gf.overflow, gf.query_rounds)
    assert g.rank_pass == gf.rank_pass == "sampled"  # K = 16384 = 512 x 32
    assert g.num_unitigs > 100 and g.overflow == 0
    for name in ("valid", "uid", "pos", "cov", "last_base", "heads",
                 "edge_limbs"):
        for a, b in zip(getattr(g, name), _local(dmesh, getattr(gf, name))):
            assert torch.equal(a, b), name
    for name in ("buf", "off", "edges", "cov_sum"):
        np.testing.assert_array_equal(getattr(ua, name), getattr(uaf, name))


def case_compress_exact(dmesh, flat, out):
    """The forced exact pass across the ranks: the sampled pass's outputs,
    and more query rounds."""
    reads = simulate_reads(simulate_genome(4000, seed=71), coverage=12,
                           read_len=80, seed=72).codes
    cfg = AssemblyConfig(k=25, read_len=80)
    tables = pp._shard_filter_compact(pp._run_distributed_step(
        reads, cfg, dmesh), 1)
    tables = [pp.count_torch.resize_table(t, 8192) for t in tables]
    g = pc.make_sharded_compress(dmesh, 25, 8192)(tables)
    e = pc.make_sharded_compress(dmesh, 25, 8192, _exact=True)(tables)
    assert (g.rank_pass, e.rank_pass) == ("sampled", "exact")
    assert g.query_rounds < e.query_rounds
    assert (g.num_unitigs, g.overflow) == (e.num_unitigs, e.overflow)
    for name in ("valid", "uid", "pos", "cov", "heads", "edge_limbs"):
        for a, b in zip(getattr(g, name), getattr(e, name)):
            assert torch.equal(a, b), name


def _expect_stop(fn):
    try:
        fn()
    except RuntimeError as e:
        assert "fault injection" in str(e)
    else:
        raise AssertionError("the injected stop did not happen")


def case_ckpt_stream(dmesh, flat, out, at=2, **layout):
    """A mid-stream checkpoint written by the ranks against one written by
    the single-process mesh: equal files (the snapshot after ``at``
    batches), and each resumes on the other."""
    reads = small_reads()
    cfg = AssemblyConfig(k=25, read_len=80, batch_reads=96)

    def run(mesh, **kw):
        return pp._run_distributed_stream(
            reads, cfg, mesh, None, None, 8192, **kw, **layout)

    full = run(flat)
    tag = "".join(f"_{name}" for name in sorted(layout))
    by_ranks = f"{out}.stream_ranks{tag}.npz"
    by_flat = f"{out}.stream_flat{tag}.rank{dmesh.rank}.npz"
    for mesh, path in ((dmesh, by_ranks), (flat, by_flat)):
        _expect_stop(lambda: run(
            mesh, stream_checkpoint=path, stream_checkpoint_every=2,
            abort_after_batch=3))
    _assert_files_equal(by_ranks, by_flat)
    with np.load(by_ranks) as z:
        assert int(z["next_batch"]) == at and int(z["d"]) == D
    _assert_tables_equal(run(flat, resume_stream_from=by_ranks), full)
    _assert_tables_equal(run(dmesh, resume_stream_from=by_flat),
                         _local(dmesh, full))


def case_ckpt_hash_shards(dmesh, flat, out):
    reads = small_reads()
    cfg = AssemblyConfig(k=25, read_len=80)
    want = pp._run_distributed_step(reads, cfg, flat)
    got = pp._run_distributed_step(reads, cfg, dmesh)
    by_ranks = out + ".hash_ranks.npz"
    by_flat = f"{out}.hash_flat.rank{dmesh.rank}.npz"
    pp.save_sharded_table(got, D, 25, by_ranks, dmesh)
    pp.save_sharded_table(want, D, 25, by_flat)
    _assert_files_equal(by_ranks, by_flat)
    for a, b in zip(pp.load_sharded_table(by_ranks, flat, 25), want):
        assert torch.equal(a.limbs, b.limbs) and torch.equal(a.counts, b.counts)
    for a, b in zip(pp.load_sharded_table(by_flat, dmesh, 25), got):
        assert torch.equal(a.limbs, b.limbs) and torch.equal(a.counts, b.counts)


CASES = {
    "collectives_int64": lambda *a: case_collectives(*a, torch.int64),
    "collectives_int32": lambda *a: case_collectives(*a, torch.int32),
    "collectives_uint8": lambda *a: case_collectives(*a, torch.uint8),
    "tables_k25_per_window": lambda *a: case_tables(*a, 25, None),
    "tables_k25_minimizer": lambda *a: case_tables(*a, 25, 15),
    "tables_k41_per_window": lambda *a: case_tables(*a, 41, None),
    "tables_k41_minimizer": lambda *a: case_tables(*a, 41, 15),
    "tables_k25_streamed": lambda *a: case_tables(*a, 25, None, True),
    "tables_k25_minimizer_streamed": lambda *a: case_tables(*a, 25, 15, True),
    "tables_k25_streamed_bucketed": lambda *a: case_tables(
        *a, 25, None, True, bucketed="on", _buckets=8),
    "compress_and_spell_k25": case_compress,
    "compress_sampled_equals_exact": case_compress_exact,
    "checkpoint_stream": case_ckpt_stream,
    "checkpoint_stream_bucketed": lambda *a: case_ckpt_stream(
        *a, bucketed="on", _buckets=8, _bucket_accum=2),
    "checkpoint_hash_shards": case_ckpt_hash_shards,
}
# deferred merges (``tests/test_torch_merge_stride.py`` runs these as two
# ranks, ``--job strided``): stride 3 over the 7 batches of 96 reads
STRIDED_CASES = {
    "tables_k25_streamed_strided": lambda *a: case_tables(
        *a, 25, None, True, merge_stride=3),
    "tables_k25_streamed_strided_bucketed": lambda *a: case_tables(
        *a, 25, None, True, merge_stride=3, bucketed="on", _buckets=8),
    "checkpoint_stream_strided": lambda *a: case_ckpt_stream(
        *a, at=3, merge_stride=3),
}


def rank_main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--job", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    on_cpu = args.device == "cpu"
    assert mesh_mod.init_distributed(
        "gloo" if on_cpu else "nccl", timeout_s=120.0
    ) or os.environ["WORLD_SIZE"] == "1"
    dmesh = mesh_mod.build_mesh(D, devices=["cpu"] if on_cpu else None)
    if args.job == "raise":
        if dmesh.rank == 1:
            raise SystemExit(3)
        mesh_mod.barrier(dmesh)  # never met: the launcher must end this rank
        return 0
    if args.job == "sleep":
        time.sleep(600)
        return 0
    assert args.job in ("checks", "strided")
    assert dmesh.distributed and dmesh.size == D
    assert mesh_mod.num_hosts(dmesh) == int(os.environ["WORLD_SIZE"])
    verdicts = {}
    cases = CASES if args.job == "checks" else STRIDED_CASES
    for name, case in cases.items():
        try:
            case(dmesh, flat_mesh(D, dmesh.devices[0]), args.out)
            verdicts[name] = None
        except AssertionError:
            verdicts[name] = traceback.format_exc()[-1500:]
    with open(f"{args.out}.rank{dmesh.rank}.json", "w") as fh:
        json.dump(verdicts, fh)
    mesh_mod.shutdown_distributed()
    return 0


# ---------------------------------------------------------------- test side

_RUNS: dict = {}


def _spawn_self(world, job, out, limit=SPAWN_LIMIT_S):
    return spawn(world, ["--job", job, *(["--out", out] if out else [])],
                 device="cpu", timeout_s=limit,
                 entry=(os.path.abspath(__file__),))


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """world -> (verdicts of every rank, the prefix of the files the ranks
    left), one spawn a layout, made when first asked for."""

    def get(world):
        if world not in _RUNS:
            out = str(tmp_path_factory.mktemp(f"ranks{world}") / "r")
            res = _spawn_self(world, "checks", out)
            assert res.ok, res.describe()
            verdicts = []
            for r in range(world):
                with open(f"{out}.rank{r}.json") as fh:
                    verdicts.append(json.load(fh))
            _RUNS[world] = (verdicts, out)
        return _RUNS[world]

    return get


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", [2, 4], ids=["2x2", "4x1"])
def test_ranks_equal_single_process_mesh(rank_runs, world, case):
    verdicts, _ = rank_runs(world)
    assert len(verdicts) == world
    for rank, v in enumerate(verdicts):
        assert v[case] is None, f"rank {rank}: {v[case]}"


def test_rank_written_checkpoints_resume_in_the_jax_package(rank_runs):
    """The files two ranks wrote are the JAX package's formats: its sharded
    graph resumes the ``"hash_shards"`` table and its streamed counter the
    mid-stream one, to the oracle's contigs."""
    import genome_assembler_tpu.parallel.pipeline as jax_pp
    from genome_assembler_tpu.models.oracle import assemble_oracle
    from genome_assembler_tpu.parallel.mesh import build_mesh as jax_mesh
    from genome_assembler_tpu.utils.config import AssemblyConfig as JaxConfig

    _, out = rank_runs(2)
    reads = small_reads()
    want = assemble_oracle(reads, JaxConfig(k=25, read_len=80))
    assert jax_pp.assemble_distributed_sharded(
        np.zeros_like(reads), JaxConfig(k=25, read_len=80), jax_mesh(D),
        resume_from=out + ".hash_ranks.npz",
    ) == want
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
        assert jax_pp.assemble_distributed(
            reads, JaxConfig(k=25, read_len=80, batch_reads=96), jax_mesh(D),
            table_capacity=8192, resume_from=out + ".stream_ranks.npz",
        ) == want


def test_spawn_starts_again_when_the_store_port_is_taken(monkeypatch):
    """A port taken between the probe and rank 0's store (here: held by a
    listening socket) fails that launch with EADDRINUSE; spawn starts the
    ranks again on another port."""
    import socket

    from genome_assembler_tpu_torch.parallel import launch

    held = socket.socket()
    held.bind(("127.0.0.1", 0))
    held.listen()
    ports = [held.getsockname()[1]]
    real, launches = launch.free_port, []
    monkeypatch.setattr(launch, "free_port",
                        lambda: ports.pop() if ports else real())
    run_ranks = launch._run_ranks
    monkeypatch.setattr(launch, "_run_ranks", lambda *a: launches.append(
        run_ranks(*a)) or launches[-1])
    try:
        # world 1: the rank's barrier meets itself and it exits 0
        res = launch.spawn(1, ["--job", "raise"], device="cpu",
                           timeout_s=120.0,
                           entry=(os.path.abspath(__file__),))
    finally:
        held.close()
    assert res.ok, res.describe()
    assert len(launches) == 2 and "EADDRINUSE" in launches[0].stderr[0]


@pytest.mark.parametrize("job,limit", [("raise", 120.0), ("sleep", 4.0)])
def test_spawn_ends_every_rank(job, limit):
    """A rank that raises, or ranks past their limit: every rank is ended
    and the failure is reported, within the limit."""
    t0 = time.perf_counter()
    res = _spawn_self(2, job, None, limit)
    assert time.perf_counter() - t0 < limit + 20
    assert not res.ok
    if job == "raise":
        assert not res.timed_out
        assert res.returncodes[1] == 3 and res.returncodes[0] != 0
        assert "rank 1 (exit 3)" in res.describe()
    else:
        assert res.timed_out and all(rc < 0 for rc in res.returncodes)


def test_two_level_mesh_in_one_process():
    """``hosts`` without a process group is a factorisation only, as on
    the reference's forced CPU platform."""
    reads = small_reads()
    cfg = AssemblyConfig(k=25, read_len=80)
    flat = mesh_mod.build_mesh(8, devices=["cpu"])
    mesh = mesh_mod.build_mesh(8, devices=["cpu"], hosts=2)
    assert mesh_mod.num_hosts(mesh) == 2 and mesh_mod.num_hosts(flat) == 1
    assert mesh_mod.axis_size(mesh) == 8 and mesh.local_size == 8
    assert not mesh.distributed and mesh.first_shard == 0
    assert mesh_mod.is_writer(mesh)
    m = Metrics()
    got = pp.assemble_distributed(reads, cfg, mesh, metrics=m)
    assert got == pp.assemble_distributed(reads, cfg, flat)
    assert got == pp.assemble_distributed_sharded(reads, cfg, mesh)
    assert m.counters["hosts"] == 2 and m.counters["shards"] == 8
    derived = m.derive()
    assert derived["reads_per_s_per_host"] == derived["reads_per_s"] / 2


@pytest.mark.parametrize("d,hosts", [(7, 2), (8, 3), (4, 0)])
def test_uneven_hosts_raise(d, hosts):
    with pytest.raises(ValueError, match="split evenly"):
        mesh_mod.build_mesh(d, devices=["cpu"], hosts=hosts)


def test_init_distributed_reads_only_torch_launch_variables(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    # the reference's switches mean nothing here
    monkeypatch.setenv("GA_DIST", "1")
    monkeypatch.setenv("GA_NUM_PROCESSES", "2")
    monkeypatch.setenv("GA_PROCESS_ID", "0")
    assert mesh_mod.init_distributed("gloo") is False
    assert not mesh_mod.process_group_live()
    with pytest.raises(ValueError, match="world size"):
        mesh_mod.init_distributed("gloo", rank=0)
    with pytest.raises(ValueError, match="backend"):
        mesh_mod.init_distributed("mpi", rank=0, world_size=1)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh_mod.init_distributed("gloo")
    if not torch.cuda.is_available():
        # ranks on cards are the default, and no card is an error, not gloo
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh_mod.init_distributed()
    assert not mesh_mod.process_group_live()


@pytest.fixture
def one_rank_group():
    from genome_assembler_tpu_torch.parallel.launch import free_port

    assert mesh_mod.init_distributed(
        "gloo", rank=0, world_size=1, timeout_s=60.0,
        init_method=f"tcp://127.0.0.1:{free_port()}") is False
    try:
        yield
    finally:
        mesh_mod.shutdown_distributed()
    assert not mesh_mod.process_group_live()


def test_one_rank_group_still_goes_through_torch_distributed(
        one_rank_group, monkeypatch):
    """A process group of one rank with four local shards: the collectives
    are ``torch.distributed`` calls, and the results are the single-process
    mesh's."""
    import torch.distributed as dist

    calls = {"all_to_all_single": 0, "all_gather_into_tensor": 0,
             "all_reduce": 0}
    for name in calls:
        real = getattr(dist, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(dist, name, counted)
    assert mesh_mod.init_distributed("gloo") is False  # idempotent
    mesh = mesh_mod.build_mesh(D, devices=["cpu"])
    assert mesh.distributed and mesh.hosts == 1 and mesh.local_size == D
    with pytest.raises(ValueError, match="process group"):
        mesh_mod.build_mesh(D, devices=["cpu"], hosts=2)
    reads = small_reads()
    cfg = AssemblyConfig(k=25, read_len=80)
    m = Metrics()
    got = pp.assemble_distributed_sharded(reads, cfg, mesh, metrics=m)
    assert all(n > 0 for n in calls.values()), calls
    assert got == pp.assemble_distributed_sharded(reads, cfg, flat_mesh())
    assert got == pp.assemble_distributed(reads, cfg, mesh)
    assert m.counters["hosts"] == 1


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
