"""The ``ga-torch`` command line against ``ga-tpu`` on the same arguments:
``simulate`` byte for byte, ``assemble --backend oracle`` / ``--gfa`` /
``--stats`` outputs equal, ``stats``, ``accept``, the trace of
``--trace-dir`` and the report of ``--metrics-out`` (exact: files,
strings and integers)."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from genome_assembler_tpu.cli import main as ga_tpu
from genome_assembler_tpu.utils.dna import decode_seq
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch import cli
from genome_assembler_tpu_torch.utils.metrics import TRACE_FILE, read_trace

torch.set_num_threads(1)

STAGES = {"count", "filter", "compress", "spell", "simplify", "traverse"}


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    """3 kb, 30x, 1% errors: a graph with tips to clip."""
    rs = simulate_reads(simulate_genome(3000, seed=61), coverage=30,
                        read_len=100, seed=62, error_rate=0.01, tile_k=25)
    path = tmp_path_factory.mktemp("cli") / "reads.txt"
    path.write_text("\n".join(decode_seq(r) for r in rs.codes) + "\n")
    return str(path)


SIM_ARGS = {
    "preset": ["--preset", "toy10k", "--coverage", "12"],
    "errors_single_strand": ["--genome-len", "3000", "--coverage", "20",
                             "--error-rate", "0.01", "--single-strand",
                             "--read-len", "80", "--read-seed", "9"],
    "chromosomes": ["--genome-len", "6000", "--chromosomes", "3",
                    "--coverage", "10", "--genome-seed", "7"],
    "circular": ["--genome-len", "2500", "--coverage", "15", "--circular"],
}


@pytest.mark.parametrize("case", sorted(SIM_ARGS))
def test_simulate_equals_ga_tpu(tmp_path, capsys, case):
    out = {}
    for name, main in (("torch", cli.main), ("tpu", ga_tpu)):
        reads, genome = (str(tmp_path / f"{name}.{ext}")
                         for ext in ("txt", "fa"))
        assert main(["simulate", *SIM_ARGS[case], "--out", reads,
                     "--genome-out", genome]) == 0
        out[name] = (_read(reads), _read(genome), capsys.readouterr().err)
    assert out["torch"] == out["tpu"]
    assert out["torch"][0].count(b"\n") > 100


def test_simulate_to_stdout(capsys):
    assert cli.main(["simulate", "--genome-len", "500", "--coverage", "8"]) == 0
    got = capsys.readouterr().out
    assert ga_tpu(["simulate", "--genome-len", "500", "--coverage", "8"]) == 0
    assert got == capsys.readouterr().out and got


@pytest.mark.parametrize("emit", ["unitigs", "euler"])
def test_oracle_backend_equals_ga_tpu(reads_file, tmp_path, emit):
    a, b = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    args = ["assemble", "--reads", reads_file, "-k", "25", "--min-count", "3",
            "--backend", "oracle", "--emit", emit]
    # the oracle touches no device: the default --device cuda is not resolved
    assert cli.main(args + ["--out", a]) == 0
    assert ga_tpu(args + ["--out", b]) == 0
    assert _read(a) == _read(b) and _read(a)


def test_oracle_backend_takes_ragged_reads(tmp_path):
    rng = np.random.default_rng(3)
    genome = decode_seq(rng.integers(0, 4, 600).astype(np.uint8))
    reads = [genome[i : i + 50 + (i % 7)] for i in range(0, 540, 3)]
    path = tmp_path / "ragged.txt"
    path.write_text("\n".join(reads) + "\n")
    a, b = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    args = ["assemble", "--reads", str(path), "-k", "21", "--backend", "oracle"]
    assert cli.main(args + ["--out", a]) == 0
    assert ga_tpu(args + ["--out", b]) == 0
    assert _read(a) == _read(b) and _read(a)
    # the device backend pads them and masks the padding: the same contigs
    c = str(tmp_path / "c.fa")
    assert cli.main(["assemble", "--reads", str(path), "-k", "21", "--device",
                     "cpu", "--out", c]) == 0
    assert cli.read_sequences(c) == cli.read_sequences(a)


@pytest.mark.parametrize("backend", ["torch", "dist"])
def test_gfa_stats_and_fasta_equal_ga_tpu(reads_file, tmp_path, capsys,
                                          backend):
    base = ["assemble", "--reads", reads_file, "-k", "25", "--min-count", "3",
            "--stats"]
    t = {n: str(tmp_path / f"t.{n}") for n in ("fa", "gfa")}
    j = {n: str(tmp_path / f"j.{n}") for n in ("fa", "gfa")}
    place = (["--device", "cpu"] if backend == "torch"
             else ["--backend", "dist", "--devices", "2", "--device", "cpu"])
    assert cli.main(base + place + ["--out", t["fa"], "--gfa", t["gfa"]]) == 0
    t_err = capsys.readouterr().err
    jax_backend = "tpu" if backend == "torch" else "dist"
    assert ga_tpu(base + ["--backend", jax_backend, "--devices", "2",
                          "--out", j["fa"], "--gfa", j["gfa"]]) == 0
    j_err = capsys.readouterr().err
    assert _read(t["fa"]) == _read(j["fa"])
    assert _read(t["gfa"]) == _read(j["gfa"]) and _read(t["gfa"])
    stats_line = lambda err: next(ln for ln in err.splitlines()
                                  if ln.startswith("{"))
    assert stats_line(t_err) == stats_line(j_err)
    assert json.loads(stats_line(t_err))["contigs"] >= 1
    # ga-torch stats on the written file: the same line on stdout
    assert cli.main(["stats", t["fa"]]) == 0
    got = capsys.readouterr().out
    assert ga_tpu(["stats", j["fa"]]) == 0
    assert got == capsys.readouterr().out == stats_line(t_err) + "\n"


@pytest.mark.parametrize("backend", ["torch", "dist", "sharded_graph"])
def test_trace_dir_and_metrics_out(reads_file, tmp_path, backend):
    place = {"torch": [], "dist": ["--backend", "dist", "--devices", "2"],
             "sharded_graph": ["--backend", "dist", "--devices", "2",
                               "--sharded-graph"]}[backend]
    trace_dir, metrics = str(tmp_path / "trace"), str(tmp_path / "m.json")
    assert cli.main(["assemble", "--reads", reads_file, "-k", "25",
                     "--min-count", "3", "--device", "cpu", *place,
                     "--out", str(tmp_path / "c.fa"), "--trace-dir",
                     trace_dir, "--metrics-out", metrics]) == 0
    assert os.listdir(trace_dir) == [TRACE_FILE]
    trace = read_trace(trace_dir)
    assert STAGES <= set(trace.stages)
    assert all(len(spans) == 1 for name, spans in trace.stages.items()
               if name in STAGES)
    assert trace.device == [] and trace.kernel_names() == set()
    busy, wall = trace.busy_share("count")
    assert busy == 0.0 and wall > 0
    with open(metrics) as fh:
        report = json.load(fh)
    assert {"stages_s", "counters", "derived", "device"} <= set(report)
    assert set(report["stages_s"]) == STAGES
    assert report["counters"]["reads"] > 0 and report["device"] == "cpu"
    assert report["derived"]["kmers_per_s"] > 0
    # the CPU packs with the plain version: no pack kernel launched
    assert report["pack_launches"] == 0
    assert report["insert_launches"] == 0
    # stage wall times in the trace and in the report are the same clocks
    assert 0 < wall <= report["stages_s"]["count"] + 0.01
    if backend == "torch":
        assert report["derived"]["count_bytes_per_s"] > 0
        assert 0 <= report["derived"]["hbm_roofline_frac"] < 1
        assert "shards" not in report
        # the batches in which the device found an N (the simulated
        # reads hold none)
        assert report["counters"]["ambiguous_batches"] == 0
    else:
        assert report["shards"] == 2
        assert report["shard_devices"] == ["cpu", "cpu"]
        assert report["counters"]["h2d_bytes_reads"] > 0


def test_no_trace_without_the_flag(reads_file, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GA_TRACE_DIR", str(tmp_path / "env_trace"))
    assert cli.main(["assemble", "--reads", reads_file, "-k", "25",
                     "--device", "cpu", "--out", "c.fa"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["c.fa"]


def test_read_trace_busy_share(tmp_path):
    """Overlapping and nested device intervals count once; work outside
    the stage's span is not the stage's."""
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                     "ts": ts, "dur": dur}
    events = [
        ev("user_annotation", "count", 100.0, 1000.0),
        ev("gpu_user_annotation", "count", 100.0, 1000.0),
        ev("kernel", "a", 150.0, 100.0),
        ev("kernel", "b", 200.0, 100.0),     # overlaps a
        ev("gpu_memcpy", "copy", 210.0, 20.0),  # inside b
        ev("kernel", "c", 600.0, 50.0),
        ev("kernel", "late", 1200.0, 50.0),  # after the stage
        ev("cpu_op", "aten::add", 150.0, 5.0),
        {"ph": "M", "name": "process_name"},
    ]
    path = tmp_path / TRACE_FILE
    path.write_text(json.dumps({"traceEvents": events}))
    trace = read_trace(str(tmp_path))
    assert trace.kernel_names() == {"a", "b", "copy", "c", "late"}
    busy, wall = trace.busy_share("count")
    assert wall == pytest.approx(1000e-6)
    assert busy == pytest.approx((150 + 50) * 1e-6)


def test_accept_command(capsys):
    assert cli.main(["accept", "0", "1", "--scale", "0.01", "--device",
                     "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["config"] for ln in lines] == [0, 1]
    assert all(json.loads(ln)["passed"] for ln in lines)


def test_accept_exit_code_when_a_runner_fails(monkeypatch, capsys):
    import genome_assembler_tpu_torch.models.acceptance as acc

    monkeypatch.setattr(acc, "errored_run_ok", lambda *a, **kw: False)
    assert cli.main(["accept", "1", "--scale", "0.01", "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out)["passed"] is False


def test_accept_without_a_card_is_an_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert cli.main(["accept", "0", "--scale", "0.01"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_verbose_logs_the_stages(reads_file, tmp_path, caplog):
    root = logging.getLogger()
    level, handlers = root.level, root.handlers[:]
    try:
        with caplog.at_level(logging.DEBUG, "genome_assembler_tpu_torch"):
            assert cli.main(["-v", "assemble", "--reads", reads_file, "-k",
                             "25", "--device", "cpu", "--out",
                             str(tmp_path / "c.fa")]) == 0
    finally:
        root.setLevel(level)
        root.handlers[:] = handlers
    logged = {r.getMessage().split(":")[0] for r in caplog.records}
    assert {f"stage {name}" for name in STAGES} <= logged


def test_flags_that_the_port_does_not_have():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["assemble", "--pallas", "1"])
    # the merge stride is the port's too since deferred merges came over
    assert cli.build_parser().parse_args(
        ["assemble", "--merge-stride", "2"]).merge_stride == 2
    with pytest.raises(ValueError, match="--backend dist"):
        cli.cmd_assemble(cli.build_parser().parse_args(
            ["assemble", "--preset", "toy10k", "--device", "cpu",
             "--sharded-graph"]))


def test_hosts_reaches_build_mesh(reads_file, tmp_path, monkeypatch):
    """``--hosts`` parses, reaches ``build_mesh`` and shows in the metrics:
    in one process it is a factorisation of ``--devices`` only."""
    from genome_assembler_tpu_torch.parallel import mesh as mesh_mod

    seen = []
    real = mesh_mod.build_mesh

    def build_mesh(num_shards=None, devices=None, hosts=None):
        seen.append((num_shards, hosts))
        return real(num_shards, devices=devices, hosts=hosts)

    monkeypatch.setattr(mesh_mod, "build_mesh", build_mesh)
    outs = {}
    for name, extra in (("flat", []), ("hosts", ["--hosts", "2"])):
        outs[name] = tmp_path / f"{name}.fa"
        assert cli.main(["assemble", "--reads", reads_file, "-k", "25",
                         "--device", "cpu", "--backend", "dist", "--devices",
                         "4", *extra, "--out", str(outs[name]), "--metrics-out",
                         str(tmp_path / f"{name}.json")]) == 0
    assert seen == [(4, None), (4, 2)]
    assert _read(outs["flat"]) == _read(outs["hosts"])
    with open(tmp_path / "hosts.json") as fh:
        report = json.load(fh)
    assert report["hosts"] == 2 and report["counters"]["hosts"] == 2
    assert report["rank"] == 0 and report["local_shards"] == [0, 1, 2, 3]
    assert report["derived"]["reads_per_s_per_host"] == pytest.approx(
        report["derived"]["reads_per_s"] / 2, rel=1e-3)
    with open(tmp_path / "flat.json") as fh:
        assert json.load(fh)["hosts"] == 1


@pytest.mark.parametrize("argv,message", [
    (["--backend", "dist", "--devices", "4", "--hosts", "3"], "split evenly"),
    (["--hosts", "2"], "--backend dist"),
])
def test_hosts_errors(reads_file, capsys, argv, message):
    assert cli.main(["assemble", "--reads", reads_file, "-k", "25",
                     "--device", "cpu", *argv]) == 2
    assert message in capsys.readouterr().err


def test_accept_sets_the_weak_scaling_bar(capsys):
    """The bar of config 4 from the command line, in the JSON."""
    args = ["accept", "4", "--scale", "0.001", "--device", "cpu", "--devices",
            "2"]
    assert cli.main(args) == 0
    assert json.loads(capsys.readouterr().out)["weak_scaling_bar"] is None
    # shards of one CPU share it: an efficiency of 0.5 is out of reach ...
    rc = cli.main(args + ["--enforce-weak-scaling", "--weak-scaling-min",
                          "0.5"])
    line = json.loads(capsys.readouterr().out)
    assert line["weak_scaling_bar"] == 0.5
    assert line["passed"] == (line["weak_scaling_eff"]["2"] >= 0.5)
    assert rc == (0 if line["passed"] else 1)
    # ... and the default is the reference's 0.8
    assert cli.build_parser().parse_args(
        ["accept", "4", "--enforce-weak-scaling"]).weak_scaling_min == 0.8


def test_accept_multiprocess_runs_a_rank_a_shard(capsys):
    """``accept 4 6 --multiprocess`` on the CPU: every sharded point is
    ranks over gloo, and the bars are the same."""
    assert cli.main(["accept", "4", "6", "--scale", "0.001", "--device",
                     "cpu", "--devices", "2", "--multiprocess",
                     "--enforce-weak-scaling", "--weak-scaling-min",
                     "0.001"]) == 0
    four, six = (json.loads(ln) for ln in
                 capsys.readouterr().out.strip().splitlines())
    assert four["config"] == 4 and four["passed"] and four["multiprocess"]
    assert four["devices"] == [1, 2] and four["weak_scaling_bar"] == 0.001
    assert four["counts_match_host"] and four["oracle_cross_checked"]
    assert four["sharded_run_metrics"]["counters"]["hosts"] == 2
    assert six["config"] == 6 and six["passed"] and six["multiprocess"]
    assert six["sharded_run_metrics"]["counters"]["hosts"] == 2


def test_bucketed_choices(capsys):
    """``--bucketed`` takes the JAX CLI's three choices and refuses others."""
    for cmd in (["assemble"], ["reshard", "x.npz", "--out", "y.npz",
                               "--devices", "2", "--reads", "r.txt"]):
        for choice in ("auto", "on", "off"):
            assert cli.build_parser().parse_args(
                cmd + ["--bucketed", choice]).bucketed == choice
        assert cli.build_parser().parse_args(cmd).bucketed == "auto"
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(cmd + ["--bucketed", "1"])
        assert "invalid choice" in capsys.readouterr().err


@pytest.fixture()
def streamed_reads_file(tmp_path):
    rs = simulate_reads(simulate_genome(2000, seed=63), coverage=12,
                        read_len=60, seed=64)
    path = tmp_path / "streamed.txt"
    path.write_text("\n".join(decode_seq(r) for r in rs.codes) + "\n")
    return str(path), rs.codes


@pytest.mark.parametrize("backend", ["torch", "dist", "sharded_graph"])
def test_bucketed_on_and_off_give_the_same_contigs(streamed_reads_file,
                                                   tmp_path, monkeypatch,
                                                   backend):
    import genome_assembler_tpu_torch.parallel.pipeline as pp

    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    reads, _ = streamed_reads_file
    place = {"torch": [], "dist": ["--backend", "dist", "--devices", "2"],
             "sharded_graph": ["--backend", "dist", "--devices", "2",
                               "--sharded-graph"]}[backend]
    outs = {}
    for choice in ("on", "off"):
        outs[choice] = str(tmp_path / f"{choice}.fa")
        assert cli.main(["assemble", "--reads", reads, "-k", "15",
                         "--device", "cpu", "--batch-reads", "64",
                         "--table-capacity", "8192", *place, "--bucketed",
                         choice, "--out", outs[choice]]) == 0
    assert _read(outs["on"]) == _read(outs["off"]) and _read(outs["on"])


def test_reshard_takes_a_bucketed_checkpoint(streamed_reads_file, tmp_path,
                                             monkeypatch):
    """A 4-shard bucketed snapshot resharded to 2 shards (into the
    bucketed layout and into the flat one) resumes to the uninterrupted
    run's contigs."""
    import genome_assembler_tpu_torch.parallel.pipeline as pp
    from genome_assembler_tpu_torch.parallel.mesh import build_mesh
    from genome_assembler_tpu_torch.utils.config import AssemblyConfig

    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    reads_file, codes = streamed_reads_file
    base = ["assemble", "--reads", reads_file, "-k", "15", "--backend",
            "dist", "--device", "cpu", "--batch-reads", "64",
            "--table-capacity", "8192"]
    full = str(tmp_path / "full.fa")
    assert cli.main(base + ["--devices", "4", "--out", full]) == 0
    ck = str(tmp_path / "mid.npz")
    with pytest.raises(RuntimeError, match="fault injection"):
        pp.distributed_count_table(
            codes, AssemblyConfig(k=15, read_len=60, batch_reads=64),
            build_mesh(4, devices=["cpu"]), table_capacity=8192,
            stream_checkpoint=ck, stream_checkpoint_every=4,
            abort_after_batch=5, bucketed="on")
    with np.load(ck) as z:
        assert int(z["bucketed"]) == 1 and z["words"].ndim == 3
    for choice in ("on", "off"):
        ck2 = str(tmp_path / f"mid2_{choice}.npz")
        out = str(tmp_path / f"c_{choice}.fa")
        assert cli.main(["reshard", ck, "--out", ck2, "--devices", "2",
                         "--reads", reads_file, "-k", "15", "--batch-reads",
                         "64", "--table-capacity", "8192", "--bucketed",
                         choice]) == 0
        with np.load(ck2) as z:
            assert int(z["bucketed"]) == (choice == "on")
        assert cli.main(base + ["--devices", "2", "--resume-from", ck2,
                                "--bucketed", choice, "--out", out]) == 0
        assert _read(out) == _read(full)
