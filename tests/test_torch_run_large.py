"""``tools/run_large_torch.py``, the port of ``tools/run_large.py``, on
the CPU: its JSON line's non-timing fields against the JAX tool's (run as
subprocesses on the CPU at 0.02 Mb, 30x, k=31, without and with a merge
stride), its device k-mer content check against the JAX package's host
``kmer_content_equal``, and its refusal to run without CUDA unless
``--device cpu`` is given."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from genome_assembler_tpu.host.traverse import kmer_content_equal
from genome_assembler_tpu.utils.dna import decode_seq, revcomp_str
from genome_assembler_tpu.utils.simulate import simulate_genome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["0.02", "30", "31"]
STRIDES = {"no_stride": [], "stride_2": ["2"]}
NON_TIMING = ("genome_mb", "coverage", "k", "reads", "windows", "contigs",
              "n50", "exact_single_contig", "exact_kmer_content")
KEYS = set(NON_TIMING) | {"cold_s", "warm_s", "reads_per_s", "stages_s",
                          "warm_runs"}


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "run_large_torch", os.path.join(REPO, "tools", "run_large_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_lines(tmp_path_factory):
    """run_large.py's lines, both strides at once (about 30 s each)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(
        tmp_path_factory.mktemp("jax_cache")))
    procs = {
        name: subprocess.Popen(
            [sys.executable, os.path.join("tools", "run_large.py"), *ARGS,
             *extra], cwd=REPO, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, extra in STRIDES.items()
    }
    lines = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            lines[name] = last_json(out)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return lines


@pytest.mark.parametrize("stride", sorted(STRIDES))
def test_non_timing_fields_equal_run_large_py(jax_lines, stride):
    proc = subprocess.run(
        [sys.executable, os.path.join("tools", "run_large_torch.py"), *ARGS,
         *STRIDES[stride], "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got, want = last_json(proc.stdout), jax_lines[stride]
    assert KEYS <= set(got) and KEYS <= set(want)
    assert {n: got[n] for n in NON_TIMING} == {n: want[n] for n in NON_TIMING}
    assert got["reads"] == 6000 and got["windows"] == 420_000
    assert got["contigs"] == 1 and got["exact_single_contig"] is True
    assert got["exact_kmer_content"] is True
    assert got["device"] == "cpu" and got["card"] is None
    assert got["peak_gib"] is None and got["extract_launches"] == 0
    assert got["pack_launches"] == 0
    # one batch of 6,000 reads: no stride is taken, the table stays flat
    assert got["merge_stride"] == 1 and got["bucketed"] is False
    assert got["table_capacity"] == 65_536
    assert [r["warm_s"] for r in got["warm_runs"]] == [got["warm_s"]]


def _genome(n, seed):
    return decode_seq(simulate_genome(n, seed=seed))


CONTENT_CASES = {
    # name: (k, contigs from the genome g)
    "whole": (31, lambda g: [g]),
    "reverse_complement": (31, lambda g: [revcomp_str(g)]),
    "split_with_overlap": (31, lambda g: [g[:3000], g[3000 - 30:]]),
    "two_limbs": (41, lambda g: [g[:2500], revcomp_str(g[2500 - 40:])]),
    "short_contig_ignored": (31, lambda g: [g, "ACGT"]),
    "missing_kmer": (31, lambda g: [g[:-1]]),
    "foreign_kmer": (31, lambda g: [g[:4000] + "A" * 40]),
    "spelled_twice": (31, lambda g: [g, g[:500]]),
    "empty": (31, lambda g: []),
    "only_short": (31, lambda g: ["ACGTACGT"]),
}


@pytest.mark.parametrize("case", sorted(CONTENT_CASES))
def test_kmer_content_equal_device_matches_host(case):
    tool = load_tool()
    k, make = CONTENT_CASES[case]
    genome = _genome(5000, seed=31)
    contigs = make(genome)
    want = kmer_content_equal(contigs, genome, k)
    got = tool.kmer_content_equal_device(contigs, genome, k,
                                         torch.device("cpu"))
    assert got is want
    assert want is (case in ("whole", "reverse_complement",
                             "split_with_overlap", "two_limbs",
                             "short_contig_ignored"))


@pytest.mark.parametrize("k", [21, 31, 41])
def test_canonical_keys_cover_every_window_in_order(k, monkeypatch):
    """A sequence cut into rows of a few windows (several rows, a padded
    last one) gives the keys of its windows in order, equal to the
    sequence extracted as one read."""
    tool = load_tool()
    monkeypatch.setattr(tool, "ROW_WINDOWS", 7)
    seq = _genome(250, seed=k)
    got = tool.canonical_keys(seq, k, torch.device("cpu"))
    read = torch.from_numpy(tool.encode_seq(seq))[None, :]
    want = tool.kmer.extract_canonical_flat(
        tool.pack_on_device(read).packed, len(seq), k)
    assert got.shape == (len(seq) - k + 1, want.shape[1])
    assert torch.equal(got, want)


def test_traced_run_reads_its_own_trace(tmp_path):
    """``--trace-dir``: one more warm run under the profiler; its stage
    spans are read back from the trace (no device on the CPU, so no busy
    time), and the launch count and warm runs leave it out."""
    tool = load_tool()
    line = tool.run(tool.parse_args(
        [*ARGS, "--device", "cpu", "--trace-dir", str(tmp_path / "tr")]))
    assert (tmp_path / "tr" / "trace.json").exists()
    stages = {"count", "filter", "compress", "spell", "simplify", "traverse"}
    assert set(line["traced"]["stages_s"]) == stages
    assert line["traced"]["device_busy_s"] == dict.fromkeys(stages, 0.0)
    assert len(line["warm_runs"]) == 1 and line["exact_single_contig"]


def test_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the refusal cannot show")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "run_large_torch.py"),
         *ARGS], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA is not available" in proc.stderr
