"""``bench_torch.py``, the port's benchmark harness, on the CPU: its one
JSON line, its non-timing fields against ``bench.py``'s (the JAX harness,
run as a subprocess on the CPU at the same size), the table its timed
function counts against the JAX package's ``_count_batch``, and its
refusal to run without CUDA unless ``--device cpu`` is given."""

import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembler_tpu.models.pipeline import _count_batch as jax_count
from genome_assembler_tpu.utils.dna import pack_codes as jax_pack_codes
from genome_assembler_tpu_torch.ops import count_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_GENOME, SMALL_COVERAGE = 10_000, 30
PORT_ARGS = ["--genome-len", "10000", "--coverage", "30", "--reps", "1",
             "--baseline-windows", "2000"]
JAX_ENV = {"GA_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu",
           "GA_BENCH_GENOME": "10000", "GA_BENCH_COVERAGE": "30",
           "GA_BENCH_REPS": "1", "GA_BENCH_BASELINE_WINDOWS": "2000"}
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
NON_TIMING = ("k", "reads", "windows", "contigs", "n50", "exact_match")
# detail keys of bench.py whose meaning carries over to the port
CARRIED = {
    "backend", "device", "k", "reads", "windows", "best_s", "warmup_s",
    "host_to_device_s", "reference_python_kmers_per_s",
    "min_traffic_roofline_frac", "measured_stream_bw_gb_s",
    "frac_of_measured_bw", "sort_floor_s", "frac_of_sort_floor",
    "assemble_s", "assemble_reads_per_s", "assemble_stages_s",
    "assemble_cold_s", "assemble_cold_stages_s", "contigs", "n50",
    "exact_match", "stream_count_s", "single_shot_with_transfer_s",
    "stream_vs_single_shot",
}


def load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(REPO, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(args, env=None, cwd=REPO):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, **(env or {})),
    )


@pytest.fixture(scope="module")
def port_line():
    proc = run_script(["bench_torch.py", *PORT_ARGS, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


def test_one_json_line_of_bench_py_shape(port_line):
    assert set(port_line) == TOP_KEYS
    assert port_line["metric"] == "kmer_count_throughput"
    assert port_line["unit"] == "kmers/s"
    assert port_line["value"] > 0 and port_line["vs_baseline"] > 0
    detail = port_line["detail"]
    assert CARRIED <= set(detail)
    assert detail["backend"] == "cpu" and detail["device"] == "cpu"
    # no card, so no build, no kernel and no device roofline
    assert detail["card"] is None and detail["build_s"] is None
    assert detail["extract_kernel_s"] is None
    assert detail["min_traffic_roofline_frac"] is None
    assert detail["extract_plain_s"] > 0 and detail["extract_bound_s"] > 0
    assert detail["extract_launches"] == {
        "count": 0, "extraction": 0, "stream": 0, "assemble": 0}
    assert detail["pack_launches"] == detail["extract_launches"]
    assert detail["stream_table_equal"] is True
    assert len(detail["count_s"]) == 1
    assert detail["best_s"] == min(detail["count_s"])
    assert port_line["value"] == pytest.approx(
        detail["windows"] / detail["best_s"])
    assert set(detail["assemble_stages_s"]) == {
        "count", "filter", "compress", "spell", "simplify", "traverse"}


def test_non_timing_fields_equal_bench_py(port_line, tmp_path):
    proc = run_script(["bench.py"], env=dict(
        JAX_ENV, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(want) == TOP_KEYS
    assert {n: port_line["detail"][n] for n in NON_TIMING} == {
        n: want["detail"][n] for n in NON_TIMING}
    assert port_line["detail"]["exact_match"] is True
    assert CARRIED <= set(want["detail"])


@pytest.mark.parametrize("k", [31, 41])
def test_timed_count_equals_jax_count_batch(k):
    bench = load_bench()
    _, reads = bench.workload(SMALL_GENOME, SMALL_COVERAGE)
    assert reads.shape == (3000, bench.READ_LEN)
    got = bench.count_once(torch.from_numpy(bench.pack_codes(reads)), k)
    want = jax_count(jnp.asarray(jax_pack_codes(reads)), k,
                     np.int32(reads.shape[0]), read_len=bench.READ_LEN)
    words, counts, num, over = count_torch.count_table_to_numpy(got, k)
    assert int(num) == int(want.num_unique) > 0
    assert not bool(over) and not bool(want.overflow)
    n = int(num)
    np.testing.assert_array_equal(words[:n], np.asarray(want.words)[:n])
    np.testing.assert_array_equal(counts[:n], np.asarray(want.counts)[:n])


def test_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the refusal cannot show")
    proc = run_script([os.path.join(REPO, "bench_torch.py"), *PORT_ARGS],
                      cwd=str(tmp_path))
    assert proc.returncode == 1
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["value"] == 0 and line["vs_baseline"] == 0
    assert "CUDA is not available" in line["error"]
    assert "Traceback" in proc.stderr
