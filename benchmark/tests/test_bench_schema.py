"""The result's last line: its keys, the metrics of each trace mode with
their units, the numbers compared last; and ``run.py``'s refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, tiny_cell

from harness import runner

ROOT = os.path.dirname(BENCH)


def test_untraced_line():
    cell = tiny_cell()
    out, lines = runner.run(cell, 2**32 + 1, 0.3, False, "cpu")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert set(out["metrics"]) == set(units) == {
        "assembly_s", "assembly_p90_s", "setup_s"}
    for name, m in out["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    # set-up's steps, each timed once, add up to setup_s
    steps = out["setup_steps_s"]
    assert list(steps)[-1] == "first_assembly"
    assert sum(steps.values()) == pytest.approx(
        out["metrics"]["setup_s"]["value"])
    # the first assembly and at most runner.KEEP of the window's
    assert 2 <= out["attempted"] <= runner.KEEP + 1
    for name, check in out["checks"].items():
        assert set(check) == {"value", "limit"}
        assert any(line.startswith(f"check {name}:") for line in lines)
    json.dumps(out)


def test_traced_line():
    cell = tiny_cell("ecoli_k12_k31.200x", coverage=30)
    out, _ = runner.run(cell, 2**32 + 2, 0.3, True, "cpu")
    names = {m["name"] for m in cell.per_layer}
    # the CPU has no device trace: those readers find nothing
    assert set(out["metrics"]) == names - {
        "count.busy_frac", "extract_roofline", "device.idle_frac",
        "device.peak_gib"}
    assert "assembly_p90_s" not in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    assert list(out)[-1] == "checks"


def _run_py(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ecoli_k12_k31.50x", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_run_without_a_card_prints_no_result():
    proc = _run_py(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_run_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
