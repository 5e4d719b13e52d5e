"""BENCHMARK.json and the files it names: found by name, and within the
limits of the benchmark's format."""

import json
import os
import re

import pytest
from conftest import BENCH

from harness import cells

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark(ROOT)


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = cells.find_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        names = {m["name"] for m in cell.end_to_end}
        assert {"setup_s", "assembly_s"} <= names
        assert cell.per_layer
        cells.load_module("entries", cell.config["entry"])
        ref = cells.load_module("references", cell.config["reference"])
        assert set(ref.LIMITS) and all(v == 0 for v in ref.LIMITS.values())


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        reader = cells.load_module("layer_metrics", m["name"])
        assert callable(reader.read)


def test_metric_lists_follow_the_workloads_key(bench):
    tail = cells.find_cell(bench, "ecoli_k12_k31.50x")
    other = cells.find_cell(bench, "yeast_s288c_k31.100x")
    assert "assembly_p90_s" in {m["name"] for m in tail.end_to_end}
    assert "assembly_p90_s" not in {m["name"] for m in other.end_to_end}
    assert {m["name"] for m in other.per_layer} == {
        m["name"] for m in bench["per_layer"]}


def test_unknown_names_are_refused(bench):
    with pytest.raises(KeyError):
        cells.find_cell(bench, "no_such.cell")
    with pytest.raises(FileNotFoundError):
        cells.load_module("layer_metrics", "no_such_metric")


def test_format_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["benchmark"]
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
