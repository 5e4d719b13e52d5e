"""Find a cell of ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix. Each lives in a file of
its own, found by name: ``configs/<config>.json`` and
``traffic/<traffic>.json``. A configuration names the entry point the
window calls (``entries/<entry>.py``) and the plain reference that
decides ``correct`` (``references/<reference>.py``); a per-layer metric
is read by ``layer_metrics/<metric>.py``. Adding a cell, a mix, a
configuration or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the metrics a ``--trace 0`` run reports
    per_layer: list[dict]  # the metrics a ``--trace 1`` run reports


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def read_json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    """``<bench_dir>/<kind>/<name>.json``, whose ``name`` must be ``name``."""
    path = os.path.join(bench_dir, kind, f"{name}.json")
    with open(path) as fh:
        data = json.load(fh)
    if data.get("name") != name:
        raise ValueError(f"{path} names itself {data.get('name')!r}")
    return data


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """The Python file ``<bench_dir>/<kind>/<name>.py`` as a module (a
    metric's name holds dots, so it is loaded by path, not imported)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    key = f"_bench_{kind}_{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[key]
        raise
    return module


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The workload ``name`` of ``bench`` with its configuration, mix and
    metrics. An end-to-end metric without ``workloads`` is every cell's;
    a per-layer metric without it is every cell's that reports the
    end-to-end metric it ``moves``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _listed(m, name) and m["moves"] in e2e_names]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=read_json("configs", w["config"], bench_dir),
        traffic=read_json("traffic", w["traffic"], bench_dir),
        end_to_end=e2e,
        per_layer=per_layer,
    )
