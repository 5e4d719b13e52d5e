"""Structured per-stage metrics (SURVEY.md §5 observability).

The port's copy of the reference package's ``utils/metrics.py``: the
``Metrics`` class as it is there, and ``torch.profiler`` in the place of
that module's JAX profiler helpers. It emits structured per-stage
wall-clock + throughput counters consumable by the bench configs
(BASELINE.md CFG 2-4): k-mers/s, reads/s, bytes/s vs the HBM roofline,
all-to-all volume, weak-scaling efficiency.

Tracing: every stage runs inside ``torch.profiler.record_function(name)``
(next to free while no profiler is on), and ``profiler_trace(trace_dir)``
wraps a run in ``torch.profiler.profile`` and writes one Chrome trace,
``trace_dir/TRACE_FILE``. ``read_trace`` reads such a file back: the
stage spans, the device's kernels and copies, and the device's busy share
of a stage.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field

import torch

log = logging.getLogger("genome_assembler_tpu_torch")

HBM_PEAK_BYTES_S = 3.35e12  # NVIDIA H100 SXM, 80 GB HBM3 (data sheet)
TRACE_FILE = "trace.json"


@dataclass
class Metrics:
    """Accumulates per-stage timings and counters for one pipeline run."""

    stages: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a pipeline stage; nested stages accumulate independently.
        The stage is a ``record_function`` span of a profiler trace."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        dt = time.perf_counter() - t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        log.debug("stage %s: %.3fs", name, dt)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def derive(self) -> dict[str, float]:
        """Throughputs derived from counters + timings."""
        out: dict[str, float] = {}
        total = sum(self.stages.values())
        if total > 0:
            if "kmers" in self.counters:
                out["kmers_per_s"] = self.counters["kmers"] / total
            if "reads" in self.counters:
                out["reads_per_s"] = self.counters["reads"] / total
        hosts = self.counters.get("hosts")
        if hosts and hosts > 0 and "reads_per_s" in out:
            # weak-scaling bookkeeping (BASELINE.md): pod runs report
            # per-host throughput so efficiency is a config change to read
            out["reads_per_s_per_host"] = out["reads_per_s"] / hosts
        count_s = self.stages.get("count")
        if count_s and "count_bytes" in self.counters:
            out["count_bytes_per_s"] = self.counters["count_bytes"] / count_s
            out["hbm_roofline_frac"] = (
                out["count_bytes_per_s"] / HBM_PEAK_BYTES_S
            )
        return out

    def report(self) -> dict:
        return {
            "stages_s": {k: round(v, 4) for k, v in self.stages.items()},
            "counters": self.counters,
            "derived": {k: round(v, 3) for k, v in self.derive().items()},
        }

    def dump(self, path: str | None = None) -> str:
        text = json.dumps(self.report(), indent=2)
        if path:
            with open(path, "w") as fh:
                fh.write(text + "\n")
        return text


@contextlib.contextmanager
def profiler_trace(trace_dir: str | None = None):
    """Whole-run ``torch.profiler`` trace: host activities and, when a
    card is there, the device's. Writes ``trace_dir/TRACE_FILE`` (Chrome
    trace format, readable by Perfetto and ``read_trace``) when the run
    ends; without a ``trace_dir`` it does nothing."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


@dataclass
class Trace:
    """What ``read_trace`` keeps of a Chrome trace; times in microseconds."""

    stages: dict[str, list[tuple[float, float]]]  # name -> host (start, end)
    device: list[tuple[float, float, str]]  # kernels and copies (start, end, name)

    def kernel_names(self) -> set[str]:
        return {name for _, _, name in self.device}

    def busy_share(self, stage: str) -> tuple[float, float]:
        """(device-busy seconds, wall seconds) of every span of ``stage``:
        the union of the device's kernel and copy intervals that begin
        inside the span, over the span. A stage closes with a device
        synchronise, so its device work ends inside it."""
        busy = wall = 0.0
        work = sorted(self.device)
        for lo, hi in self.stages[stage]:
            wall += hi - lo
            reach = lo
            for start, end, _ in work:
                if lo <= start < hi and end > reach:
                    busy += end - max(start, reach)
                    reach = end
        return busy / 1e6, wall / 1e6


def read_trace(path: str) -> Trace:
    """Read a trace written by ``profiler_trace`` (``path`` is the file or
    its directory)."""
    if os.path.isdir(path):
        path = os.path.join(path, TRACE_FILE)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    stages: dict[str, list[tuple[float, float]]] = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
        cat = ev.get("cat")
        if cat == "user_annotation":
            stages.setdefault(ev["name"], []).append(span)
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(span + (ev["name"],))
    return Trace(stages, device)
