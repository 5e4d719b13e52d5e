"""Structured per-stage metrics (SURVEY.md §5 observability).

The port's copy of the reference package's ``utils/metrics.py``: the
``Metrics`` class as it is there, without that module's profiler helpers.
It emits structured per-stage wall-clock + throughput counters consumable
by the bench configs (BASELINE.md CFG 2-4): k-mers/s, reads/s, bytes/s vs
the HBM roofline, all-to-all volume, weak-scaling efficiency.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field

log = logging.getLogger("genome_assembler_tpu_torch")

HBM_PEAK_BYTES_S = 3.35e12  # NVIDIA H100 SXM, 80 GB HBM3 (data sheet)


@dataclass
class Metrics:
    """Accumulates per-stage timings and counters for one pipeline run."""

    stages: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a pipeline stage; nested stages accumulate independently."""
        t0 = time.perf_counter()
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

