"""Reading a ``torch.profiler`` Chrome trace into device time.

``read_trace`` is a frozen copy of the port's ``utils/metrics.py`` (as
of the benchmark's first version): the host's ``record_function`` spans
by name, and the device's kernels, copies and memsets as (start, end,
name). Times are in microseconds. The union of device intervals
(``busy_and_gaps``) is the reading of the device's busy time: work on
several streams at once counts once.
"""

from __future__ import annotations

import dataclasses
import json
import os

TRACE_FILE = "trace.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """What ``read_trace`` keeps of a Chrome trace; times in microseconds."""

    stages: dict[str, list[tuple[float, float]]]  # name -> host (start, end)
    device: list[tuple[float, float, str]]  # kernels, copies, memsets


def read_trace(path: str) -> Trace:
    """Read a trace written by ``torch.profiler``'s ``export_chrome_trace``
    (``path`` is the file or its directory)."""
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
        elif cat in DEVICE_CATS:
            device.append(span + (ev["name"],))
    return Trace(stages, device)


def clipped(device, lo: float, hi: float) -> list[tuple[float, float]]:
    """The device intervals cut to [lo, hi], sorted; empty ones dropped."""
    out = []
    for start, end, _ in device:
        a, b = max(start, lo), min(end, hi)
        if b > a:
            out.append((a, b))
    return sorted(out)


def busy_and_gaps(device, lo: float, hi: float):
    """(busy microseconds, idle gaps) of the device over [lo, hi]: the
    union of its intervals there, and the stretches of [lo, hi] that no
    interval covers, as (start, end)."""
    busy = 0.0
    gaps = []
    reach = lo
    for a, b in clipped(device, lo, hi):
        if a > reach:
            gaps.append((reach, a))
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    if hi > reach:
        gaps.append((reach, hi))
    return busy, gaps


def busy_in(device, spans) -> tuple[float, float]:
    """(busy microseconds, wall microseconds) of the device over
    ``spans``: ``busy_and_gaps``'s union, summed over the spans."""
    busy = sum(busy_and_gaps(device, lo, hi)[0] for lo, hi in spans)
    return busy, sum(hi - lo for lo, hi in spans)


def device_time(device, spans, match: str | None = None) -> float:
    """Microseconds of device intervals (whose name holds ``match``, if
    given) inside ``spans``, summed as they run, not as a union."""
    total = 0.0
    for lo, hi in spans:
        for start, end, name in device:
            if match is not None and match not in name:
                continue
            a, b = max(start, lo), min(end, hi)
            if b > a:
                total += b - a
    return total


NAME_CHARS = 160  # a kernel's C++ signature, cut for the breakdown


def short_name(name: str) -> str:
    """A device operation's name without ``void`` and cut to NAME_CHARS."""
    return name.removeprefix("void ")[:NAME_CHARS]


def top_device_ops(device, spans, n: int = 10) -> list[list]:
    """The ``n`` device operations with the most time inside ``spans``
    (summed by their full names): [[short name, seconds], ...], most
    first."""
    by_name: dict[str, float] = {}
    for lo, hi in spans:
        for start, end, name in device:
            a, b = max(start, lo), min(end, hi)
            if b > a:
                by_name[name] = by_name.get(name, 0.0) + (b - a)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[short_name(name), us / 1e6] for name, us in ranked]


def label_of(t: float, stages: dict, names) -> str:
    """The first of ``names`` whose span holds the instant ``t``, else
    ``"between_stages"``."""
    for name in names:
        for lo, hi in stages.get(name, []):
            if lo <= t < hi:
                return name
    return "between_stages"


def longest_gaps(trace: Trace, spans, names, n: int = 10) -> list[list]:
    """The ``n`` longest idle gaps of the device inside ``spans``, each as
    [the stage it falls in (by its midpoint), seconds], longest first."""
    gaps = []
    for lo, hi in spans:
        gaps += busy_and_gaps(trace.device, lo, hi)[1]
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[label_of((a + b) / 2, trace.stages, names), (b - a) / 1e6]
            for a, b in gaps[:n]]
