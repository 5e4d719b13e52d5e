"""One run of one cell: set-up, the measured window, the check, the line.

Set-up, in order: import the port (through the configuration's entry),
initialise the device, load the extraction kernel, make the reads from
the seed, and run one first assembly outside the window
(``first_assembly_s``). The window then calls the entry back to back,
each call a whole assembly with a fresh ``Metrics``, until ``seconds``
have passed; the last assembly started is finished and counted. With
``trace`` the first ``TRACE_ASSEMBLIES`` assemblies of the window run
under ``torch.profiler``. Once the window has closed and the peak memory
is read, the program's state is freed and the configuration's plain
reference assembles the same reads. The first assembly and a sample of
the window's, ``KEEP`` drawn from the seed, are held to its answer: the
window keeps no more, so that the memory it holds does not grow with it.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import random
import shutil
import tempfile
import time
import warnings

import torch

from . import card, cells, generate, trace as tr, window

TRACE_ASSEMBLIES = 3
KEEP = 16  # window assemblies kept for the check (a reservoir sample)
ASSEMBLY_SPAN = "benchmark.assembly"
STAGES = ("count", "filter", "compress", "spell", "simplify", "traverse")
GIB = float(1 << 30)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads.

    first_s: the first assembly's wall seconds, outside the window;
    stages: each window assembly's stage spans (seconds), the untraced
    ones where the window has any; peaks: each window assembly's peak
    device bytes; trace: the traced assemblies' trace, or None; spans:
    their ``ASSEMBLY_SPAN`` spans in the trace (microseconds)."""

    config: dict
    traffic: dict
    first_s: float
    reads: int
    read_len: int
    k: int
    stages: list[dict]
    peaks: list[int]
    trace: tr.Trace | None
    spans: list[tuple[float, float]]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    # a second profiler in one process warns that it starts empty
    warnings.filterwarnings("ignore", message=".*Profiler clears events")

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@dataclasses.dataclass
class Window:
    """The measured window: each assembly's start and end (host clock),
    stage spans and peak device bytes, and the results kept for the
    check (the first assembly's, then a reservoir of ``KEEP``)."""

    starts: list[float]
    ends: list[float]
    stages: list[dict]
    peaks: list[int]
    results: list


def _window(entry, reads, seconds: float, dev, seed: int, first,
            prof=None) -> Window:
    """Call ``entry`` back to back until ``seconds`` have passed; stop
    ``prof`` after TRACE_ASSEMBLIES assemblies."""
    w = Window([], [], [], [], [first])
    sample = random.Random(seed)
    try:
        t0 = time.perf_counter()
        while True:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            s = time.perf_counter()
            with torch.profiler.record_function(ASSEMBLY_SPAN):
                res, st = entry(reads)
            e = time.perf_counter()
            w.starts.append(s)
            w.ends.append(e)
            w.stages.append(st)
            n = len(w.starts)
            if n <= KEEP:
                w.results.append(res)
            else:
                slot = sample.randrange(n)
                if slot < KEEP:
                    w.results[1 + slot] = res
            del res
            if dev.type == "cuda":
                w.peaks.append(torch.cuda.max_memory_allocated(dev))
            if prof is not None and n == TRACE_ASSEMBLIES:
                prof.stop()
                prof = None
            if e - t0 >= seconds:
                return w
    finally:
        if prof is not None:
            prof.stop()


def _check(reference, entry_mod, results, want):
    """-> (the worst reading of each number compared, the assemblies
    that failed a limit)."""
    worst = {name: 0 for name in reference.LIMITS}
    failed = 0
    for contigs, graph in results:
        got = reference.compare(contigs, entry_mod.Entry.unitig_rows(graph),
                                want)
        failed += any(got[n] > lim for n, lim in reference.LIMITS.items())
        for n in worst:
            worst[n] = max(worst[n], got[n])
    return worst, failed


def _read_trace(prof, cell, ctx_args, n_traced: int, device_info: dict):
    """The per-layer metrics, ``busy_s``/``window_s`` and the breakdown
    of the traced assemblies."""
    trace_dir = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        prof.export_chrome_trace(os.path.join(trace_dir, tr.TRACE_FILE))
        trace_obj = tr.read_trace(trace_dir)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    spans = sorted(trace_obj.stages.get(ASSEMBLY_SPAN, []))[:n_traced]
    ctx = Context(trace=trace_obj, spans=spans, **ctx_args)
    metrics = {}
    for m in cell.per_layer:
        value = cells.load_module("layer_metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy, wall = tr.busy_in(trace_obj.device, spans)
    device_info["busy_s"] = busy / 1e6
    device_info["window_s"] = wall / 1e6
    breakdown = {
        "device_ops": tr.top_device_ops(trace_obj.device, spans),
        "idle_gaps": tr.longest_gaps(trace_obj, spans, STAGES),
    }
    return metrics, breakdown


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        device="cuda", t0: float | None = None, steps: dict | None = None):
    """Run ``cell`` once -> (the result's JSON object, the lines that give
    each number compared beside its limit). ``t0`` is the process's start
    and ``steps`` the seconds of the set-up steps already taken; each
    later step is added to it."""
    t0 = time.perf_counter() if t0 is None else t0
    steps = dict(steps or {})
    last = [t0 + sum(steps.values())]

    def step(name: str) -> None:
        now = time.perf_counter()
        steps[name] = now - last[0]
        last[0] = now

    step("harness_import")
    dev = torch.device(device)
    config, traffic = cell.config, cell.traffic
    entry_mod = cells.load_module("entries", config["entry"])
    reference = cells.load_module("references", config["reference"])
    entry = entry_mod.Entry(config, int(traffic["read_len"]), dev)
    step("port_import")
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
        _sync(dev)
    step("cuda_init")
    entry.load_kernels()
    step("kernel_load")
    reads = generate.make_reads(config, traffic, seed, dev)
    step("reads")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    if trace:
        warm = _profiler()  # the profiler's own first start, not timed
        warm.start()
        torch.ones(1, device=dev).add_(1)
        _sync(dev)
        warm.stop()
        prof = _profiler()
    step("empty_cache_and_profiler")
    t = time.perf_counter()
    first, _ = entry(reads)
    first_s = time.perf_counter() - t
    first_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0)
    step("first_assembly")
    setup_s = last[0] - t0

    if prof is not None:
        prof.start()
    w = _window(entry, reads, seconds, dev, seed, first, prof)
    del first
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": int(max([first_peak] + w.peaks)),
    }
    if dev.type == "cuda":
        device_info["card"] = card.card_line(dev.index or 0)

    # the program's state goes before the reference runs
    entry.close()
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference.answer(reads, config, dev)
    worst, failed = _check(reference, entry_mod, w.results, want)
    n_checked, n_run = len(w.results), len(w.starts) + 1
    del w.results

    out = {
        "correct": failed == 0,
        "attempted": n_checked,
        "failed": failed,
        "metrics": {},
        "device": device_info,
    }
    if not trace:
        e2e = {
            "assembly_s": window.mean_wall(w.starts, w.ends),
            "assembly_p90_s": window.percentile(
                [b - a for a, b in zip(w.starts, w.ends)], 90),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            out["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
    else:
        n_traced = min(TRACE_ASSEMBLIES, len(w.starts))
        ctx_args = dict(
            config=config, traffic=traffic, first_s=first_s,
            reads=int(reads.shape[0]), read_len=int(reads.shape[1]),
            k=int(config["assembly"]["k"]),
            stages=w.stages[n_traced:] or w.stages, peaks=w.peaks,
        )
        out["metrics"], out["breakdown"] = _read_trace(
            prof, cell, ctx_args, n_traced, device_info)
    out["setup_steps_s"] = steps
    out["checks"] = {n: {"value": worst[n], "limit": lim}
                     for n, lim in reference.LIMITS.items()}
    lines = ["setup steps (s): " + ", ".join(
        f"{n} {v:.4f}" for n, v in steps.items())]
    lines += [f"check {n}: {c['value']} (limit {c['limit']})"
             for n, c in out["checks"].items()]
    lines.append(f"correct: {out['correct']} ({failed} of the {n_checked} "
                 f"assemblies checked wrong, of {n_run} run)")
    return out, lines
