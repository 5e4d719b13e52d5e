"""The readers of the device trace on a hand-written trace: the union of
device intervals over streams, the idle share and its gaps, the busy
share of ``count``, and the extraction kernel's roofline share."""

import json

import pytest

from harness import cells, roofline, runner
from harness import trace as tr

KERNEL = "void extract_canonical_kernel<1>(unsigned char const*, long)"


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


@pytest.fixture
def trace_file(tmp_path):
    events = [
        _ev(runner.ASSEMBLY_SPAN, "user_annotation", 0, 1000),
        _ev("count", "user_annotation", 0, 600),
        _ev("compress", "user_annotation", 600, 400),
        _ev(KERNEL, "kernel", 50, 50),
        _ev("sort_kernel", "kernel", 100, 200),  # stream 1
        _ev("reduce_kernel", "kernel", 200, 200),  # stream 2, overlaps
        _ev("Memcpy HtoD", "gpu_memcpy", 500, 50),
        _ev("aten::sort", "cpu_op", 90, 300),  # host ops are not device time
        _ev("later_kernel", "kernel", 2000, 100),  # outside the assembly
        {"ph": "i", "name": "marker", "ts": 10},
    ]
    path = tmp_path / tr.TRACE_FILE
    path.write_text(json.dumps({"traceEvents": events}))
    return str(tmp_path)


def _ctx(trace_file, reads=1000):
    t = tr.read_trace(trace_file)
    return runner.Context(
        config={}, traffic={}, first_s=0.9, reads=reads, read_len=100, k=31,
        stages=[{"count": 0.5, "compress": 0.2, "spell": 0.1,
                 "simplify": 0.05, "traverse": 0.07}],
        peaks=[3 << 30, 5 << 30], trace=t,
        spans=t.stages[runner.ASSEMBLY_SPAN],
    )


def _read(name, ctx):
    return cells.load_module("layer_metrics", name).read(ctx)


def test_union_and_gaps(trace_file):
    t = tr.read_trace(trace_file)
    busy, gaps = tr.busy_and_gaps(t.device, 0, 1000)
    assert busy == 400  # [50, 400] and [500, 550]
    assert gaps == [(0, 50), (400, 500), (550, 1000)]
    assert tr.longest_gaps(t, [(0, 1000)], runner.STAGES) == [
        ["compress", 450e-6], ["count", 100e-6], ["count", 50e-6]]
    ops = tr.top_device_ops(t.device, [(0, 1000)])
    assert ops[0] == ["sort_kernel", 200e-6] and len(ops) == 4
    assert [KERNEL.removeprefix("void "), 50e-6] in ops


def test_device_readers(trace_file):
    ctx = _ctx(trace_file)
    assert _read("device.idle_frac", ctx) == pytest.approx(0.6)
    assert _read("count.busy_frac", ctx) == pytest.approx(400 / 600)
    bound = roofline.extract_bound_s(1000, 100, 31)
    assert _read("extract_roofline", ctx) == pytest.approx(
        100 * bound / 50e-6)
    assert _read("device.peak_gib", ctx) == 5.0


def test_span_readers(trace_file):
    ctx = _ctx(trace_file)
    assert _read("count.stage_s", ctx) == 0.5
    assert _read("compress.stage_s", ctx) == 0.2
    assert _read("spell.stage_s", ctx) == 0.1
    assert _read("host.stage_s", ctx) == pytest.approx(0.12)
    assert _read("first_assembly_s", ctx) == 0.9


def test_readers_with_nothing_to_read_return_none():
    empty = runner.Context(config={}, traffic={}, first_s=0.9, reads=10,
                           read_len=100,
                           k=31, stages=[], peaks=[], trace=None, spans=[])
    for name in ("count.stage_s", "count.busy_frac", "extract_roofline",
                 "compress.stage_s", "spell.stage_s", "host.stage_s",
                 "device.idle_frac", "device.peak_gib"):
        assert _read(name, empty) is None
    no_device = runner.Context(
        config={}, traffic={}, first_s=0.9, reads=10, read_len=100, k=31,
        stages=[],
        peaks=[], trace=tr.Trace({runner.ASSEMBLY_SPAN: [(0, 10)]}, []),
        spans=[(0, 10)])
    assert _read("extract_roofline", no_device) is None
    assert _read("device.idle_frac", no_device) is None


def test_kernel_byte_count():
    # 262,144 reads of 100 bases at k=31: 6,553,600 B of 2-bit reads in,
    # 146,800,640 B of keys out
    assert roofline.extract_bytes(262_144, 100, 31) == 153_354_240
    assert roofline.extract_bound_s(262_144, 100, 31) == pytest.approx(
        0.0458e-3, rel=1e-3)
    assert roofline.extract_bytes(10, 100, 41) == 10 * 25 + 600 * 16
