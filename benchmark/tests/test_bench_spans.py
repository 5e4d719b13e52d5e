"""The readers of the program's host spans on hand-built traces whose
spans, nesting and idle gaps are known: ``reads.scan_s``,
``count.fill_s``, ``count.wait_s`` and ``device.idle_unnamed_frac``."""

import pytest

from harness import cells, runner
from harness import spans as sp
from harness import trace as tr

A = runner.ASSEMBLY_SPAN
SPAN_READERS = ("reads.scan_s", "count.fill_s", "count.wait_s")
READERS = SPAN_READERS + ("device.idle_unnamed_frac",)

# one assembly, microseconds; the device is busy over [270, 690] and
# [750, 880], idle over [0, 270], [690, 750] and [880, 1000]
ONE = {
    A: [(0, 1000)],
    "scan": [(10, 60)],
    "count": [(100, 700)],
    "count.scan": [(110, 130)],
    "count.setup": [(130, 150)],
    "count.fill": [(150, 200), (200, 250), (300, 320)],
    "count.step": [(250, 300), (320, 360)],
    "count.wait": [(400, 450)],
    "count.finish": [(500, 520)],
    "count.sync": [(600, 700)],
    "compress": [(720, 900)],
    "compress.sync": [(880, 900)],
}
DEVICE = [(270, 650, "sort_kernel"), (300, 400, "other_stream"),
          (650, 690, "Memcpy HtoD"), (750, 880, "spell_kernel")]


def _ctx(stages, device, spans=None):
    t = None if stages is None else tr.Trace(stages, device)
    return runner.Context(
        config={}, traffic={}, first_s=1.0, reads=10, read_len=100, k=31,
        stages=[], peaks=[], trace=t,
        spans=spans if spans is not None else (stages or {}).get(A, []))


def _read(name, ctx):
    return cells.load_module("layer_metrics", name).read(ctx)


def test_idle_goes_to_the_innermost_span():
    idle = sp.idle_by_span(tr.Trace(ONE, DEVICE), ONE[A])
    assert idle == {A: 170, "scan": 50, "count": 10, "count.scan": 20,
                    "count.setup": 20, "count.fill": 100, "count.step": 20,
                    "count.sync": 10, "compress": 30, "compress.sync": 20}
    # the idle share's own gaps, all of them and no more
    busy, wall = tr.busy_in(DEVICE, ONE[A])
    assert sum(idle.values()) == wall - busy == 450


def test_span_readers_on_one_assembly():
    ctx = _ctx(ONE, DEVICE)
    assert _read("reads.scan_s", ctx) == pytest.approx(70e-6)
    assert _read("count.fill_s", ctx) == pytest.approx(120e-6)
    assert _read("count.wait_s", ctx) == pytest.approx(150e-6)
    # between stages (170) and inside count outside its spans (10)
    assert _read("device.idle_unnamed_frac", ctx) == pytest.approx(180 / 450)


def test_span_readers_mean_over_the_traced_assemblies():
    """A second assembly; a span before the traced ones is left out, and
    one that outlasts its assembly is cut to it."""
    stages = {A: [(0, 1000), (2000, 2500)],
              "scan": [(-300, -200), (10, 60), (2000, 2100)],
              "count.scan": [(110, 130)],
              "count.fill": [(150, 250), (2450, 2600)],
              "count.sync": [(600, 700)]}
    ctx = _ctx(stages, [])
    assert _read("reads.scan_s", ctx) == pytest.approx((70 + 100) / 2 * 1e-6)
    assert _read("count.fill_s", ctx) == pytest.approx((100 + 50) / 2 * 1e-6)
    assert _read("count.wait_s", ctx) == pytest.approx(100 / 2 * 1e-6)
    # no device work: the whole wall is idle, named where a span covers it
    idle = sp.idle_by_span(ctx.trace, ctx.spans)
    assert sum(idle.values()) == 1500
    unnamed = 1000 - 50 - 20 - 100 - 100 + 500 - 100 - 50
    assert _read("device.idle_unnamed_frac", ctx) == pytest.approx(
        unnamed / 1500)


def test_a_program_without_the_spans():
    """The stage spans alone: no span reader has anything to read, and the
    idle inside ``count`` and between stages is all unnamed."""
    stages = {A: ONE[A], "count": ONE["count"],
              "compress": ONE["compress"]}
    ctx = _ctx(stages, DEVICE)
    for name in SPAN_READERS:
        assert _read(name, ctx) is None
    # [0, 270], [690, 720] and [900, 1000]: 400 of 450; compress holds
    # [720, 750] and [880, 900]
    assert _read("device.idle_unnamed_frac", ctx) == pytest.approx(400 / 450)


def test_no_idle_reads_zero():
    stages = {A: [(0, 100)], "count": [(0, 100)]}
    assert _read("device.idle_unnamed_frac",
                 _ctx(stages, [(0, 100, "kernel")])) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_no_trace_reads_nothing(name):
    assert _read(name, _ctx(None, [], spans=[])) is None
    assert _read(name, _ctx(ONE, DEVICE, spans=[])) is None
