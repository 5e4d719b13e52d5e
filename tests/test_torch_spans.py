"""The host spans inside a stage, on the CPU: ``Metrics.span`` and
``Metrics.stage``, the spans of a streamed assembly in a profiler trace
(where they lie, how many) and in the report (``spans_s``), and that the
spans add no synchronise. On a card, that they share the device's clock:
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.utils import device as device_mod
from genome_assembler_tpu_torch.utils.config import AssemblyConfig
from genome_assembler_tpu_torch.utils.metrics import (
    Metrics,
    profiler_trace,
    read_trace,
)
from genome_assembler_tpu_torch.utils.simulate import (
    simulate_genome,
    simulate_reads,
)

torch.set_num_threads(1)

K = 15
CAP = 8192
BATCH = 96  # 400 reads: four full batches and a short one
STAGES = {"count", "filter", "compress", "spell", "simplify", "traverse"}


@pytest.fixture(scope="module")
def reads():
    genome = simulate_genome(2000, seed=91)
    codes = simulate_reads(genome, coverage=12, read_len=60,
                           seed=92).codes.copy()
    codes[np.random.default_rng(91).random(codes.shape) < 0.004] = 4
    return codes


def _cfg():
    return AssemblyConfig(k=K, read_len=60, batch_reads=BATCH)


def _inside(span, spans):
    return any(lo <= span[0] and span[1] <= hi for lo, hi in spans)


def test_stage_and_span():
    m = Metrics()
    order = []
    with m.stage("count", torch.device("cpu"),
                 after=lambda: order.append("after")):
        for _ in range(2):
            with m.span("count.step"):
                order.append("step")
    with m.stage("plain"):
        pass
    assert order == ["step", "step", "after"]
    assert set(m.stages) == {"count", "plain"}
    assert {k: n for k, (_, n) in m.spans.items()} == {
        "count.step": 2, "count.sync": 1}
    assert sum(s for s, _ in m.spans.values()) <= m.stages["count"]
    report = m.report()
    assert set(report) == {"stages_s", "counters", "derived", "spans_s"}
    assert report["spans_s"]["count.step"][1] == 2


@pytest.mark.parametrize("kw", [
    dict(bucketed="off"),
    dict(bucketed="on"),
    dict(bucketed="off", merge_stride=2),
    dict(bucketed="on", merge_stride=2),
], ids=["flat", "bucketed", "flat_stride2", "bucketed_stride2"])
def test_streamed_assembly_spans(reads, tmp_path, kw):
    batches = -(-reads.shape[0] // BATCH)
    m = Metrics()
    with profiler_trace(str(tmp_path)):
        contigs = pipeline.assemble_torch(reads, _cfg(), device="cpu",
                                          metrics=m, table_capacity=CAP,
                                          **kw)
    assert contigs == pipeline.assemble_torch(
        reads, _cfg(), device="cpu", table_capacity=CAP, **kw)
    trace = read_trace(str(tmp_path))
    [count] = trace.stages["count"]
    # the card finds the Ns in the pack: no host scan before or in count
    assert not {"scan", "count.scan"} & set(trace.stages)
    for name, spans in trace.stages.items():
        if name.startswith("count."):
            assert all(_inside(s, [count]) for s in spans), name
    assert len(trace.stages["count.fill"]) == batches
    assert len(trace.stages["count.step"]) == batches
    for stage in STAGES:
        [sync] = trace.stages[f"{stage}.sync"]
        assert _inside(sync, trace.stages[stage]), stage
    # the operator's copy: every span with its calls (no ring wait off
    # the card), and the stages and their rates as before
    report = m.report()
    calls = {"count.setup": 1,
             "count.fill": batches, "count.step": batches,
             "count.finish": 1}
    calls.update({f"{stage}.sync": 1 for stage in STAGES})
    assert {k: n for k, (_, n) in report["spans_s"].items()} == calls
    assert set(report["stages_s"]) == STAGES
    assert m.derive() == Metrics(stages=m.stages,
                                 counters=m.counters).derive()
    assert m.derive()["kmers_per_s"] == pytest.approx(
        m.counters["kmers"] / sum(m.stages.values()))


def test_single_shot_count_spans(reads):
    m = Metrics()
    pipeline.assemble_torch(reads, _cfg(), device="cpu", metrics=m)
    assert {k: n for k, (_, n) in m.spans.items()
            if k.startswith("count.") and k != "count.sync"} == {
        "count.fill": 1, "count.step": 1}


def test_spans_add_no_synchronise(reads, monkeypatch):
    calls = []
    real = device_mod.synchronize

    def spy(dev):
        calls.append(dev)
        real(dev)

    monkeypatch.setattr(device_mod, "synchronize", spy)
    m = Metrics()
    pipeline.assemble_torch(reads, _cfg(), device="cpu", metrics=m,
                            table_capacity=CAP)
    # one synchronise a stage, each inside its stage's closing span
    assert len(calls) == len(m.stages) == len(STAGES)
    assert sum(n for k, (_, n) in m.spans.items()
               if k.endswith(".sync")) == len(STAGES)
