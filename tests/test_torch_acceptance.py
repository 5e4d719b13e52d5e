"""The port's acceptance runners (``models/acceptance.py``) on the CPU at
test scale: every runner passes, and its ``detail`` equals the JAX
runner's under ``GA_ACCEPT_SCALE`` of the same value on every key that is
not a time, a date, a device list or a metrics report (exact: integers,
strings and booleans). The pure bars are held equal to the reference's on
the cases of ``tests/test_acceptance_bars.py``."""

import numpy as np
import pytest
import torch

import genome_assembler_tpu.models.acceptance as jax_acc
import genome_assembler_tpu_torch.models.acceptance as acc
from genome_assembler_tpu.utils.dna import decode_seq, revcomp_str
from genome_assembler_tpu.utils.simulate import simulate_genome

torch.set_num_threads(1)

# times, dates, device lists and metrics reports differ by construction
NOT_COMPARED = {
    "wall_s", "assembly_wall_s", "date", "devices", "metrics",
    "sharded_run_metrics", "reads_per_s", "weak_scaling_eff",
}
SCALES = {0: 0.01, 1: 0.01, 2: 0.01, 3: 0.01, 4: 0.001, 5: 0.01, 6: 0.001}


def _compared(detail: dict) -> dict:
    return {
        key: _compared(v) if isinstance(v, dict) else v
        for key, v in detail.items() if key not in NOT_COMPARED
    }


@pytest.mark.parametrize("cid", sorted(SCALES))
def test_runner_passes_and_matches_the_reference(cid, monkeypatch):
    scale = SCALES[cid]
    got = acc.run([cid], scale=scale, device="cpu", devices=4)[0]
    assert got.config == cid and got.passed, got.detail
    monkeypatch.setenv("GA_ACCEPT_SCALE", str(scale))
    want = jax_acc.RUNNERS[cid]()
    assert want.passed
    assert _compared(got.detail) == _compared(want.detail)
    assert sorted(got.detail) == sorted(want.detail)
    report = got.detail if cid == 3 else {"": got.detail}
    for detail in report.values():
        for name in ("metrics", "sharded_run_metrics"):
            if name in detail:
                assert set(detail[name]) == {"stages_s", "counters",
                                             "derived", "spans_s"}
    if cid in (4, 6):
        assert got.detail["counts_match_host"] is True
    if cid == 4:
        assert got.detail["devices"] == [1, 2, 4]
        assert got.detail["oracle_cross_checked"] is True
        assert sorted(got.detail["reads_per_s"]) == ["1", "2", "4"]
    if cid == 2:
        derived = got.detail["metrics"]["derived"]
        assert derived["count_bytes_per_s"] > 0
        assert set(derived) == set(want.detail["metrics"]["derived"])
        # the port's two counters more: the batches in which the card
        # found an N (none in CFG-2's reads), and the bases of the reverse
        # complements that emission built
        counters = got.detail["metrics"]["counters"]
        assert set(counters) == set(want.detail["metrics"]["counters"]) | {
            "ambiguous_batches", "revcomp_bases"}
        assert counters["ambiguous_batches"] == 0
        assert counters["revcomp_bases"] > 0


def test_to_json_is_one_line_with_the_reference_keys():
    r = acc.accept_cfg0(scale=0.01, device="cpu")
    text = r.to_json()
    assert "\n" not in text
    import json

    d = json.loads(text)
    assert d["config"] == 0 and d["passed"] is True and d["k"] == 25


def test_run_streams_results_and_refuses_a_missing_card():
    seen = []
    out = acc.run([0, 1], on_result=seen.append, scale=0.01, device="cpu")
    assert [r.config for r in seen] == [0, 1] and seen == out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            acc.run([0], scale=0.01)
    with pytest.raises(TypeError):
        acc.run([0], scael=0.01)


def test_cfg4_counts_bar_catches_wrong_counts(monkeypatch):
    """accept_cfg4 fails when the sharded counts diverge from the host's."""
    real = acc.table_to_host_counts

    def corrupted(table, k):
        counts = real(table, k)
        counts[next(iter(counts))] += 1  # one wrong multiplicity
        return counts

    monkeypatch.setattr(acc, "table_to_host_counts", corrupted)
    res = acc.accept_cfg4(scale=0.001, device="cpu", devices=2)
    assert not res.passed
    assert res.detail["counts_match_host"] is False
    assert res.detail["assembly_genome_exact_and_paths_agree"] is True


def test_cfg4_weak_scaling_bar_is_enforced(monkeypatch):
    monkeypatch.setattr(acc, "weak_scaling_efficiency",
                        lambda rates: {d: 0.5 for d in rates})
    kw = dict(scale=0.001, device="cpu", devices=2)
    res = acc.accept_cfg4(enforce_weak_scaling=True, weak_scaling_min=0.8,
                          **kw)
    assert not res.passed and res.detail["weak_scaling_bar"] == 0.8
    res = acc.accept_cfg4(enforce_weak_scaling=True, weak_scaling_min=0.4,
                          **kw)
    assert res.passed and res.detail["weak_scaling_bar"] == 0.4


def test_yeast_chromosome_lengths_equal():
    for total in (32_000, 120_000, 12_000_000):
        assert acc._yeast_chromosome_lengths(total) == \
            jax_acc._yeast_chromosome_lengths(total)


@pytest.mark.parametrize("rates", [
    {1: 100.0, 2: 200.0, 8: 800.0},
    {1: 100.0, 4: 200.0},
    {4: 150.0, 2: 100.0},
    {},
])
def test_weak_scaling_efficiency_equal(rates):
    assert acc.weak_scaling_efficiency(rates) == \
        jax_acc.weak_scaling_efficiency(rates)


GENOME = decode_seq(simulate_genome(3000, seed=7))
K = 31


def _bar_cases():
    middle = len(GENOME) // 2
    sub = {"A": "C", "C": "A", "G": "T", "T": "G"}[GENOME[middle]]
    step10, step3 = len(GENOME) // 10, len(GENOME) // 3
    thirds = [GENOME[i * step3 : (i + 1) * step3 + K] for i in range(3)]
    bad_third = [thirds[0][:-1] + ("A" if thirds[0][-1] != "A" else "C")]
    return {
        "trimmed": ([GENOME[25 : len(GENOME) - 25]], None, True),
        "revcomp": ([revcomp_str(GENOME)], None, True),
        "error_base": ([GENOME[:middle] + sub + GENOME[middle + 1 :]], None,
                       False),
        "chimera": ([GENOME[2000:] + GENOME[:1000]], None, False),
        "incomplete": ([GENOME[: len(GENOME) // 2]], None, False),
        "fragmented": ([GENOME[i * step10 : (i + 1) * step10 + K]
                        for i in range(10)], None, False),
        "empty": ([], None, False),
        "low_coverage_breaks": (thirds, 20, True),
        "low_coverage_corrupt": (bad_third + thirds[1:], 20, False),
    }


@pytest.mark.parametrize("case", sorted(_bar_cases()))
def test_errored_run_ok_equal(case):
    contigs, coverage, want = _bar_cases()[case]
    got = acc.errored_run_ok(contigs, GENOME, K, coverage=coverage)
    assert got is want
    assert got == jax_acc.errored_run_ok(contigs, GENOME, K, coverage=coverage)


def test_acceptance_reads_no_environment(monkeypatch):
    """The reference's switches are arguments here: its variables change
    nothing in the port."""
    monkeypatch.setenv("GA_ACCEPT_SCALE", "0.5")
    monkeypatch.setenv("GA_FORCE_ORACLE_CHECK", "1")
    r = acc.accept_cfg0(scale=0.01, device="cpu")
    assert r.detail["genome_len"] == 1250
    assert np.isclose(r.detail["coverage"], 20.0)
