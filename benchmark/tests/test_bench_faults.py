"""A run with the timed path broken underneath must come out not
correct: the harness's whole run on the CPU (its look for a card
skipped) at a small size, with one fault planted in the port for each
way this cell can go wrong, and the control put in the port's place."""

import pytest
from conftest import tiny_cell

from harness import cells, generate, runner

ref = cells.load_module("references", "exact_dbg")


def _run(seed=2**32 + 3):
    return runner.run(tiny_cell(), seed, 0.3, False, "cpu")


def test_sound_run_is_correct():
    out, lines = _run()
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 2
    assert lines[-1].startswith("correct: True")


def test_merge_that_returns_its_table_unchanged(monkeypatch):
    from genome_assembler_tpu_torch.ops import count_torch

    monkeypatch.setattr(count_torch, "merge_raw_keys", lambda table, keys: table)
    out, _ = _run()
    assert out["correct"] is False and out["failed"] == out["attempted"]
    assert out["checks"]["unitigs_unmatched"]["value"] > 0


def test_multiplicities_permuted_among_keys_in_the_merge(monkeypatch):
    """Every merge keeps its keys and their total count but hands the
    counts to other keys: only the unitigs' coverage sums can see it,
    and the cell's repeats and junctions split the table into unitigs of
    different coverage."""
    import torch
    from genome_assembler_tpu_torch.ops import count_torch

    real = count_torch.merge_raw_keys
    gen = torch.Generator().manual_seed(7)

    def permuted(table, keys):
        out = real(table, keys)
        n = int(out.num_unique)
        perm = torch.randperm(n, generator=gen).to(out.counts.device)
        counts = out.counts.clone()
        counts[:n] = counts[:n][perm]
        return out._replace(counts=counts)

    monkeypatch.setattr(count_torch, "merge_raw_keys", permuted)
    out, _ = _run()
    assert out["correct"] is False and out["failed"] == out["attempted"]
    assert out["checks"]["contigs_unmatched"]["value"] == 0
    assert out["checks"]["unitigs_unmatched"]["value"] > 0


def test_half_of_each_batch_left_out(monkeypatch):
    from genome_assembler_tpu_torch.models import pipeline

    real = pipeline.extract_canonical_flat

    def half(*args, **kwargs):
        keys = real(*args, **kwargs)
        return keys[: len(keys) // 2]

    monkeypatch.setattr(pipeline, "extract_canonical_flat", half)
    out, _ = _run()
    assert out["correct"] is False and out["failed"] == out["attempted"]


def test_contig_altered_where_it_is_produced(monkeypatch):
    from genome_assembler_tpu_torch.models import pipeline

    real = pipeline.emit_contigs

    def altered(graph):
        contigs = real(graph)
        s = contigs[0]
        mid = len(s) // 2
        contigs[0] = s[:mid] + ("A" if s[mid] != "A" else "C") + s[mid + 1:]
        return contigs

    monkeypatch.setattr(pipeline, "emit_contigs", altered)
    out, _ = _run()
    assert out["correct"] is False
    assert out["checks"]["contigs_unmatched"]["value"] == 2


def test_one_wrong_assembly_in_the_window_fails_the_run(monkeypatch):
    from genome_assembler_tpu_torch.models import pipeline

    real, calls = pipeline.emit_contigs, []

    def second_wrong(graph):  # the window's first assembly, always kept
        calls.append(1)
        contigs = real(graph)
        return contigs[1:] if len(calls) == 2 else contigs

    monkeypatch.setattr(pipeline, "emit_contigs", second_wrong)
    out, _ = _run()
    assert out["correct"] is False and out["failed"] == 1


@pytest.mark.parametrize("seed", [5, 2**31 + 9, 2**33 + 1])
def test_control_fails_the_comparison(seed):
    """The reference with a table keyed by 32-bit hashes in the program's
    place: at 300 kb about ten pairs of k-mers collide, and each pair
    loses a k-mer. The same check on the chip at each cell's size is
    ``benchmark/control.py``."""
    cell = tiny_cell(genome_length=300_000, coverage=10)
    config, traffic = cell.config, cell.traffic
    reads = generate.make_reads(config, traffic, seed, "cpu")
    want = ref.answer(reads, config, "cpu")
    lossy = ref.control(reads, config, "cpu")
    got = ref.compare(lossy.contigs,
                      [(s, e, c) for s, (e, c) in lossy.unitigs.items()],
                      want)
    assert got["contigs_unmatched"] > ref.LIMITS["contigs_unmatched"]
    assert got["unitigs_unmatched"] > ref.LIMITS["unitigs_unmatched"]
