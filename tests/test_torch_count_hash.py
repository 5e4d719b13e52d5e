"""The streamed count's hash table (``ops/count_hash_torch.py``) and the
carried table's hash path (``ops/stream_table.py``), on the CPU.

On a card the carried table of one-limb keys is a hash table that each
batch's keys are inserted into by ``count_insert_kernel``; here the plain
version of the insert stands in for the kernel. The hash table's sorted
table equals the flat sort merge's for the same batches, overflow past the
capacity included (the smallest keys with their full counts); past its
slots only the flag is kept. With the path forced on the CPU
(``uses_hash_table`` patched), the counters' tables, snapshots,
checkpoints and the ``hash_batches`` / ``hash_slots`` counters are held
to the sort merges' in every layout and at strides 1 and 3, one device and
4 shards; a full bucket flags no overflow on the hash path. The same
comparisons on the card, kernel against the CPU's sort merges, are in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.ops import count_hash_torch as ch
from genome_assembler_tpu_torch.ops import stream_table
from genome_assembler_tpu_torch.ops.hash_torch import owner_of
from genome_assembler_tpu_torch.parallel import pipeline as pp
from genome_assembler_tpu_torch.parallel.mesh import build_mesh
from genome_assembler_tpu_torch.utils.config import AssemblyConfig
from genome_assembler_tpu_torch.utils.keys import SENTINEL
from genome_assembler_tpu_torch.utils.metrics import Metrics
from genome_assembler_tpu_torch.utils.simulate import (
    simulate_genome,
    simulate_reads,
)

torch.set_num_threads(1)

CFG = AssemblyConfig(k=21, read_len=60, batch_reads=50)
CAP = 8192
BUCKETED = dict(bucketed="on", _buckets=8, _bucket_accum=3)


@pytest.fixture(scope="module")
def reads():
    genome = simulate_genome(3000, seed=91)
    codes = simulate_reads(genome, coverage=20, read_len=60, seed=92).codes
    codes[np.random.default_rng(5).random(codes.shape) < 0.01] = 4
    return codes[:427]  # 9 batches of 50, the last short


@pytest.fixture
def hashed(monkeypatch):
    """The carried table's hash path on the CPU (the plain insert)."""
    monkeypatch.setattr(stream_table, "uses_hash_table",
                        lambda device, nl: nl == 1)


def _tables_equal(a, b):
    return (torch.equal(a.limbs, b.limbs) and torch.equal(a.counts, b.counts)
            and int(a.num_unique) == int(b.num_unique)
            and bool(a.overflow) == bool(b.overflow))


def _sort_merged(batches, capacity):
    """The flat sort merges' table of the same batches."""
    carried = stream_table.CarriedTable(capacity, 1, torch.device("cpu"),
                                        None)
    for keys in batches:
        carried.add(keys)
    return carried.finish()


def _inserted(batches, capacity):
    ht = ch.empty_hash(capacity, "cpu")
    for keys in batches:
        ch.count_insert(ht, keys)
    return ht


def _col(values):
    return torch.tensor(values, dtype=torch.int64)[:, None]


def test_slot_hash_is_splitmix64s_finalizer():
    def fmix(z):
        m = (1 << 64) - 1
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
        return z ^ (z >> 31)

    keys = [0, 1, 2, 12345, (1 << 62) - 1, SENTINEL]
    got = ch.slot_hash(torch.tensor(keys, dtype=torch.int64))
    want = [fmix(k) for k in keys]
    assert [v & ((1 << 64) - 1) for v in got.tolist()] == want


def test_slots_are_twice_the_capacity_in_a_power_of_two():
    assert ch.hash_slots(5_242_880) == 1 << 24  # E. coli
    assert ch.hash_slots(20_971_520) == 1 << 26  # yeast
    assert ch.hash_slots(83_886_080) == 1 << 28  # a fly shard
    assert [ch.hash_slots(c) for c in (0, 1, 2, 3, 64, 65)] == [
        1, 2, 4, 8, 128, 256]
    ht = ch.empty_hash(100, "cpu")
    assert ht.slots.shape == (256, 2) and ht.capacity == 100
    assert bool((ht.slots[:, 0] == SENTINEL).all())
    assert int(ht.slots[:, 1].abs().sum()) == 0


def _batches(case):
    rng = np.random.default_rng(7)
    if case == "repeats":  # 6 batches drawn from 900 keys
        pool = rng.integers(0, 1 << 62, 900)
        return [_col(rng.choice(pool, 700)) for _ in range(6)]
    if case == "one_key":
        return [_col([123456789] * 500)] * 3
    if case == "sentinel_padded":  # routed buffers: lanes left empty
        out = []
        for _ in range(4):
            keys = rng.integers(0, 1 << 40, 600)
            keys[rng.random(600) < 0.5] = SENTINEL
            out.append(_col(keys))
        return out
    if case == "one_owner_shard":  # every key of shard 0 of 4
        keys = _col(rng.integers(0, 1 << 62, 20_000))
        keys = keys[owner_of(keys, 31, 4) == 0][:1200]
        return [keys[rng.integers(0, keys.shape[0], 800)] for _ in range(5)]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["repeats", "one_key", "sentinel_padded",
                                  "one_owner_shard"])
def test_inserted_table_equals_the_flat_merge(case):
    batches = _batches(case)
    ht = _inserted(batches, 4096)
    got = ch.hash_to_table(ht)
    assert _tables_equal(got, _sort_merged(batches, 4096))
    assert int(ht.claimed) == int(got.num_unique)
    assert int((ht.slots[:, 0] != SENTINEL).sum()) == int(ht.claimed)


def test_weights_carry_a_tables_counts():
    """A table's rows with their counts (a resumed checkpoint) and then
    more batches: the table the sort merges give."""
    batches = _batches("repeats")
    first = _sort_merged(batches[:3], 4096)
    ht = ch.empty_hash(4096, "cpu")
    ch.count_insert(ht, first.limbs, first.counts)
    for keys in batches[3:]:
        ch.count_insert(ht, keys)
    assert _tables_equal(ch.hash_to_table(ht), _sort_merged(batches, 4096))


@pytest.mark.parametrize("capacity", [600, 460], ids=["1.5x", "1.96x"])
def test_overflow_past_the_capacity_keeps_the_smallest_keys(capacity):
    """900 unique keys, capacity 600 or 460 (1,024 slots): flagged, and the
    first ``capacity`` rows are the smallest keys with their full counts,
    as the flat merge keeps them."""
    batches = _batches("repeats")
    unique = torch.unique(torch.cat(batches)).numel()
    assert capacity < unique <= 2 * capacity
    got = ch.hash_to_table(_inserted(batches, capacity))
    want = _sort_merged(batches, capacity)
    assert bool(got.overflow) and int(got.num_unique) == capacity
    assert _tables_equal(got, want)


def test_overflow_past_the_slots_is_flagged():
    batches = _batches("repeats")
    ht = _inserted(batches, 200)  # 512 slots for 900 keys
    assert int(ht.claimed) == 512 and int(ht.overflow) == 1
    assert bool(ch.hash_to_table(ht).overflow)


def test_the_wrapper_refuses_what_the_kernel_cannot_take():
    ht = ch.empty_hash(64, "cpu")
    with pytest.raises(ValueError, match="one-limb"):
        ch.count_insert(ht, torch.zeros((4, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="one-limb"):
        ch.count_insert(ht, torch.zeros((4, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="weights"):
        ch.count_insert(ht, torch.zeros((4, 1), dtype=torch.int64),
                        torch.ones(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="weights"):
        ch.count_insert(ht, torch.zeros((4, 1), dtype=torch.int64),
                        torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="meta"):
        ch.count_insert(ch.empty_hash(4, "meta"),
                        torch.zeros((4, 1), dtype=torch.int64,
                                    device="meta"))


def test_only_one_limb_keys_on_a_card_take_the_hash_table():
    assert stream_table.uses_hash_table(torch.device("cuda", 0), 1)
    assert not stream_table.uses_hash_table(torch.device("cuda", 0), 2)
    assert not stream_table.uses_hash_table(torch.device("cpu"), 1)


# ---- the carried table's hash path, forced on the CPU ----


def _layout_kw(layout, monkeypatch):
    if layout == "auto":  # the bound passed: auto takes the buckets
        monkeypatch.setattr(stream_table, "BUCKETED_MIN_MERGE_ROWS", 0)
        return {"bucketed": "auto"}
    return BUCKETED if layout == "on" else {"bucketed": "off"}


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("layout", ["off", "auto", "on"])
def test_hash_path_equals_the_sort_merges(reads, monkeypatch, layout,
                                          stride):
    kw = dict(device="cpu", table_capacity=CAP, merge_stride=stride,
              **_layout_kw(layout, monkeypatch))
    want = pipeline.count_reads_device(reads, CFG, **kw)
    m = Metrics()
    with monkeypatch.context() as mp:
        mp.setattr(stream_table, "uses_hash_table",
                   lambda device, nl: nl == 1)
        got = pipeline.count_reads_device(reads, CFG, metrics=m, **kw)
    assert _tables_equal(got, want)
    assert m.counters["hash_batches"] == 9
    assert m.counters["hash_slots"] == ch.hash_slots(CAP)
    assert "hash_batches" not in Metrics().counters


def _stopped(path, **kw):
    with pytest.raises(RuntimeError, match="fault injection"):
        pipeline.count_reads_device(
            stream_checkpoint=path, stream_checkpoint_every=2,
            abort_after_batch=5, **kw)


def _files_equal(path_a, path_b):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("layout", ["off", "on"])
def test_hash_path_checkpoints_cross_the_sort_merges(
        reads, monkeypatch, tmp_path, layout, stride):
    """The hash path's snapshot is the sort merges' file, at the same
    cursor; each path resumes the other's to the full table."""
    kw = dict(reads=reads, cfg=CFG, device="cpu", table_capacity=CAP,
              merge_stride=stride, **_layout_kw(layout, monkeypatch))
    full = pipeline.count_reads_device(**kw)
    plain_ck, hash_ck = str(tmp_path / "plain.npz"), str(tmp_path / "hash.npz")
    _stopped(plain_ck, **kw)
    with monkeypatch.context() as mp:
        mp.setattr(stream_table, "uses_hash_table",
                   lambda device, nl: nl == 1)
        _stopped(hash_ck, **kw)
        from_plain = pipeline.count_reads_device(resume_stream_from=plain_ck,
                                                 **kw)
    _files_equal(hash_ck, plain_ck)
    with np.load(hash_ck) as z:
        assert int(z["next_start"]) == {(1, "off"): 4, (1, "on"): 3,
                                        (3, "off"): 3, (3, "on"): 3}[
            stride, layout] * CFG.batch_reads
    assert _tables_equal(from_plain, full)
    assert _tables_equal(
        pipeline.count_reads_device(resume_stream_from=hash_ck, **kw), full)


@pytest.mark.parametrize("layout", ["off", "on"])
def test_hash_path_shards_equal_the_sort_merges(reads, monkeypatch, hashed,
                                                layout):
    """Four shards of a CPU mesh, routed buffers padded with sentinel
    lanes: each shard's table equals the sort merges'."""
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    scfg = AssemblyConfig(k=21, read_len=60, batch_reads=48)
    mesh = build_mesh(4, devices=["cpu"])
    kw = dict(table_capacity=CAP, merge_stride=3,
              **(BUCKETED if layout == "on" else {"bucketed": "off"}))
    m = Metrics()
    got = pp._run_distributed_step(reads[:350], scfg, mesh, metrics=m, **kw)
    assert m.counters["hash_batches"] == 8  # each shard, 8 batches
    assert m.counters["hash_slots"] == 4 * ch.hash_slots(
        got[0].limbs.shape[0])
    monkeypatch.setattr(stream_table, "uses_hash_table", lambda d, nl: False)
    want = pp._run_distributed_step(reads[:350], scfg, mesh, **kw)
    for a, b in zip(got, want):
        assert _tables_equal(a, b)


def test_a_full_bucket_flags_no_overflow_on_the_hash_path(reads,
                                                          monkeypatch):
    """Buckets of a quarter of their expected rows: the sort merges flag
    overflow; the hash path, whose unique keys stay within the capacity,
    gives the exact table (ROADMAP F, deliberate differences)."""
    flat = pipeline.count_reads_device(reads, CFG, device="cpu",
                                       table_capacity=CAP, bucketed="off")
    unique = int(flat.num_unique)
    cap = 2 * unique
    monkeypatch.setattr(stream_table, "BUCKET_CB_SLACK", 0.25)
    kw = dict(device="cpu", table_capacity=cap, **BUCKETED)
    plan = stream_table.bucket_plan(cap, 0, buckets=8, accum=3)
    assert plan.cb * plan.nb < unique  # some bucket passes cb
    assert bool(pipeline.count_reads_device(reads, CFG, **kw).overflow)
    monkeypatch.setattr(stream_table, "uses_hash_table",
                        lambda device, nl: nl == 1)
    got = pipeline.count_reads_device(reads, CFG, **kw)
    want = pipeline.count_reads_device(reads, CFG, device="cpu",
                                       table_capacity=cap, bucketed="off")
    assert not bool(got.overflow) and _tables_equal(got, want)


@pytest.mark.parametrize("where", ["one device", "4 shards"])
def test_a_bucketed_checkpoint_that_drops_keys_is_refused(reads, monkeypatch,
                                                          hashed, tmp_path,
                                                          where):
    """Buckets too small for the keys (a quarter of their expected rows on
    one device; on 4 shards, whose tables have the floor's 65,536 rows,
    two buckets of 128): the hash table is exact, but its bucketed
    snapshot would drop keys, so a checkpoint is refused (no file) instead
    of written truncated with the flag that a resume would carry; the flat
    layout checkpoints the same run, and its resume gives the
    uninterrupted table."""
    one = where == "one device"
    monkeypatch.setattr(stream_table, "BUCKET_CB_SLACK", 0.25 if one else 0.002)
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    mesh = build_mesh(4, devices=["cpu"])

    def count(**kw):
        if one:
            return [pipeline.count_reads_device(reads, CFG, device="cpu",
                                                **kw)]
        return pp._run_distributed_step(reads, CFG, mesh, **kw)

    cap = 2 * int(pipeline.count_reads_device(
        reads, CFG, device="cpu", table_capacity=CAP,
        bucketed="off").num_unique)
    on = dict(table_capacity=cap, bucketed="on", _buckets=8 if one else 2,
              _bucket_accum=3)
    with monkeypatch.context() as mp:  # the sort merges' buckets overflow
        mp.setattr(stream_table, "uses_hash_table", lambda d, nl: False)
        if one:
            assert bool(count(**on)[0].overflow)
        else:
            with pytest.raises(RuntimeError, match="streaming overflow"):
                count(**on)
    assert not any(bool(t.overflow) for t in count(**on))
    ck = str(tmp_path / "mid.npz")
    with pytest.raises(RuntimeError, match="bucketed checkpoint cannot hold"):
        count(stream_checkpoint=ck, stream_checkpoint_every=2,
              abort_after_batch=5, **on)
    assert not (tmp_path / "mid.npz").exists()
    off = dict(table_capacity=cap, bucketed="off")
    with pytest.raises(RuntimeError, match="fault injection"):
        count(stream_checkpoint=ck, stream_checkpoint_every=2,
              abort_after_batch=5, **off)
    for a, b in zip(count(resume_stream_from=ck, **off), count(**off)):
        assert _tables_equal(a, b)
