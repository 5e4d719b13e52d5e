"""The port's hash-bucketed streaming merge (``ops/bucketed_torch.py``, the
bucketed layout of ``count_reads_device`` and of the sharded stream)
against the JAX package's ``ops/bucketed.py`` and its drivers.

Every function of the module equals its JAX counterpart array for array
(keys as reference words), at one and two limbs, with sentinel-only
batches and flagged overflow; the geometry rules agree as integers. The
streamed count in the bucketed layout equals the flat table and the JAX
package's under ``GA_BUCKETED=1`` with 8 buckets; mid-stream checkpoints
of the layout cross the two packages in both directions, one device and
sharded, and reshard to the same arrays. Exact everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genome_assembler_tpu.parallel.pipeline as jax_pp
from genome_assembler_tpu.models import pipeline as jax_pipeline
from genome_assembler_tpu.ops import bucketed as jb
from genome_assembler_tpu.ops import count_jax
from genome_assembler_tpu.parallel.mesh import build_mesh as jax_mesh
from genome_assembler_tpu.parallel.mesh import mesh_axes
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import key_words
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.ops import bucketed_torch as tb
from genome_assembler_tpu_torch.ops import count_torch
from genome_assembler_tpu_torch.parallel import pipeline as pp
from genome_assembler_tpu_torch.parallel.mesh import build_mesh
from genome_assembler_tpu_torch.utils.keys import limbs_to_words, words_to_limbs

torch.set_num_threads(1)

# k of one word, two words in one limb, three words in two limbs
KS = [15, 31, 41]


def _keys(k, n, seed, distinct=60, sentinel_share=0.15):
    """[n, W] reference words of ``distinct`` random k-mers with repeats
    and sentinel rows, and the port's limbs of the same keys."""
    rng = np.random.default_rng(seed)
    w = key_words(k)
    pool = [int(rng.integers(0, 2**62)) << 64 | int(rng.integers(0, 2**62))
            for _ in range(distinct)]
    vals = [pool[i] % 4**k for i in rng.integers(0, distinct, n)]
    words = np.array([[(v >> (32 * (w - 1 - i))) & 0xFFFFFFFF
                       for i in range(w)] for v in vals],
                     dtype=np.uint32).reshape(n, w)
    words[rng.random(n) < sentinel_share] = 0xFFFFFFFF
    return words, torch.from_numpy(words_to_limbs(words))


def _words(limbs, k):
    """Port limbs of any leading shape -> reference words of that shape."""
    flat = limbs.reshape(-1, limbs.shape[-1]).numpy()
    return limbs_to_words(flat, k).reshape(tuple(limbs.shape[:-1]) + (-1,))


def _assert_bucketed_equal(got, want, k):
    np.testing.assert_array_equal(_words(got.limbs, k), np.asarray(want.words))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.num_unique.numpy(),
                                  np.asarray(want.num_unique))
    assert bool(got.overflow) == bool(want.overflow)


def _assert_flat_equal(got, want, k):
    np.testing.assert_array_equal(_words(got.limbs, k), np.asarray(want.words))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert int(got.num_unique) == int(want.num_unique)
    assert bool(got.overflow) == bool(want.overflow)


@pytest.mark.parametrize("k", KS)
def test_bucket_of_and_route_equal_jax(k):
    words, limbs = _keys(k, 500, k)
    for nb in (1, 2, 16, 256):
        np.testing.assert_array_equal(tb._bucket_of(limbs, nb).numpy(),
                                      np.asarray(jb._bucket_of(
                                          jnp.asarray(words), nb)))
    payload = np.arange(500, dtype=np.int32)
    for full_order in (True, False):
        for m in (64, 8):  # 8: segments overflow
            got = tb._route_and_pack(limbs, 16, m,
                                     payload=torch.from_numpy(payload),
                                     full_order=full_order)
            want = jb._route_and_pack(jnp.asarray(words), 16, m,
                                      payload=jnp.asarray(payload),
                                      full_order=full_order)
            np.testing.assert_array_equal(_words(got[0], k),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
            assert bool(got[3]) == bool(want[3]) == (m == 8)
    packed, over = tb.route_pack_keys(limbs, 16, 64)
    want = jb.route_pack_keys_impl(jnp.asarray(words), nb=16, m=64)
    np.testing.assert_array_equal(_words(packed, k), np.asarray(want[0]))
    assert bool(over) == bool(want[1])


@pytest.mark.parametrize("k", KS)
def test_merges_and_flatten_equal_jax(k):
    w = key_words(k)
    nl = 1 if k <= 31 else 2
    jt, pt = jb.empty_bucketed(8, 64, w), tb.empty_bucketed(8, 64, nl, "cpu")
    _assert_bucketed_equal(pt, jt, k)
    flat_j, flat_p = count_jax.empty_table(1024, w), count_torch.empty_table(
        1024, nl, "cpu")
    for seed in range(3):
        words, limbs = _keys(k, 300, 100 * k + seed)
        jt = jb.merge_raw_keys_bucketed(jt, jnp.asarray(words), m=128)
        pt = tb.merge_raw_keys_bucketed(pt, limbs, 128)
        _assert_bucketed_equal(pt, jt, k)
        flat_j = count_jax.merge_raw_keys(flat_j, jnp.asarray(words))
        flat_p = count_torch.merge_raw_keys(flat_p, limbs)
    # a batch of sentinels only changes nothing
    words, limbs = _keys(k, 40, 7, sentinel_share=1.0)
    jt = jb.merge_raw_keys_bucketed(jt, jnp.asarray(words), m=128)
    pt2 = tb.merge_raw_keys_bucketed(pt, limbs, 128)
    _assert_bucketed_equal(pt2, jt, k)
    assert torch.equal(pt2.limbs, pt.limbs)
    # the pre-routed half alone, with a routing flag folded in
    words, limbs = _keys(k, 200, 8)
    packed, _ = tb.route_pack_keys(limbs, 8, 64)
    got = tb.merge_packed_bucketed(pt2, packed, torch.tensor(True))
    want = jb.merge_packed_bucketed_impl(
        jt, jb.route_pack_keys_impl(jnp.asarray(words), nb=8, m=64)[0],
        jnp.asarray(True))
    _assert_bucketed_equal(got, want, k)
    assert bool(got.overflow)
    # flatten at a capacity below and above nb * cb: the flat table
    for cap in (256, 1024):
        got = tb.flatten_bucketed(pt2, cap)
        _assert_flat_equal(got, jb.flatten_bucketed(jt, capacity=cap), k)
    _assert_flat_equal(tb.flatten_bucketed(pt2, 1024), flat_j, k)
    _assert_flat_equal(flat_p, flat_j, k)


@pytest.mark.parametrize("k", KS)
def test_batched_reduce_and_bucketize_equal_jax(k):
    words, limbs = _keys(k, 400, 3 * k)
    # sorted within each of 4 rows, as the merge hands them over
    wts = np.arange(400, dtype=np.int32).reshape(4, 100) % 5
    rows_p, wts_p = tb._batched_sort(limbs.reshape(4, 100, -1),
                                     torch.from_numpy(wts))
    got = tb._batched_weighted_reduce(rows_p, wts_p)
    want = jb._batched_weighted_reduce(
        jnp.asarray(_words(rows_p, k)), jnp.asarray(wts_p.numpy()))
    np.testing.assert_array_equal(_words(got[0], k), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # a flat table into buckets and back
    flat_j = count_jax.count_keys(jnp.asarray(words))
    flat_p = count_torch.count_keys(limbs)
    for cb in (64, 4):  # 4: buckets overflow
        got = tb.bucketize(flat_p, 8, cb)
        want = jb.bucketize(flat_j, nb=8, cb=cb)
        _assert_bucketed_equal(got, want, k)
        assert bool(got.overflow) == (cb == 4)
    back = tb.flatten_bucketed(tb.bucketize(flat_p, 8, 64), 400)
    _assert_flat_equal(back, flat_j, k)


def test_capacity_overflow_is_flagged_as_in_jax():
    words, limbs = _keys(15, 300, 1, distinct=250, sentinel_share=0.0)
    got = tb.merge_raw_keys_bucketed(tb.empty_bucketed(2, 16, 1, "cpu"),
                                     limbs, 512)
    want = jb.merge_raw_keys_bucketed(jb.empty_bucketed(2, 16, 1),
                                      jnp.asarray(words), m=512)
    _assert_bucketed_equal(got, want, 15)
    assert bool(got.overflow)
    flat = tb.flatten_bucketed(got, 8)  # and past the flat capacity
    assert bool(flat.overflow) and int(flat.num_unique) == 8


def test_geometry_rules_equal_jax():
    for cap in (8192, 5_242_880, 18_874_368, 50_331_648, 1 << 31):
        for mw in (4096, 3_840_000, 18_350_080, 1 << 30):
            for accum in (1, 2, 4, 8):
                assert tb.auto_buckets(cap, mw, accum) == jb.auto_buckets(
                    cap, mw, accum)
            for nb in (8, 256, 2048):
                assert tb.bucket_geometry(
                    cap, mw, nb=nb, cb_slack=1.25, m_slack=1.5
                ) == jb.bucket_geometry(cap, mw, nb=nb, cb_slack=1.25,
                                        m_slack=1.5)
    assert tb.BUCKET_TARGET_SEG == jb.BUCKET_TARGET_SEG
    assert pipeline.BUCKETED_MIN_MERGE_ROWS == 25 * (1 << 20)


# ---- the streamed count ----

CFG = AssemblyConfig(k=15, read_len=60, batch_reads=64)
CAP = 8192


@pytest.fixture(scope="module")
def reads():
    genome = simulate_genome(2000, seed=91)
    codes = simulate_reads(genome, coverage=12, read_len=60, seed=92).codes
    return codes  # 7 batches of 64


def _with_ns(reads):
    out = reads.copy()
    rng = np.random.default_rng(5)
    out[rng.random(out.shape) < 0.01] = 4
    return out


def _jax_env(mp, **env):
    for name, value in env.items():
        mp.setenv(name, str(value))


def _port_count(reads, **kw):
    return pipeline.count_reads_device(reads, CFG, device="cpu",
                                       table_capacity=CAP, **kw)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("ns", [False, True])
def test_streamed_bucketed_equals_flat_and_jax(reads, accum, ns):
    reads = _with_ns(reads) if ns else reads
    flat = _port_count(reads, bucketed="off")
    got = _port_count(reads, bucketed="on", _buckets=8, _bucket_accum=accum)
    with pytest.MonkeyPatch.context() as mp:
        _jax_env(mp, GA_BUCKETED=1, GA_BUCKETS=8, GA_BUCKET_ACCUM=accum)
        want = jax_pipeline.count_reads_device(reads, CFG, table_capacity=CAP)
    _assert_flat_equal(got, want, CFG.k)
    assert torch.equal(got.limbs, flat.limbs)
    assert torch.equal(got.counts, flat.counts)
    assert int(got.num_unique) == int(flat.num_unique)


def test_auto_layout_follows_the_bound(reads, monkeypatch, tmp_path):
    """``auto`` takes the buckets once capacity + a batch's windows reach
    BUCKETED_MIN_MERGE_ROWS (read off the snapshot's params), and the
    default accumulation and bucket count are the reference's."""
    ck = str(tmp_path / "mid.npz")
    for bound, want in ((1, 1), (1 << 40, 0)):
        monkeypatch.setattr(pipeline, "BUCKETED_MIN_MERGE_ROWS", bound)
        with pytest.raises(RuntimeError, match="fault injection"):
            _port_count(reads, stream_checkpoint=ck,
                        stream_checkpoint_every=1, abort_after_batch=4)
        _, _, params = pipeline.load_stream_checkpoint(ck, "cpu")
        assert params["bucketed"] == want
        if want:
            assert params["accum"] == 4 and params["nb"] == 256
    assert pipeline.use_bucketed("auto", 25 << 20) is False
    with pytest.raises(ValueError, match="bucketed"):
        pipeline.use_bucketed("1", 0)


@pytest.fixture(scope="module")
def jax_bucketed_ck(reads, tmp_path_factory):
    """The JAX package's bucketed snapshot (8 buckets, accumulation 2,
    stopped after 3 batches, snapshot every 2) and its full table."""
    ck = str(tmp_path_factory.mktemp("jaxb") / "mid.npz")
    with pytest.MonkeyPatch.context() as mp:
        _jax_env(mp, GA_BUCKETED=1, GA_BUCKETS=8, GA_BUCKET_ACCUM=2)
        full = jax_pipeline.count_reads_device(reads, CFG, table_capacity=CAP)
        mp.setenv("GA_STREAM_ABORT_AFTER_BATCH", "3")
        with pytest.raises(RuntimeError, match="fault injection"):
            jax_pipeline.count_reads_device(
                reads, CFG, table_capacity=CAP, stream_checkpoint=ck,
                stream_checkpoint_every=2)
    return full, ck


def _assert_files_equal(path_a, path_b):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])


def test_bucketed_checkpoint_crosses_both_packages(reads, jax_bucketed_ck,
                                                   tmp_path):
    jax_full, jax_ck = jax_bucketed_ck
    kw = dict(bucketed="on", _buckets=8, _bucket_accum=2)
    ck = str(tmp_path / "mid.npz")
    with pytest.raises(RuntimeError, match="fault injection"):
        _port_count(reads, stream_checkpoint=ck, stream_checkpoint_every=2,
                    abort_after_batch=3, **kw)
    # the same file as the reference's at the same merge boundary
    _assert_files_equal(ck, jax_ck)
    with np.load(ck) as z:
        assert z["words"].shape == (8, z["cb"], 1) and int(z["accum"]) == 2
    table, _, _ = pipeline.load_stream_checkpoint(ck, "cpu")
    assert isinstance(table, tb.BucketedTable)
    # the reference's resumes in the port, the port's in the reference
    _assert_flat_equal(_port_count(reads, resume_stream_from=jax_ck, **kw),
                       jax_full, CFG.k)
    with pytest.MonkeyPatch.context() as mp:
        _jax_env(mp, GA_BUCKETED=1, GA_BUCKETS=8, GA_BUCKET_ACCUM=2)
        resumed = jax_pipeline.count_reads_device(
            reads, CFG, table_capacity=CAP, resume_stream_from=ck)
    np.testing.assert_array_equal(np.asarray(resumed.words),
                                  np.asarray(jax_full.words))
    # a bucketed snapshot never resumes a flat run, nor the reverse
    with pytest.raises(ValueError, match="mismatch"):
        _port_count(reads, resume_stream_from=ck, bucketed="off")
    flat_ck = str(tmp_path / "flat.npz")
    with pytest.raises(RuntimeError, match="fault injection"):
        _port_count(reads, stream_checkpoint=flat_ck,
                    stream_checkpoint_every=2, abort_after_batch=3,
                    bucketed="off")
    with pytest.raises(ValueError, match="mismatch"):
        _port_count(reads, resume_stream_from=flat_ck, **kw)


@pytest.mark.parametrize("every,abort,snapshot_at", [(1, 5, 4), (3, 7, 4)])
def test_snapshots_wait_for_the_merge(reads, tmp_path, every, abort,
                                      snapshot_at):
    """With accumulation 4 a snapshot is only taken once the routed
    batches have merged: after batch 4 whatever ``every`` says."""
    ck = str(tmp_path / "mid.npz")
    with pytest.raises(RuntimeError, match="fault injection"):
        _port_count(reads, stream_checkpoint=ck, stream_checkpoint_every=every,
                    abort_after_batch=abort, bucketed="on", _buckets=8)
    with np.load(ck) as z:
        assert int(z["next_start"]) == snapshot_at * CFG.batch_reads
    full = _port_count(reads, bucketed="on", _buckets=8)
    resumed = _port_count(reads, resume_stream_from=ck, bucketed="on",
                          _buckets=8)
    assert torch.equal(resumed.limbs, full.limbs)
    assert torch.equal(resumed.counts, full.counts)


# ---- per shard ----

D = 4


@pytest.fixture(scope="module")
def jax_shards(reads, tmp_path_factory):
    """The JAX package's per-shard bucketed tables at D=4 (8 buckets a
    shard) and a bucketed sharded snapshot (accumulation 2, stopped after
    3 batches, snapshot every 2)."""
    ck = str(tmp_path_factory.mktemp("jaxs") / "mid.npz")
    mesh = jax_mesh(D)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
        _jax_env(mp, GA_BUCKETED=1, GA_BUCKETS=8, GA_BUCKET_ACCUM=2)
        words, counts, num = jax_pp._run_distributed_step(
            reads, CFG, mesh, None, mesh_axes(mesh), table_capacity=CAP)
        mp.setenv("GA_STREAM_ABORT_AFTER_BATCH", "3")
        with pytest.raises(RuntimeError, match="fault injection"):
            jax_pp.distributed_count_table(
                reads, CFG, mesh, table_capacity=CAP, stream_checkpoint=ck,
                stream_checkpoint_every=2)
    return (np.asarray(words), np.asarray(counts), np.asarray(num)), ck


def _port_shards(reads, monkeypatch, **kw):
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    return pp._run_distributed_step(reads, CFG, build_mesh(D, devices=["cpu"]),
                                    table_capacity=CAP, **kw)


@pytest.mark.parametrize("accum", [1, 2])
def test_shard_tables_equal_jax_and_flat(reads, jax_shards, monkeypatch,
                                         accum):
    (words, counts, num), _ = jax_shards
    got = _port_shards(reads, monkeypatch, bucketed="on", _buckets=8,
                       _bucket_accum=accum)
    flat = _port_shards(reads, monkeypatch, bucketed="off")
    c = got[0].limbs.shape[0]
    for s, (t, f) in enumerate(zip(got, flat)):
        np.testing.assert_array_equal(_words(t.limbs, CFG.k),
                                      words.reshape(D, c, -1)[s])
        np.testing.assert_array_equal(t.counts.numpy(),
                                      counts.reshape(D, c)[s])
        assert int(t.num_unique) == int(num[s])
        assert torch.equal(t.limbs, f.limbs) and torch.equal(t.counts, f.counts)


def test_sharded_bucketed_checkpoints_cross_and_reshard(reads, jax_shards,
                                                        monkeypatch, tmp_path):
    _, jax_ck = jax_shards
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    monkeypatch.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
    kw = dict(bucketed="on", _buckets=8, _bucket_accum=2)
    full = pp.distributed_count_table(reads, CFG, build_mesh(D, devices=["cpu"]),
                                      table_capacity=CAP, **kw)
    ck = str(tmp_path / "mid.npz")
    with pytest.raises(RuntimeError, match="fault injection"):
        pp.distributed_count_table(
            reads, CFG, build_mesh(D, devices=["cpu"]), table_capacity=CAP,
            stream_checkpoint=ck, stream_checkpoint_every=2,
            abort_after_batch=3, **kw)
    _assert_files_equal(ck, jax_ck)
    with np.load(ck) as z:
        assert z["words"].shape[0] == D * 8 and z["num"].shape == (D * 8,)
    for src in (ck, jax_ck):
        resumed = pp.distributed_count_table(
            reads, CFG, build_mesh(D, devices=["cpu"]), table_capacity=CAP,
            resume_stream_from=src, **kw)
        assert torch.equal(resumed.limbs, full.limbs)
    with pytest.MonkeyPatch.context() as mp:
        _jax_env(mp, GA_BUCKETED=1, GA_BUCKETS=8, GA_BUCKET_ACCUM=2)
        jt = jax_pp.distributed_count_table(reads, CFG, jax_mesh(D),
                                            table_capacity=CAP,
                                            resume_stream_from=ck)
        assert (jax_pipeline.table_to_host_counts(jt, CFG.k)
                == pipeline.table_to_host_counts(full, CFG.k))
        # reshard 4 -> 2, into the bucketed and into the flat layout: the
        # port writes the reference's arrays
        for layout, env in (("on", "1"), ("off", "0")):
            mp.setenv("GA_BUCKETED", env)
            out, ref_out = (str(tmp_path / f"{n}_{layout}.npz")
                            for n in ("port", "ref"))
            pp.reshard_sharded_stream_checkpoint(
                ck, out, reads.shape, CFG, 2, table_capacity=CAP,
                bucketed=layout, _buckets=8, _bucket_accum=2)
            jax_pp.reshard_sharded_stream_checkpoint(
                ck, ref_out, reads.shape, CFG, 2, table_capacity=CAP)
            _assert_files_equal(out, ref_out)
            resumed = pp.distributed_count_table(
                reads, CFG, build_mesh(2, devices=["cpu"]), table_capacity=CAP,
                resume_stream_from=ref_out, bucketed=layout, _buckets=8,
                _bucket_accum=2)
            # the gathered capacity is 2 shards' now: equal up to num_unique
            n = int(full.num_unique)
            assert int(resumed.num_unique) == n
            assert torch.equal(resumed.limbs[:n], full.limbs[:n])
            assert torch.equal(resumed.counts[:n], full.counts[:n])
    with pytest.raises(ValueError, match="mismatch"):
        pp.distributed_count_table(
            reads, CFG, build_mesh(D, devices=["cpu"]), table_capacity=CAP,
            resume_stream_from=ck, bucketed="off")
