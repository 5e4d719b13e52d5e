"""Sharded unitig compression and spelling: the graph never gathers.

Counterpart of ``genome_assembler_tpu/parallel/compress.py``. Shard s
owns the edge rows with global ids [s*K, (s+1)*K), K = 2 * c_shard; the
owner and slot of an id are one divide and one modulo. Every stage keeps
per-shard buffers of static [K]-row shapes, so per-device memory scales
about 1/D (``peak_rows_per_device``):

  1. local both-strand edge build and sort (``unitig_torch._build_edges``,
     no communication);
  2. successor linking: every edge sends its tagged prefix and suffix
     node records to the node's owner (a salted hash of the node), which
     runs the single-device join core (``unitig_torch.join_scan``) and
     routes (successor, predecessor) pairs to the successor's owner;
  3. ranking over global ids. Every SAMPLE_STRIDE-th global id is a
     ruler, and the sampled two-level pass (the reference's
     ``rank_sampled``) doubles only to the nearest ruler: each round
     dedupes the shard's ancestor targets, sends the unique queries to
     their owners, answers with a local row gather and sends the answers
     back, and the loop stops once no shard changed (one host read a
     round). One more query round links each ruler to the stop above its
     predecessor; the E/STRIDE contracted list is gathered once onto
     every shard and ranked there with no communication a round. So the
     mesh pays ceil(log2(largest ruler gap)) query rounds, not
     ceil(log2(global E)). Where it refuses (a cycle, or a gap past its
     round cap) the exact pass runs: doubling over the whole global
     list, and a pure cycle breaks at its smallest GLOBAL edge id;
  4. global numbering: head counts are gathered and offset, and one more
     query round fetches uid(ancestor) for every edge;
  5. spelling (``make_sharded_spell``): per-unitig stats go to the
     numbering shard, every edge's base goes to the shard that owns its
     global position in the (uid, pos) stream, 4 bases a byte; the host
     pulls E/4 bytes plus O(U) per-unitig rows.

The reference's ``shard_map`` becomes a Python loop over the process's
local shards (all D in one process; list position s is global shard
``mesh.first_shard + s``) and its collectives the mesh's
(``parallel/mesh.py``), so across processes every host read is of a
value reduced over all D shards; ids are int64 with the
reference's ``BIG`` pads and masks. Per-shard outputs equal the
reference's at the same D bit for bit, and so does the choice between the
sampled and the exact pass.
"""

from __future__ import annotations

import math
import time
from collections.abc import Sequence
from typing import NamedTuple

import numpy as np
import torch

from ..host.simplify_arrays import (
    UnitigArrays,
    build_unitig_arrays,
)
from ..utils.dna import key_words, unpack_codes_np
from ..utils.metrics import Metrics

from ..ops.count_torch import (
    CountTable,
    compact_front_sorted,
    sort_by_words,
    take_rows,
)
from ..ops.hash_torch import limbs_to_key_words, mix_words
from ..ops.unitig_torch import (
    SAMPLE_STRIDE,
    SAMPLED_MAX_ROUNDS,
    _build_edges,
    _contracted_doubling,
    _csteps,
    join_scan,
)
from ..ops.words_torch import (
    prefix_node,
    shift_left_words,
    shift_right_words,
    suffix_node,
)
from ..utils.keys import SENTINEL, is_sentinel, limbs_to_words, n_limbs
from ..utils.keys import snug_capacity
from .mesh import Mesh, all_gather_replicated, all_to_all, any_reduce
from .mesh import axis_size, gather_to_host, max_reduce

# +inf of the id lanes: pads queries and sorts last
BIG = 2**30
# salt of the node-owner hash: decorrelates a node's owner from its
# k-mer's home shard (the reference's r4 fix, ``compress.py:215-230``)
NODE_SALT = 0x5BD1E995
# overflow bits of the sharded compression, in the reference's order
OVERFLOW_CAPS = ((1, "link-join"), (2, "link-pair"), (4, "rank-query"),
                 (8, "uid-query"))


def bucket_pack(
    values: torch.Tensor,
    owner: torch.Tensor,
    valid: torch.Tensor,
    d: int,
    cap: int,
    fill: int | Sequence[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack [N, C] rows into a [d, cap, C] send buffer by owner.

    Rows sort by (invalid, owner); each owner's run is gathered into its
    bucket and the unused lanes hold ``fill``: one value, or one per
    column (``SENTINEL`` for key limbs, -1 for id and record lanes).
    Returns (send, overflow): overflow is a 0-d bool set when some
    owner's run is longer than ``cap`` (its tail is dropped). Order
    inside a bucket is unspecified, as in the reference.
    """
    n = values.shape[0]
    dev = values.device
    shape = (d, cap) + tuple(values.shape[1:])
    fill_t = torch.as_tensor(fill, dtype=values.dtype, device=dev)
    if n == 0:
        return (fill_t.expand(shape).clone(),
                torch.zeros((), dtype=torch.bool, device=dev))
    key_sorted, order = torch.sort(torch.where(valid, owner, d), stable=True)
    # run bounds by binary search (no host sync, unlike bincount on CUDA)
    bounds = torch.searchsorted(
        key_sorted, torch.arange(d + 1, dtype=key_sorted.dtype, device=dev)
    )
    starts = bounds[:d]
    per = bounds[1:] - starts
    overflow = (per > cap).any()
    slot = torch.arange(cap, device=dev)
    in_run = slot[None, :] < per[:, None]
    src = torch.where(in_run, starts[:, None] + slot[None, :], 0)
    send = take_rows(values, order[src.reshape(-1)]).reshape(shape)
    mask = in_run.reshape((d, cap) + (1,) * (values.dim() - 1))
    return torch.where(mask, send, fill_t), overflow


def _join_cap(k_cap: int, d: int) -> int:
    """Per-owner rows of the successor-join routing buffer: 2*k_cap/D
    with hash-skew slack (one definition: ``peak_rows_per_device`` must
    track the real buffer shape)."""
    return int(2 * k_cap / d * 1.6) + 128


def _pair_cap(k_cap: int, d: int) -> int:
    return int(k_cap / d * 1.6) + 128


def _query_cap(k_cap: int, d: int) -> int:
    return int(k_cap / d * 2.0) + 128


def _route_cap(k_cap: int, d: int, route_slack: float = 2.0) -> int:
    return min(k_cap, int(k_cap / d * route_slack) + 128)


def _round_cap(d: int, k_cap: int) -> int:
    """Doubling rounds that reach across the global edge table."""
    return max(1, int(math.ceil(math.log2(max(d * k_cap, 2)))) + 1)


def comm_bytes_estimate(
    d: int, k: int, c_shard: int, u_block: int | None = None
) -> dict[str, int]:
    """The reference's all-to-all volume of the sharded stages, in bytes
    summed over all shards, for its int32 wire columns (the port's own
    send buffers are :func:`wire_bytes`). The doubling loop's round count
    is data-dependent, so it is reported as per-round bytes + the cap."""
    w = key_words(k)
    k_cap = 2 * c_shard
    cap_route = _route_cap(k_cap, d)
    ub = u_block if u_block is not None else cap_route
    return {
        "link": d * d * (_join_cap(k_cap, d) * (w + 1)
                         + _pair_cap(k_cap, d) * 2) * 4,
        "query_round": d * d * _query_cap(k_cap, d) * 3 * 4,
        "query_rounds_max": _round_cap(d, k_cap),
        "spell": d * d * (ub * 3 + cap_route) * 4,
    }


def wire_bytes(
    d: int, k: int, c_shard: int, u_block: int | None = None,
    route_slack: float = 2.0,
) -> dict[str, int]:
    """The port's real send-buffer bytes (shape x element size, summed
    over the shards) of the sharded stages: int64 key limbs and ids, so
    wider than the reference's int32 columns (:func:`comm_bytes_estimate`).
    link: node records (limbs + id) and (successor, predecessor) pairs;
    query_round: one round's queries and [anc, aux] answers; spell:
    per-unitig (uid, count, coverage) stats and base-routing lanes."""
    k_cap = 2 * c_shard
    cap_route = _route_cap(k_cap, d, route_slack)
    ub = u_block if u_block is not None else cap_route
    return {
        "link": d * d * (_join_cap(k_cap, d) * (n_limbs(k) + 1)
                         + _pair_cap(k_cap, d) * 2) * 8,
        "query_round": d * d * _query_cap(k_cap, d) * 3 * 8,
        "spell": d * d * (ub * 3 + cap_route) * 8,
    }


def peak_rows_per_device(d: int, c_shard: int) -> int:
    """Largest per-shard buffer rows in the sharded compression: static
    shapes proportional to c_shard = C_global/D, so ~1/D per device."""
    k_cap = 2 * c_shard
    return max(2 * k_cap, d * _join_cap(k_cap, d))


def node_owner(node_limbs: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """Owner shard of (k-1)-mer node keys: a function of the node alone,
    so both tags of a node meet at one owner. The salted hash is taken
    over the node's uint32 word layout, as in the reference, so owners
    (and with them per-owner load and cap_join overflow) match it."""
    return mix_words(limbs_to_key_words(node_limbs, k) ^ NODE_SALT) % d


def _answer_queries(state: torch.Tensor, recv: torch.Tensor, k_cap: int):
    """Owner side of a query round: state rows for received global ids;
    pads (-1 or ``BIG``) answer -1."""
    ans = take_rows(state, (recv % k_cap).clamp(0, k_cap - 1))
    ok = (recv >= 0) & (recv < BIG)
    return torch.where(ok[:, None], ans, -1)


class ShardedUnitigs(NamedTuple):
    """Per-shard outputs of the sharded compression: each list holds one
    tensor per shard, on the shard's device, of K = 2 * c_shard rows (the
    reference's row-sharded arrays).

    valid: bool; uid: int32 global unitig id or -1; pos: int32 position
    in the unitig (the reference's ``dist``); cov: int32 multiplicity;
    last_base: uint8; heads: bool; edge_limbs: [K, n_limbs] sorted edge
    keys. num_unitigs and overflow (the cap bitmask, ``OVERFLOW_CAPS``)
    are host ints; query_rounds counts the query rounds run (doubling,
    the sampled pass's ruler links, cycle break and numbering),
    doubling_rounds those of the doubling loops alone and doubling_seconds
    their wall time (each ends in the loop's one host read, so the
    device's work is inside). rank_pass names the ranking that answered
    ("sampled" or "exact"); contracted_rounds counts the sampled pass's
    local rounds over the gathered ruler list (no communication).
    """

    valid: list[torch.Tensor]
    uid: list[torch.Tensor]
    pos: list[torch.Tensor]
    cov: list[torch.Tensor]
    last_base: list[torch.Tensor]
    heads: list[torch.Tensor]
    edge_limbs: list[torch.Tensor]
    num_unitigs: int
    overflow: int
    query_rounds: int
    doubling_rounds: int = 0
    doubling_seconds: float = 0.0
    rank_pass: str = "exact"
    contracted_rounds: int = 0


class _ShardedCompress:
    """The sharded compression step for one (mesh, k, c_shard)."""

    def __init__(self, mesh: Mesh, k: int, c_shard: int, exact: bool = False):
        d = axis_size(mesh)
        self.mesh, self.k, self.d = mesh, k, d
        self.k_cap = k_cap = 2 * c_shard  # per-shard directed-edge rows
        if d * k_cap >= (1 << 29):
            raise ValueError(
                f"global edge table of {d} x {k_cap} rows exceeds the int32 "
                "doubling range (2^29)"
            )
        self.cap_join = _join_cap(k_cap, d)
        self.cap_pair = _pair_cap(k_cap, d)
        self.cap_query = _query_cap(k_cap, d)
        self.steps = _round_cap(d, k_cap)
        # the reference's rule: rulers are global ids % SAMPLE_STRIDE, so
        # every shard's K rows must hold whole stride blocks
        self.use_sampled = (not exact and k_cap % SAMPLE_STRIDE == 0
                            and k_cap >= 4 * SAMPLE_STRIDE)
        self.my_gid = [
            s * k_cap + torch.arange(k_cap, device=dev)
            for s, dev in zip(mesh.local_shards, mesh.devices)
        ]
        self.rounds = 0
        self.doubling_rounds, self.doubling_seconds = 0, 0.0

    def _link(self, edges, valid):
        """Per-shard prev[K] (global ids, -1 none) and the join and pair
        overflow flags, via the node-owner all-to-all join."""
        k, d, k_cap = self.k, self.d, self.k_cap
        nl = edges[0].shape[1]
        sends, ovf_join = [], []
        for s in range(self.mesh.local_size):
            pre = prefix_node(edges[s], k)
            suf = suffix_node(edges[s], k)
            # (node << 1 | tag): the pre/suf tag rides the spare low bit
            pre_p = shift_left_words(pre, 1)
            suf_p = shift_left_words(suf, 1)
            suf_p[:, -1] |= 1  # the low limb's sign flip leaves bit 0
            rec_valid = torch.cat([valid[s], valid[s]])
            keys = torch.where(rec_valid[:, None], torch.cat([pre_p, suf_p]),
                               SENTINEL)
            owner = node_owner(torch.cat([pre, suf]), k, d)
            gid2 = torch.cat([self.my_gid[s], self.my_gid[s]])
            rec = torch.cat([keys, gid2[:, None]], dim=1)
            send, ovf = bucket_pack(rec, owner, rec_valid, d, self.cap_join,
                                    [SENTINEL] * nl + [-1])
            sends.append(send)
            ovf_join.append(ovf)
        pair_sends, ovf_pair = [], []
        for recv in all_to_all(self.mesh, sends):
            packed_s, pay = sort_by_words(recv[:, :nl], recv[:, nl])
            is_pre = (packed_s[:, -1] & 1) == 0
            key_s = shift_right_words(packed_s, 1)
            key_s = torch.where(is_sentinel(packed_s)[:, None], SENTINEL, key_s)
            good, succ = join_scan(key_s, is_pre, pay)
            # (successor gid, predecessor gid) -> the successor's owner
            pair = torch.stack([succ, pay], dim=1)
            send, ovf = bucket_pack(pair, succ // k_cap, good, d,
                                    self.cap_pair, -1)
            pair_sends.append(send)
            ovf_pair.append(ovf)
        prev = []
        for s, recv in enumerate(all_to_all(self.mesh, pair_sends)):
            tgt = recv[:, 0]
            ok = (tgt >= 0) & (tgt < BIG)
            p = torch.full((k_cap + 1,), -1, dtype=torch.int64,
                           device=tgt.device)
            p[torch.where(ok, tgt % k_cap, k_cap)] = torch.where(
                ok, recv[:, 1], -1
            )  # row k_cap is the dump slot of the pads
            prev.append(torch.where(valid[s], p[:k_cap], -1))
        return prev, ovf_join, ovf_pair

    def _query_round(self, states, targets, valid):
        """Per-lane state rows of global-id targets: (answers [K, S] in
        lane order per shard, overflow flag per shard)."""
        d, k_cap, cq = self.d, self.k_cap, self.cap_query
        sends, plans = [], []
        for s in range(self.mesh.local_size):
            t = torch.where(valid[s], targets[s], BIG)
            n = t.shape[0]
            dev = t.device
            # dedupe: one stable sort carrying the lane, rank the runs
            ts, lane_s = torch.sort(t, stable=True)
            new = torch.ones(n, dtype=torch.bool, device=dev)
            new[1:] = ts[1:] != ts[:-1]
            rank_sorted = torch.cumsum(new, 0) - 1
            uniq_t = compact_front_sorted(new, ts, BIG)  # still ascending
            uniq_rank = torch.empty_like(rank_sorted)
            uniq_rank[lane_s] = rank_sorted  # back to lane order
            # owner ranges over the sorted unique targets
            uniq_owner = torch.where(uniq_t < BIG, uniq_t // k_cap, d)
            bounds = torch.searchsorted(
                uniq_owner, torch.arange(d + 1, device=dev)
            )
            starts = bounds[:d]
            per = bounds[1:] - starts
            slot = torch.arange(cq, device=dev)
            in_run = slot[None, :] < per[:, None]
            src = (starts[:, None] + slot[None, :]).clamp(max=n - 1)
            sends.append(torch.where(in_run, uniq_t[src], BIG)[..., None])
            plans.append((uniq_owner, starts, uniq_rank, (per > cq).any()))
        answers = [
            _answer_queries(states[s], recv[:, 0], k_cap).reshape(d, cq, -1)
            for s, recv in enumerate(all_to_all(self.mesh, sends))
        ]
        out, ovf = [], []
        for resp, (uniq_owner, starts, uniq_rank, o) in zip(
            all_to_all(self.mesh, answers), plans
        ):
            # unique i -> (owner b, slot i - starts[b]) -> row of resp
            b = uniq_owner.clamp(max=d - 1)
            lane = torch.arange(b.shape[0], device=b.device)
            flat = b * cq + (lane - starts[b]).clamp(0, cq - 1)
            out.append(take_rows(resp, flat[uniq_rank]))
            ovf.append(o)
        self.rounds += 1
        return out, ovf

    def _double(self, prev, valid, track: str, max_rounds: int | None = None):
        """Distributed pointer doubling: per shard (ancestor, tracked,
        overflow), and whether the round cap ran out before a fixpoint
        (a host bool reduced over every shard). track "dist" carries the
        distance from the head, "min" the minimum global id on the
        ancestor path. At most ``max_rounds`` (default ``steps``) rounds;
        the loop stops once a round changed nothing on any shard (one host
        read a round)."""
        rounds = self.steps if max_rounds is None else max_rounds
        states = []
        for s, p in enumerate(prev):
            anc = torch.where(p >= 0, p, self.my_gid[s])
            aux = ((p >= 0).to(torch.int64) if track == "dist"
                   else torch.minimum(self.my_gid[s], anc))
            states.append(torch.stack([anc, aux], dim=1))
        ovf = [torch.zeros((), dtype=torch.bool, device=p.device)
               for p in prev]
        changed, i = True, 0
        t0 = time.perf_counter()
        while i < rounds and changed:
            ans, o = self._query_round(states, [st[:, 0] for st in states],
                                       valid)
            flags = []
            for s, (st, a, v) in enumerate(zip(states, ans, valid)):
                anc2 = torch.where(v, a[:, 0], st[:, 0])
                if track == "dist":
                    aux2 = torch.where(v, st[:, 1] + a[:, 1], st[:, 1])
                    # every fetched increment 0: every ancestor is a head
                    flags.append((v & (a[:, 1] != 0)).any())
                else:
                    aux2 = torch.where(v, torch.minimum(st[:, 1], a[:, 1]),
                                       st[:, 1])
                    flags.append(
                        (v & ((anc2 != st[:, 0]) | (aux2 != st[:, 1]))).any()
                    )
                states[s] = torch.stack([anc2, aux2], dim=1)
                ovf[s] = ovf[s] | o[s]
            changed = bool(any_reduce(self.mesh, flags))
            i += 1
        self.doubling_rounds += i
        self.doubling_seconds += time.perf_counter() - t0
        return ([st[:, 0] for st in states], [st[:, 1] for st in states], ovf,
                changed)

    def _rank_sampled(self, prev, valid):
        """The sampled two-level pass (the reference's ``rank_sampled``):
        per shard (head, rank, overflow), and ok, a host bool reduced over
        every shard; ok False requires the exact pass.

        Phase A: rulers cut into heads, doubling capped at
        SAMPLED_MAX_ROUNDS. Phase B: one query round fetches the stop and
        distance above each ruler's predecessor; the [D*K/STRIDE, 2]
        contracted list is gathered once onto every shard and doubled
        there for a fixed number of rounds (a fixpoint stays fixed, so the
        rows equal the reference's early-exit loop's) with no
        communication; its row of a ruler gid is gid // STRIDE. Phase C:
        each lane adds its stop's contracted rank."""
        s = SAMPLE_STRIDE
        prev2 = [torch.where(g % s == 0, -1, p)
                 for p, g in zip(prev, self.my_gid)]
        anc, dist, ovf_a, changed_a = self._double(
            prev2, valid, "dist",
            max_rounds=min(SAMPLED_MAX_ROUNDS, self.steps))
        if changed_a:  # the same on every rank: refuse before phase B
            return None, None, None, False
        pts = [p[::s] for p in prev]  # rulers sit at slots 0, s, 2s, ...
        pans, ovf_b = self._query_round(
            [torch.stack([a, ds], dim=1) for a, ds in zip(anc, dist)],
            pts, [pt >= 0 for pt in pts])
        local = [
            torch.stack([torch.where(pt >= 0, pa[:, 0], g[::s]),
                         torch.where(pt >= 0, pa[:, 1] + 1, 0)], dim=1)
            for pt, pa, g in zip(pts, pans, self.my_gid)
        ]
        gathered = all_gather_replicated(self.mesh, local)
        csteps = _csteps(gathered[0].shape[0])
        ranked = {}  # one copy of the replicated list's ranking a device
        refused = []
        head, rank = [], []
        for c0, a, ds in zip(gathered, anc, dist):
            key = (c0.device, c0.data_ptr())
            if key not in ranked:
                c, changed_b = _contracted_doubling(c0, csteps, "add")
                # a finished row's ancestor is a non-ruler real head or a
                # contracted head (initial distance 0); a ruler ancestor
                # that is neither closes a cycle through the rulers
                fa = c[:, 0]
                fa_r = fa % s == 0
                chead = c0[torch.where(fa_r, fa // s, 0), 1] == 0
                ranked[key] = c, changed_b | (fa_r & ~chead).any()
            c, bad = ranked[key]
            refused.append(bad)
            is_r_a = a % s == 0
            g = take_rows(c, torch.where(is_r_a, a // s, 0))
            head.append(torch.where(is_r_a, g[:, 0], a))
            rank.append(torch.where(is_r_a, ds + g[:, 1], ds))
        self.contracted_rounds += csteps
        ok = not bool(any_reduce(self.mesh, refused))
        return head, rank, [x | y for x, y in zip(ovf_a, ovf_b)], ok

    def _exact_rank(self, prev, valid):
        """Doubling + adaptive cycle break at the minimum GLOBAL id:
        (prev, ancestor, distance, overflow) per shard."""
        anc, dist, ovf, _ = self._double(prev, valid, "dist")
        # a pure cycle's distances double to exactly 2^steps
        thresh = 1 << min(self.steps, 29)
        if bool(any_reduce(self.mesh, [
            (v & (ds >= thresh)).any() for v, ds in zip(valid, dist)
        ])):
            _, mn, o_min, _ = self._double(prev, valid, "min")
            # in a cycle: my ancestor still has a predecessor
            pans, o_q = self._query_round(
                [torch.stack([p, p], dim=1) for p in prev], anc, valid
            )
            prev = [
                torch.where(v & (pa[:, 0] >= 0) & (g == m), -1, p)
                for p, v, pa, g, m in zip(prev, valid, pans, self.my_gid, mn)
            ]
            anc, dist, o_d, _ = self._double(prev, valid, "dist")
            ovf = [a | b | c | e for a, b, c, e in zip(ovf, o_min, o_q, o_d)]
        return prev, anc, dist, ovf

    def __call__(self, tables: list[CountTable]) -> ShardedUnitigs:
        """Per-shard filtered tables of c_shard rows (sorted keys at the
        front, sentinel padding) -> :class:`ShardedUnitigs`."""
        self.rounds = self.contracted_rounds = 0
        self.doubling_rounds, self.doubling_seconds = 0, 0.0
        mesh = self.mesh
        edges, covs, valid = [], [], []
        for t in tables:
            e, c, v = _build_edges(t, self.k)
            edges.append(e)
            covs.append(c)
            valid.append(v)
        prev, ovf_join, ovf_pair = self._link(edges, valid)
        ok = False
        if self.use_sampled:
            anc, dist, ovf_rank, ok = self._rank_sampled(prev, valid)
        if not ok:
            prev, anc, dist, ovf_rank = self._exact_rank(prev, valid)

        # global unitig numbering
        heads = [v & (p == -1) for v, p in zip(valid, prev)]
        all_counts = all_gather_replicated(
            mesh, [h.sum().reshape(1) for h in heads]
        )
        uid_states = []
        for g, h, ac in zip(mesh.local_shards, heads, all_counts):
            # heads of the global shards before this one come first
            head_rank = torch.cumsum(h, 0) - 1 + ac[:g].sum()
            uid_states.append(
                torch.stack([torch.where(h, head_rank, -1)] * 2, dim=1)
            )
        uans, ovf_uid = self._query_round(uid_states, anc, valid)
        overflow = max_reduce(mesh, [
            j.long() + 2 * p.long() + 4 * r.long() + 8 * u.long()
            for j, p, r, u in zip(ovf_join, ovf_pair, ovf_rank, ovf_uid)
        ])
        num_unitigs, ovf_bits = torch.stack(
            [all_counts[0].sum(), overflow]
        ).tolist()
        return ShardedUnitigs(
            valid=valid,
            uid=[torch.where(v, ua[:, 0], -1).to(torch.int32)
                 for v, ua in zip(valid, uans)],
            pos=[ds.to(torch.int32) for ds in dist],
            cov=covs,
            last_base=[(e[:, -1] & 3).to(torch.uint8) for e in edges],
            heads=heads,
            edge_limbs=edges,
            num_unitigs=num_unitigs,
            overflow=ovf_bits,
            query_rounds=self.rounds,
            doubling_rounds=self.doubling_rounds,
            doubling_seconds=self.doubling_seconds,
            rank_pass="sampled" if ok else "exact",
            contracted_rounds=self.contracted_rounds,
        )


def make_sharded_compress(mesh: Mesh, k: int, c_shard: int, *,
                          _exact: bool = False):
    """The sharded compression step: fn(per-shard filtered tables) ->
    :class:`ShardedUnitigs`. Routing overflow is flagged in its bitmask,
    never silent. The ranking is the reference's choice: the sampled pass
    where K = 2 * c_shard is a multiple of SAMPLE_STRIDE (and at least
    4 x it), the exact pass where that refuses or K is not; ``_exact``
    forces the exact pass (for the tests and the on-card check that hold
    both passes equal on one mesh)."""
    return _ShardedCompress(mesh, k, c_shard, exact=_exact)


def _segment_stats(uid_col, cnt_col, cov_col):
    """Per-distinct-uid (uid, sum cnt, sum cov, real) via one sort and
    neighbour differences of exclusive cumsums; the rows compact to the
    front in uid order. Rows with uid ``BIG`` are padding."""
    u_s, order = torch.sort(uid_col, stable=True)
    c_s = cnt_col[order].to(torch.int64)
    v_s = cov_col[order].to(torch.int64)
    n = u_s.shape[0]
    start = torch.ones(n, dtype=torch.bool, device=u_s.device)
    start[1:] = u_s[1:] != u_s[:-1]
    u_c = compact_front_sorted(start, u_s, BIG)
    ecnt_c = compact_front_sorted(start, torch.cumsum(c_s, 0) - c_s, 0)
    ecov_c = compact_front_sorted(start, torch.cumsum(v_s, 0) - v_s, 0)
    is_real = u_c < BIG
    last = torch.arange(n, device=u_s.device) == is_real.sum() - 1
    real_in = u_s < BIG

    def sums(excl, col):
        nxt = torch.cat([excl[1:], excl.new_zeros(1)])
        nxt = torch.where(last, torch.where(real_in, col, 0).sum(), nxt)
        return torch.where(is_real, nxt - excl, 0)

    return u_c, sums(ecnt_c, c_s), sums(ecov_c, v_s), is_real


class _ShardedSpell:
    """The sharded spelling reduction for one (mesh, k, c_shard, u_block,
    route_slack)."""

    def __init__(self, mesh: Mesh, k: int, c_shard: int, u_block: int,
                 route_slack: float = 2.0):
        self.mesh, self.d, self.u_block = mesh, axis_size(mesh), u_block
        self.k_cap = 2 * c_shard
        self.cap_route = _route_cap(self.k_cap, self.d, route_slack)

    def __call__(self, valid, uid, pos, cov, heads, edge_limbs):
        """-> (packed bases [ceil(K/4)] uint8, lengths [u_block], coverage
        sums [u_block], head limbs [u_block, n_limbs]) per shard, the
        head counts per shard and the overflow flag (host values)."""
        mesh, d, ub, k_cap = self.mesh, self.d, self.u_block, self.k_cap
        uid = [u.to(torch.int64) for u in uid]
        all_counts = all_gather_replicated(
            mesh, [h.sum().reshape(1) for h in heads]
        )
        offs = [torch.cumsum(ac, 0) - ac for ac in all_counts]
        # head tables: a head's uid was numbered on its own shard, so its
        # words scatter locally; row u_block is the dump slot
        head_bufs, stat_sends, ovf = [], [], []
        first = mesh.first_shard
        for s in range(mesh.local_size):
            my_off = offs[s][first + s]
            h = heads[s]
            nl = edge_limbs[s].shape[1]
            hslot = torch.where(h, uid[s] - my_off, ub).clamp(max=ub)
            buf = torch.full((ub + 1, nl), SENTINEL, dtype=torch.int64,
                             device=h.device)
            buf[hslot] = edge_limbs[s]
            head_bufs.append(buf[:ub])
            # per-unitig partial stats, routed to the uid's numbering shard
            u_c, cnt_p, cov_p, real_p = _segment_stats(
                torch.where(valid[s], uid[s], BIG),
                valid[s].to(torch.int64),
                torch.where(valid[s], cov[s], 0),
            )
            owner_u = (torch.searchsorted(offs[s], u_c, right=True) - 1
                       ).clamp(0, d - 1)
            send, o1 = bucket_pack(torch.stack([u_c, cnt_p, cov_p], dim=1),
                                   owner_u, real_p, d, ub, -1)
            stat_sends.append(send)
            ovf.append((all_counts[s] > ub).any() | o1)
        lengths, covs = [], []
        for s, recv in enumerate(all_to_all(mesh, stat_sends)):
            ruid = torch.where(recv[:, 0] >= 0, recv[:, 0], BIG)
            u2c, len_u, cov_u, real2 = _segment_stats(
                ruid, recv[:, 1], recv[:, 2]
            )
            slot2 = torch.where(real2, u2c - offs[s][first + s],
                                ub).clamp(max=ub)
            ln = torch.zeros(ub + 1, dtype=torch.int32, device=ruid.device)
            cv = torch.zeros(ub + 1, dtype=torch.int32, device=ruid.device)
            ln[slot2] = len_u.to(torch.int32)
            cv[slot2] = cov_u.to(torch.int32)
            lengths.append(ln[:ub])
            covs.append(cv[:ub])
        # global unitig offsets: masked cumsum over the gathered lengths
        lengths_all = all_gather_replicated(mesh, lengths)
        route_sends = []
        for s in range(mesh.local_size):
            dev = uid[s].device
            lane = torch.arange(ub, device=dev)
            vm = lane[None, :] < all_counts[s][:, None]
            flat = torch.where(vm, lengths_all[s].reshape(d, ub).long(), 0)
            flat = flat.reshape(-1)
            excl = torch.cumsum(flat, 0) - flat
            o_dev = (torch.searchsorted(offs[s], uid[s], right=True) - 1
                     ).clamp(0, d - 1)
            fidx = (o_dev * ub + uid[s] - offs[s][o_dev]).clamp(0, d * ub - 1)
            g = excl[fidx] + pos[s].long()
            # (g % k_cap) * 4 | base to the chunk owner g // k_cap
            base = edge_limbs[s][:, -1] & 3
            pay = torch.where(valid[s], (g % k_cap) * 4 + base, -1)
            dest = torch.where(valid[s], g // k_cap, 0)
            send, o2 = bucket_pack(pay[:, None], dest, valid[s], d,
                                   self.cap_route, -1)
            route_sends.append(send)
            ovf[s] = ovf[s] | o2
        k4 = -(-k_cap // 4) * 4
        packed = []
        for recv in all_to_all(mesh, route_sends):
            recv = recv[:, 0]
            bslot = torch.where(recv >= 0, recv // 4, k4)
            bases = torch.zeros(k4 + 1, dtype=torch.uint8, device=recv.device)
            bases[bslot] = (recv & 3).to(torch.uint8)
            q = bases[:k4].reshape(-1, 4)
            packed.append(q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
                          | (q[:, 3] << 6))
        head_counts_and_ovf = torch.cat([
            all_counts[0], any_reduce(mesh, ovf).reshape(1).to(torch.int64)
        ]).tolist()
        return (packed, lengths, covs, head_bufs,
                head_counts_and_ovf[:d], bool(head_counts_and_ovf[d]))


def make_sharded_spell(mesh: Mesh, k: int, c_shard: int, u_block: int,
                       route_slack: float = 2.0):
    """The sharded spelling reduction (see the module docstring, step 5).
    Overflow (u_block or a routing cap) is flagged, never silent; the
    caps are terminal at u_block = cap_route = k_cap (a sender cannot
    route more rows than it has), so the caller's retry loop lands."""
    return _ShardedSpell(mesh, k, c_shard, u_block, route_slack)


def spell_sharded_arrays(
    mesh: Mesh, k: int, c_shard: int, num_unitigs: int,
    valid, uid, pos, cov, heads, edge_limbs, *,
    u_block: int | None = None, metrics: Metrics | None = None,
) -> UnitigArrays:
    """Sharded spelling -> the host's columnar UnitigArrays.

    The host pulls E/4 bytes of packed bases + O(num_unitigs) per-unitig
    rows (across processes every rank pulls all D shards' and ends with
    the same arrays). On a flagged overflow it retries with grown caps
    (u_block x4 up to k_cap, route slack x2 up to D). metrics:
    ``a2a_bytes_spell`` adds each attempt's send-buffer bytes
    (:func:`wire_bytes`).
    """
    d = axis_size(mesh)
    k_cap = 2 * c_shard
    u = int(num_unitigs)
    if u == 0:
        return build_unitig_arrays(
            np.empty(0, np.uint8), np.empty(0, np.int64),
            np.empty(0, np.int64), np.empty((0, key_words(k)), np.uint32), k,
        )
    u_block = u_block or min(k_cap, snug_capacity(-(-2 * u // d),
                                                  floor=1 << 10))
    route_slack = 2.0
    while True:
        spell = make_sharded_spell(mesh, k, c_shard, u_block, route_slack)
        if metrics is not None:
            metrics.count("a2a_bytes_spell",
                          wire_bytes(d, k, c_shard, u_block, route_slack)["spell"])
        packed, lengths, covs, head_bufs, counts, ovf = spell(
            valid, uid, pos, cov, heads, edge_limbs
        )
        if not ovf:
            break
        if u_block >= k_cap and route_slack >= d:
            raise RuntimeError(
                "sharded spell overflow at terminal caps (unreachable by "
                "construction; see make_sharded_spell)"
            )
        u_block = min(k_cap, u_block * 4)
        route_slack = min(route_slack * 2, d)
    if sum(counts) != u:
        raise AssertionError(
            f"spell head counts {sum(counts)} != num_unitigs {u}"
        )
    def heads_of(xs):
        """All D shards' per-unitig rows on the host, each shard cut to
        its head count."""
        return np.concatenate(
            [x[:n] for x, n in zip(gather_to_host(mesh, xs), counts)])

    lens = heads_of(lengths).astype(np.int64)
    cov_sum = heads_of(covs).astype(np.int64)
    head_w = limbs_to_words(heads_of(head_bufs), k)
    total_body = int(lens.sum())
    # chunk j holds global body positions [j*k_cap, (j+1)*k_cap)
    bases = np.concatenate([
        unpack_codes_np(chunk, min(k_cap, max(0, total_body - j * k_cap)))
        for j, chunk in enumerate(gather_to_host(mesh, packed))
    ])
    return build_unitig_arrays(bases, lens, cov_sum, head_w, k)
