"""Unitig compression by pointer doubling and spelling.

Counterpart of ``genome_assembler_tpu/ops/unitig_jax.py``:

  1. both-strand edge table: canonical k-mers + their reverse complements,
     lexicographically sorted -- edge id == sorted position;
  2. successor linking: edge e chains into the unique edge whose prefix
     node equals suffix(e) iff that node has outdeg == indeg == 1, found
     by one sort of tagged prefix/suffix node keys (``_link_sortjoin``);
  3. chain heads and offsets by pointer doubling over the predecessor
     pointers; pure cycles break at their smallest edge id. Edge tables
     of at least ``SAMPLED_MIN_ROWS`` rows take the reference's sampled
     two-level ranking (``_rank_sampled``: doubling to the nearest ruler,
     then over the E/32 contracted rulers), then its cycle-aware variant
     (``_rank_sampled_cyclic``), and the exact pass (``_resolve_exact``)
     only where both refuse; smaller tables take the exact pass;
  4. ``spell_arrays`` reduces the edge table to the compact per-unitig
     transfer set that the host spells.

uid, pos, cov, valid and ``num_unitigs`` equal the reference bit for bit,
and so do every ranking's (head, rank, ok). Ids and distances are int64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.keys import SENTINEL, is_sentinel
from .count_torch import (
    CountTable,
    compact_front_sorted,
    sort_by_words,
    take_rows,
)
from .words_torch import (
    prefix_node,
    revcomp_words,
    shift_left_words,
    shift_right_words,
    suffix_node,
)


class DeviceUnitigs(NamedTuple):
    """Edge-level unitig assignment, capacity E = 2C (invalid rows masked).

    edge_limbs: [E, n_limbs] sorted directed edge k-mers (both strands).
    cov:        [E] int32 multiplicity per edge.
    uid:        [E] int32 unitig id (dense, 0..num_unitigs-1) or -1.
    pos:        [E] int32 position of the edge within its unitig chain.
    valid:      [E] bool.
    num_unitigs: 0-d int64 tensor.
    """

    edge_limbs: torch.Tensor
    cov: torch.Tensor
    uid: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor
    num_unitigs: torch.Tensor


def _doubling(prev: torch.Tensor, steps: int, track: str = "dist"):
    """Pointer doubling over predecessor pointers (``unitig_jax._doubling``).

    prev[e] = predecessor edge id or -1; heads self-loop, so the ancestor
    converges to the chain head. track "dist" carries the distance from
    the head; "min" carries the minimum edge id on the ancestor path (the
    cycle break point). (anc, aux) ride one [E, 2] tensor, so each round
    is one row gather.

    The loop runs at most ``steps`` rounds and stops at a fixpoint. The
    convergence flag is read back to the host every round (one scalar
    sync per round). "dist" has converged when every gathered distance is
    0 (every ancestor is a head); a pure cycle never converges, so its
    distances double to exactly 2^steps, which ``_rank_pass`` detects.
    Returns (ancestor, tracked, changed, rounds): ``changed`` is True iff
    the cap ran out before a fixpoint (a cycle, or a chain longer than
    2^steps), the sampled passes' fallback trigger.
    """
    n = prev.shape[0]
    ids = torch.arange(n, device=prev.device)
    anc = torch.where(prev >= 0, prev, ids)
    if track == "dist":
        aux = (prev >= 0).to(torch.int64)
    else:
        aux = torch.minimum(ids, anc)
    state = torch.stack([anc, aux], dim=1)
    changed = True
    i = 0
    while i < steps and changed:
        g = take_rows(state, state[:, 0])
        if track == "dist":
            new = torch.stack([g[:, 0], state[:, 1] + g[:, 1]], dim=1)
            changed = bool((g[:, 1] != 0).any())
        else:
            new = torch.stack(
                [g[:, 0], torch.minimum(state[:, 1], g[:, 1])], dim=1
            )
            changed = bool((new != state).any())
        state = new
        i += 1
    return state[:, 0], state[:, 1], changed, i


def _build_edges(table: CountTable, k: int):
    """Both-strand sorted edge table: (edge_limbs [2C, n_limbs], covs
    [2C] int32, valid [2C] bool). Edge ids are sorted positions (the
    sharded graph adds its shard's offset)."""
    c = table.limbs.shape[0]
    is_real = torch.arange(c, device=table.limbs.device) < table.num_unique
    rc = revcomp_words(table.limbs, k)
    rc = torch.where(is_real[:, None], rc, SENTINEL)
    edges = torch.cat([table.limbs, rc])
    real2 = torch.cat([is_real, is_real])
    covs = torch.where(real2, torch.cat([table.counts, table.counts]), 0)
    edges, covs = sort_by_words(edges, covs)
    return edges, covs, ~is_sentinel(edges)


def _link_sortjoin(edge_limbs: torch.Tensor, valid: torch.Tensor, k: int):
    """prev[] via one sort of tagged node keys (``unitig_jax._link_sortjoin``).

    Every edge contributes its prefix node (tag 0) and its suffix node
    (tag 1); the tag rides in the node key's spare low bit, so within a
    key run the prefix entries precede the suffix entries. A suffix entry
    in a run of exactly [prefix, suffix] links its edge to the prefix
    entry's edge; a masked index write sets prev[successor] = edge
    (targets are unique since the node has indeg == 1).
    """
    e = edge_limbs.shape[0]
    dev = edge_limbs.device
    pre_p = shift_left_words(prefix_node(edge_limbs, k), 1)
    suf_p = shift_left_words(suffix_node(edge_limbs, k), 1)
    suf_p[:, -1] |= 1  # the sign flip of a low limb leaves bit 0 alone
    ids = torch.arange(e, device=dev)
    keys = torch.cat([pre_p, suf_p])
    valid2 = torch.cat([valid, valid])
    # invalid rows: pin the packed key to the sentinel (a real packed key
    # never equals it: its high limb is below 2^62)
    keys = torch.where(valid2[:, None], keys, SENTINEL)
    packed_s, pay_s = sort_by_words(keys, torch.cat([ids, ids]))
    sent_rows = is_sentinel(packed_s)
    is_pre = (packed_s[:, -1] & 1) == 0
    key_s = shift_right_words(packed_s, 1)
    key_s = torch.where(sent_rows[:, None], SENTINEL, key_s)
    good, succ = join_scan(key_s, is_pre, pay_s)
    prev = torch.full((e + 1,), -1, dtype=torch.int64, device=dev)
    prev[torch.where(good, succ, e)] = pay_s
    return prev[:e]


def join_scan(key_s: torch.Tensor, is_pre: torch.Tensor, pay_s: torch.Tensor):
    """Run-scan core of the tagged successor join (``unitig_jax.join_scan``).

    A suffix lane is ``good`` iff its key run is exactly [prefix, suffix]:
    it continues its predecessor's run, the run ends here, and the lane
    above is a prefix entry that starts the run. ``succ`` is the payload
    one lane above (meaningless where not good).
    """
    n2 = key_s.shape[0]
    dev = key_s.device
    same_as_prev = torch.zeros(n2, dtype=torch.bool, device=dev)
    if n2 > 1:
        same_as_prev[1:] = (key_s[1:] == key_s[:-1]).all(dim=1)
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    same_as_next = torch.cat([same_as_prev[1:], false1])
    pre_above = torch.cat([false1, is_pre[:-1]])
    run_continues_above = torch.cat([~false1, same_as_prev[:-1]])
    good = (
        ~is_pre
        & pre_above
        & same_as_prev
        & ~same_as_next
        & ~run_continues_above
        & ~is_sentinel(key_s)
    )
    succ = torch.cat([pay_s.new_zeros(1), pay_s[:-1]])
    return good, succ


def _steps_for(e: int) -> int:
    # the reference carries distances in int32: dist doubles to exactly
    # 2^steps in cycles, and steps = ceil(log2(e)) + 1 <= 30 requires
    # e <= 2^29. The port keeps the same bound and error.
    if e > (1 << 29):
        raise ValueError(
            f"edge table of {e} rows exceeds the int32 pointer-doubling "
            "range (2^29); the sharded graph path (assemble_distributed_"
            "sharded, ga-torch assemble --backend dist --sharded-graph) "
            "holds 1/D of it per shard under the same global bound"
        )
    return max(1, int(np.ceil(np.log2(max(e, 2)))) + 1)


def _rank_pass(prev: torch.Tensor, rounds: dict | None = None):
    """One doubling pass: (ancestor, distance, any_cycle). Pure-cycle
    distances reach exactly 2^steps; chain distances stay below it.
    ``rounds["exact"]`` (if given) adds the rounds run."""
    steps = _steps_for(prev.shape[0])
    anc, dist, _, n = _doubling(prev, steps, track="dist")
    if rounds is not None:
        rounds["exact"] = rounds.get("exact", 0) + n
    return anc, dist, bool((dist >= (1 << steps)).any())


def _break_cycles(prev: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Min-id doubling pass; returns prev with each cycle's minimum edge
    turned into a head."""
    e = prev.shape[0]
    ids = torch.arange(e, device=prev.device)
    anc, mn, _, _ = _doubling(prev, _steps_for(e), track="min")
    in_cycle = valid & (prev[anc] >= 0)
    return torch.where(in_cycle & (ids == mn), -1, prev)


def _finalize_chains(prev, anc, dist, valid):
    heads = valid & (prev == -1)
    head_rank = torch.cumsum(heads, 0) - 1
    uid = torch.where(valid, head_rank[anc], -1)
    return uid.to(torch.int32), dist.to(torch.int32), heads.sum()


# The sampled two-level ranking (``unitig_jax.py:320-553``). Every
# SAMPLE_STRIDE-th edge id is a ruler; edge ids are sort positions,
# unrelated to chain order, so the gaps between rulers along a chain are
# about SAMPLE_STRIDE * ln(E / SAMPLE_STRIDE), far below
# 2^(SAMPLED_MAX_ROUNDS - 1). The reference's value of every constant, so
# both packages take the same pass on the same table.
SAMPLE_STRIDE = 32
SAMPLED_MAX_ROUNDS = 16
# edge tables below this take the exact pass (tests set it to 0 to force
# the sampled passes on tiny graphs)
SAMPLED_MIN_ROWS = 1 << 21


def _contracted_doubling(state: torch.Tensor, steps: int, combine: str):
    """Doubling over the contracted ruler list: row t is ruler t*S's
    (ancestor id, carried value). An ancestor that is a ruler is followed
    to its row (row gid // S, on one device and for the sharded graph's
    gathered list alike); any other ancestor is a real head and the row
    is done. combine "add" sums the distances, "min" keeps the running
    minimum. Runs exactly ``steps`` rounds with no host read (a fixpoint
    stays fixed, so the rows are those of a loop that stops at it).
    Returns (state, changed): ``changed``, a 0-d bool tensor, says whether
    the last round still changed a row."""
    s = SAMPLE_STRIDE
    changed = torch.ones((), dtype=torch.bool, device=state.device)
    for _ in range(steps):
        canc, cval = state[:, 0], state[:, 1]
        is_r = canc % s == 0
        g = take_rows(state, torch.where(is_r, canc // s, 0))
        val = cval + g[:, 1] if combine == "add" else torch.minimum(cval, g[:, 1])
        new = torch.stack(
            [torch.where(is_r, g[:, 0], canc), torch.where(is_r, val, cval)],
            dim=1,
        )
        changed = (new != state).any()
        state = new
    return state, changed


def _phase_a(prev: torch.Tensor):
    """Phase A of the sampled ranking: rulers cut into heads, then capped
    doubling. Every lane ends at its nearest upstream stop (a ruler or a
    real head) with the distance to it. -> (anc, dist, changed, rounds)."""
    e = prev.shape[0]
    ids = torch.arange(e, device=prev.device)
    prev2 = torch.where(ids % SAMPLE_STRIDE == 0, -1, prev)
    return _doubling(prev2, min(SAMPLED_MAX_ROUNDS, _steps_for(e)), "dist")


def _csteps(n_r: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n_r, 2)))) + 1)


def _phases_bc(prev: torch.Tensor, anc: torch.Tensor, dist: torch.Tensor):
    """Phases B + C (``unitig_jax._phases_bc``): contract the ruler list,
    double over it, then give every lane its stop's contracted rank in one
    full-size gather. -> (head, rank, ok, rounds of phase B).

    Ruler t's predecessor pt chains to stop anc[pt] at distance dist[pt]
    + 1; a ruler that is a real head is its own stop at distance 0. ok is
    False if the contracted list still changed at its cap, or if a
    finished row's ancestor is a ruler that still has a predecessor (a
    cycle threading the rulers: the reference's wrap-free check)."""
    e = prev.shape[0]
    s = SAMPLE_STRIDE
    n_r = -(-e // s)
    r_ids = torch.arange(n_r, device=prev.device) * s
    pt = prev[r_ids]
    pt_c = pt.clamp(min=0)
    a0 = torch.where(pt >= 0, anc[pt_c], r_ids)
    d0 = torch.where(pt >= 0, dist[pt_c] + 1, 0)
    rounds = _csteps(n_r)
    cstate, changed_b = _contracted_doubling(
        torch.stack([a0, d0], dim=1), rounds, "add")
    fa = cstate[:, 0]
    cycle_b = ((fa % s == 0) & (prev[fa] >= 0)).any()
    is_r_a = anc % s == 0
    g = take_rows(cstate, torch.where(is_r_a, anc // s, 0))
    head = torch.where(is_r_a, g[:, 0], anc)
    rank = torch.where(is_r_a, dist + g[:, 1], dist)
    return head, rank, not bool(changed_b | cycle_b), rounds


def _rank_sampled(prev: torch.Tensor, rounds: dict | None = None):
    """Sampled two-level ranking (``unitig_jax._rank_sampled``): (head,
    rank, ok). Phase A doubles only to the nearest ruler (capped at
    SAMPLED_MAX_ROUNDS), phase B over the E/32 contracted rulers, phase C
    combines. Bit-identical to the exact pass on acyclic graphs; ok False
    (phase A hit its cap: a cycle without a ruler, or a huge gap; or a
    cycle through the rulers) means the caller must take another pass.
    ``rounds`` (if given) receives the rounds of phases A and B."""
    anc, dist, changed_a, ra = _phase_a(prev)
    head, rank, ok_bc, rb = _phases_bc(prev, anc, dist)
    if rounds is not None:
        rounds.update(a=ra, b=rb)
    return head, rank, not changed_a and ok_bc


def _rank_sampled_cyclic(prev: torch.Tensor, rounds: dict | None = None):
    """Sampled ranking of a graph with cycles
    (``unitig_jax._rank_sampled_cyclic``): (head, rank, ok, prev_broken).

    Phase A as usual; the smallest id whose stop is each ruler (one
    scatter-min); doubling over the contracted list carrying the running
    minimum for a fixed ceil(log2(E/32)) + 1 rounds, after which every
    ruler on a cycle holds the cycle's smallest edge id; that edge becomes
    a head; then phases A-C again on the broken graph. ok is False iff a
    cycle holds no ruler (its lanes never resolve). The caller finalizes
    against ``prev_broken``. ``rounds`` (if given) receives the rounds of
    both phase-A passes ("a"), of the minimum's doubling ("d") and of the
    second phase B ("b")."""
    e = prev.shape[0]
    s = SAMPLE_STRIDE
    dev = prev.device
    ids = torch.arange(e, device=dev)
    anc, _, changed_a, ra = _phase_a(prev)
    # the segment minimum of every ruler's lanes (the ruler's own id is
    # among them; lanes whose stop is a real head go to the dump slot)
    n_r = -(-e // s)
    seg = torch.full((n_r + 1,), e, dtype=torch.int64, device=dev)
    seg.scatter_reduce_(0, torch.where(anc % s == 0, anc // s, n_r), ids,
                        reduce="amin")
    r_ids = torch.arange(n_r, device=dev) * s
    pt = prev[r_ids]
    a0 = torch.where(pt >= 0, anc[pt.clamp(min=0)], r_ids)
    csteps = _csteps(n_r)
    dstate, _ = _contracted_doubling(
        torch.stack([a0, seg[:n_r]], dim=1), csteps, "min")
    fa = dstate[:, 0]
    # a ruler is on a cycle iff its final ancestor is a ruler that still
    # has a predecessor (phase B's wrap-free test)
    is_cyc_r = (fa % s == 0) & (prev[fa] >= 0)
    is_r_a = anc % s == 0
    slot_a = torch.where(is_r_a, anc // s, 0)
    breaks = is_r_a & is_cyc_r[slot_a] & (ids == dstate[:, 1][slot_a])
    prev3 = torch.where(breaks, -1, prev)
    anc2, dist2, changed_a2, ra2 = _phase_a(prev3)
    head, rank, ok_bc, rb = _phases_bc(prev3, anc2, dist2)
    if rounds is not None:
        rounds.update(a=ra + ra2, d=csteps, b=rb)
    return head, rank, not changed_a and not changed_a2 and ok_bc, prev3


def _resolve_exact(prev: torch.Tensor, valid: torch.Tensor,
                   rounds: dict | None = None):
    """Exact path: plain doubling + adaptive cycle break + finalize."""
    anc, dist, has_cycle = _rank_pass(prev, rounds)
    if has_cycle:
        prev = _break_cycles(prev, valid)
        anc, dist, _ = _rank_pass(prev, rounds)
    return _finalize_chains(prev, anc, dist, valid)


def _resolve_chains(prev: torch.Tensor, valid: torch.Tensor, *,
                    exact: bool = False, rounds: dict | None = None):
    """(uid, pos, num_unitigs) by the reference's choice of pass
    (``unitig_jax.py:865-885``): at SAMPLED_MIN_ROWS rows or more the
    sampled pass, then the cyclic one, then the exact pass, each taken
    only where the one before refused; below, or with ``exact``, the exact
    pass. ``rounds["pass"]`` (if given) names the pass that answered."""
    rounds = {} if rounds is None else rounds
    if not exact and prev.shape[0] >= SAMPLED_MIN_ROWS:
        head, rank, ok = _rank_sampled(prev, rounds)
        if ok:
            rounds["pass"] = "sampled"
            return _finalize_chains(prev, head, rank, valid)
        head, rank, ok, prev3 = _rank_sampled_cyclic(prev, rounds)
        if ok:
            rounds["pass"] = "cyclic"
            return _finalize_chains(prev3, head, rank, valid)
    rounds["pass"] = "exact"
    return _resolve_exact(prev, valid, rounds)


def compress_unitigs_device(table: CountTable, k: int, *,
                            rounds: dict | None = None,
                            _exact: bool = False) -> DeviceUnitigs:
    """Filtered canonical CountTable -> unitig chain assignment.

    Requires odd k (no palindromic k-mers, so the both-strand edge set has
    exactly two distinct directed edges per canonical k-mer). The ranking
    is the reference's choice (``_resolve_chains``). rounds: a dict that
    receives the pass taken and its doubling rounds. ``_exact`` forces the
    exact pass (for the tests and the on-card check that hold both passes
    equal).
    """
    if k % 2 == 0:
        raise ValueError("device unitig compression requires odd k")
    if 2 * table.limbs.shape[0] >= (1 << 29):
        raise ValueError(
            "edge table too large for device compression "
            f"({2 * table.limbs.shape[0]} rows >= 2^29); reduce the table "
            "capacity. The gathered assemble_distributed compresses on one "
            "device too; the sharded graph path (assemble_distributed_"
            "sharded, ga-torch assemble --backend dist --sharded-graph) "
            "holds 1/D of the edge table per shard, under the same global "
            "bound"
        )
    edge_limbs, covs, valid = _build_edges(table, k)
    prev = _link_sortjoin(edge_limbs, valid, k)
    uid, pos, num = _resolve_chains(prev, valid, exact=_exact, rounds=rounds)
    return DeviceUnitigs(
        edge_limbs=edge_limbs,
        cov=covs,
        uid=uid,
        pos=pos,
        valid=valid,
        num_unitigs=num,
    )


class SpellArrays(NamedTuple):
    """Compact spelling transfer set (``unitig_jax.SpellArrays``).

    bases:      [ceil(E/4)] uint8 -- last base of every edge in (uid, pos)
                order, packed 4 per byte (``utils.dna.pack_codes`` layout).
    head_limbs: [U_cap, n_limbs] -- the head edge k-mer of each unitig.
    lengths:    [U_cap] int32 edge counts per unitig (0 = padding).
    cov_sum:    [U_cap] int32 summed edge multiplicities per unitig.
    num_unitigs: 0-d int64.
    overflow:   0-d bool -- num_unitigs exceeded U_cap; retry larger.
    """

    bases: torch.Tensor
    head_limbs: torch.Tensor
    lengths: torch.Tensor
    cov_sum: torch.Tensor
    num_unitigs: torch.Tensor
    overflow: torch.Tensor


_INVALID_UID = 1 << 30


def spell_arrays(dev: DeviceUnitigs, u_cap: int) -> SpellArrays:
    """Reduce DeviceUnitigs to the compact transfer set (see SpellArrays).

    One sort puts every edge in (uid, pos) order: uid (invalid rows
    2^30), pos and the 2-bit last base pack into one int64 key
    ``uid << 32 | pos << 2 | base`` (uid <= 2^30 and pos < 2^29, so it
    fits). Per-unitig lengths and coverage sums come from neighbouring
    differences of (position, exclusive coverage cumsum) at the run
    starts, compacted to the front. ``u_cap`` must not exceed E.
    """
    e = dev.edge_limbs.shape[0]
    if u_cap > e:
        raise ValueError(f"u_cap={u_cap} exceeds the edge table ({e} rows)")
    d = dev.edge_limbs.device
    uid_adj = torch.where(dev.valid, dev.uid.to(torch.int64), _INVALID_UID)
    packed = (dev.pos.to(torch.int64) << 2) | (dev.edge_limbs[:, -1] & 3)
    key_s, order = torch.sort((uid_adj << 32) | packed)
    uid_s = key_s >> 32
    cov_s = dev.cov[order].to(torch.int64)
    limbs_s = dev.edge_limbs[order]
    bases = (key_s & 3).to(torch.uint8)
    e4 = -(-e // 4) * 4
    quads = torch.cat([bases, bases.new_zeros(e4 - e)]).reshape(-1, 4)
    bases_packed = (
        quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
    )

    idx = torch.arange(e, device=d)
    run_start = torch.ones(e, dtype=torch.bool, device=d)
    if e > 1:
        run_start[1:] = uid_s[1:] != uid_s[:-1]
    valid_lane = uid_s != _INVALID_UID
    num = (run_start & valid_lane).sum()
    e_valid = valid_lane.sum()
    excl_cov = torch.cumsum(cov_s, 0) - cov_s
    total_cov = torch.where(valid_lane, cov_s, 0).sum()
    # per-unitig rows (run starts, already in uid order) to the front;
    # the invalid run's first row lands right after the last real unitig
    pos_c = compact_front_sorted(run_start, idx, 0)[:u_cap]
    excl_c = compact_front_sorted(run_start, excl_cov, 0)[:u_cap]
    head = compact_front_sorted(run_start, limbs_s, SENTINEL)[:u_cap]
    out_idx = torch.arange(u_cap, device=d)
    last = out_idx == num - 1
    nxt_pos = torch.where(last, e_valid, torch.cat([pos_c[1:], pos_c.new_zeros(1)]))
    nxt_cov = torch.where(
        last, total_cov, torch.cat([excl_c[1:], excl_c.new_zeros(1)])
    )
    real = out_idx < num
    return SpellArrays(
        bases=bases_packed,
        head_limbs=head,
        lengths=torch.where(real, nxt_pos - pos_c, 0).to(torch.int32),
        cov_sum=torch.where(real, nxt_cov - excl_c, 0).to(torch.int32),
        num_unitigs=num,
        overflow=num > u_cap,
    )
