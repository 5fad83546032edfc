"""TPC-H Q3 incremental maintenance: one tick on one GPU.

Counterpart of materialize_tpu/models/fused_q3.py (`q3_tick` without its
exchange branch, `q3_tick_single`, `hydrate`, `hydration_output`). One tick
runs three MFP filters, the three delta-join paths through LSM-levelled
arrangements, the revenue closure, the accumulable SUM reduce and the LSM
inserts and merges. Capacities are static; overflow flags (bool tensors,
read by the caller after the tick) replace resizing. The tick's only host
reads are the probe-widening decisions of the accumulator lookups
(ops/reduce.py, HOST_SYNCS).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from ..arrangement.lsm import (
    LsmAccums,
    LsmBatches,
    accum_lsm_insert,
    accum_lsm_lookup,
    lsm_insert,
    lsm_join,
)
from ..arrangement.spine import arrange_batch
from ..expr import CallBinary, Column, Literal, MapFilterProject
from ..ops.consolidate import compact_to, consolidate, merge_consolidate
from ..ops.join import join_against
from ..ops.reduce import (
    AccumState,
    AggregateExpr,
    _contributions,
    _emit_output,
    collision_errs,
    consolidate_accums,
)
from ..repr.batch import DIFF_DTYPE, PAD_TIME, UpdateBatch, bucket_cap, device_time_scalar
from ..repr.hashing import PAD_HASH
from .tpch import BUILDING, Q3_DATE

RATIO = 8  # LSM merge ratio
_TORCH = {"int32": torch.int32, "int64": torch.int64}


def level_caps(full: int, small: int, k: int = 3, ratio: int = RATIO) -> tuple:
    """Geometric level capacities (small, ..., full)."""
    caps = [full]
    for _ in range(k - 1):
        caps.append(max(bucket_cap(small), caps[-1] // max(int(ratio), 2)))
    caps.reverse()
    for i in range(1, k):  # monotone non-decreasing
        caps[i] = max(caps[i], caps[i - 1])
    return tuple(caps)


@dataclass(frozen=True)
class Q3Caps:
    """Static capacities (the JAX package's, less the mesh-only `bucket`)."""

    cust: int = 1 << 14
    orders: int = 1 << 15
    lineitem: int = 1 << 16
    delta: int = 1 << 10  # per-tick delta rows per input
    join_out: int = 1 << 12
    groups: int = 1 << 15
    levels: int = 3
    # value-column dtype; aggregate accumulators stay int64 regardless
    val_dtype: str = "int64"

    def arr_levels(self, full: int) -> tuple:
        return level_caps(full, self.delta * 4, self.levels)


@dataclass
class Q3State:
    cust_by_ck: LsmBatches  # (ck)
    ord_by_ck: LsmBatches  # (ok, ck, od, sp) keyed ck
    ord_by_ok: LsmBatches  # keyed ok
    li_by_ok: LsmBatches  # (lk, ep, dc) keyed lk
    accum: LsmAccums  # key (lk, od, sp) -> sum(rev)

    @staticmethod
    def empty(caps: Q3Caps, device="cuda") -> "Q3State":
        V = _TORCH[caps.val_dtype]
        I64 = torch.int64
        return Q3State(
            cust_by_ck=LsmBatches.empty(caps.arr_levels(caps.cust), (V,), (V,), device),
            ord_by_ck=LsmBatches.empty(caps.arr_levels(caps.orders), (V,), (V,) * 4, device),
            ord_by_ok=LsmBatches.empty(caps.arr_levels(caps.orders), (V,), (V,) * 4, device),
            li_by_ok=LsmBatches.empty(caps.arr_levels(caps.lineitem), (V,), (V,) * 3, device),
            accum=LsmAccums.empty(caps.arr_levels(caps.groups), (V, V, V), (I64,), device),
        )


_CUST_MFP = MapFilterProject(
    3, predicates=(CallBinary("eq", Column(1), Literal(BUILDING)),), projection=(0,)
)
_ORD_MFP = MapFilterProject(
    4, predicates=(CallBinary("lt", Column(2), Literal(Q3_DATE)),), projection=(0, 1, 2, 3)
)
_LI_MFP = MapFilterProject(
    6, predicates=(CallBinary("gt", Column(3), Literal(Q3_DATE)),), projection=(0, 1, 2)
)
# canonical join output: (ck, ok, ck, od, sp, lk, ep, dc)
_CLOSURE = MapFilterProject(
    8,
    map_exprs=(CallBinary("mul", Column(6), CallBinary("sub", Literal(100), Column(7))),),
    projection=(5, 3, 4, 8),  # (lk, od, sp, rev)
)
_AGGS = (AggregateExpr("sum", Column(3)),)


def _project_cols(batch: UpdateBatch, perm) -> UpdateBatch:
    return UpdateBatch(
        batch.hashes, (), tuple(batch.vals[i] for i in perm), batch.times, batch.diffs
    )


def _concat_all(batches: list) -> UpdateBatch:
    acc = batches[0]
    for b in batches[1:]:
        acc = UpdateBatch.concat(acc, b)
    return acc


def q3_tick(
    state: Q3State,
    d_cust: UpdateBatch,
    d_ord: UpdateBatch,
    d_li: UpdateBatch,
    time: int,
    *,
    caps: Q3Caps,
    with_cust: bool = True,
):
    """One Q3 maintenance tick. Returns (state', out_delta, errs, overflow).

    Raw deltas carry full table schemas. `time` (a Python int) doubles as
    the LSM merge schedule counter, so ticks should be consecutive integers.
    `with_cust=False` leaves the customer delta path out (TPC-H RF1/RF2
    never touch customer). `overflow` is a bool tensor of shape (1,).
    """
    time = int(time)
    over = torch.zeros((), dtype=torch.bool, device=d_ord.device)
    jcaps = (caps.join_out,) * caps.levels

    def track(flag):
        nonlocal over
        over = over | flag

    fo, _ = _ORD_MFP.apply(d_ord)
    fl, _ = _LI_MFP.apply(d_li)

    # probe/insert streams skip the compaction: dead rows stay inert and
    # these batches are never capacity-shrunk
    do_ck = arrange_batch(fo, (1,), compact=False)
    do_ok = arrange_batch(fo, (0,), compact=False)
    dl = arrange_batch(fl, (0,), compact=False)

    # intermediate join streams: concat the K per-level outputs, compact the
    # live rows into one small buffer, and only then sort
    mid_cap = bucket_cap(2 * caps.join_out)

    def squeeze(batches: list) -> UpdateBatch:
        packed, f = compact_to(_concat_all(batches), mid_cap)
        track(f)
        return packed

    outs = []
    if with_cust:
        fc, _ = _CUST_MFP.apply(d_cust)
        dc = arrange_batch(fc, (0,), compact=False)
        # path 0: d customer ⋈ orders(ck) ⋈ lineitem(ok)
        s0s, f = lsm_join(dc, state.ord_by_ck, jcaps)
        track(f)
        s0 = arrange_batch(squeeze(s0s), (1,), compact=False)  # key ok
        s0s, f = lsm_join(s0, state.li_by_ok, jcaps)
        track(f)
        outs += s0s  # (ck | ok,ck,od,sp | lk,ep,dc) = canonical
        new_cust, f = lsm_insert(state.cust_by_ck, dc, time, RATIO)
        track(f)
    else:
        new_cust = state.cust_by_ck

    # path 1: d orders ⋈ customer(ck) ⋈ lineitem(ok)
    s1s, f = lsm_join(do_ck, new_cust, jcaps)
    track(f)
    s1 = arrange_batch(squeeze(s1s), (0,), compact=False)  # key ok
    s1s, f = lsm_join(s1, state.li_by_ok, jcaps)
    track(f)
    outs += [_project_cols(s, (4, 0, 1, 2, 3, 5, 6, 7)) for s in s1s]
    new_ord_ck, f = lsm_insert(state.ord_by_ck, do_ck, time, RATIO)
    track(f)
    new_ord_ok, f = lsm_insert(state.ord_by_ok, do_ok, time, RATIO)
    track(f)

    # path 2: d lineitem ⋈ orders(ok) ⋈ customer(ck)
    s2s, f = lsm_join(dl, new_ord_ok, jcaps)
    track(f)
    s2 = arrange_batch(squeeze(s2s), (4,), compact=False)  # key ck
    s2s, f = lsm_join(s2, new_cust, jcaps)
    track(f)
    outs += [_project_cols(s, (7, 3, 4, 5, 6, 0, 1, 2)) for s in s2s]
    new_li, f = lsm_insert(state.li_by_ok, dl, time, RATIO)
    track(f)

    # closure + reduce (the closure is elementwise: run it on the compacted rows)
    joined, errs1 = _CLOSURE.apply(squeeze(outs))
    grouped = arrange_batch(joined, (0, 1, 2), compact=False)

    raw_contrib, errs2 = _contributions(grouped, (0, 1, 2), _AGGS)
    contrib = consolidate_accums(raw_contrib)
    old_accums, old_nrows, missed = accum_lsm_lookup(state.accum, contrib)
    errs3 = collision_errs(contrib, missed, time)
    emitted, f = compact_to(_emit_output(contrib, old_accums, old_nrows, time), mid_cap)
    track(f)
    out = consolidate(emitted, compact=False)
    new_accum, f = accum_lsm_insert(state.accum, contrib, time, RATIO)
    track(f)

    # error streams are almost always empty: compact before the sort; an
    # overflow of real error rows raises the tick's failure flag
    errs_cat, f = compact_to(UpdateBatch.concat(UpdateBatch.concat(errs1, errs2), errs3), 8192)
    track(f)
    errs = consolidate(errs_cat, compact=False)
    new_state = Q3State(new_cust, new_ord_ck, new_ord_ok, new_li, new_accum)
    return new_state, out, errs, over.reshape((1,))


def q3_tick_single(caps: Q3Caps, with_cust: bool = True):
    """Single-GPU tick: (state, d_cust, d_ord, d_li, t) -> (state', out, errs, overflow)."""
    return partial(q3_tick, caps=caps, with_cust=with_cust)


def hydrate(state: Q3State, init_cust, init_ord, init_li, time) -> Q3State:
    """Initial load: place filtered snapshots directly into the TOP level and
    compute the initial aggregates through one joined pass (host-driven,
    with host reads; not part of the tick)."""
    fc, _ = _CUST_MFP.apply(init_cust)
    fo, _ = _ORD_MFP.apply(init_ord)
    fl, _ = _LI_MFP.apply(init_li)

    def place(lsm: LsmBatches, keyed: UpdateBatch) -> LsmBatches:
        top = lsm.levels[-1]
        merged = merge_consolidate(top, keyed)
        if int(merged.count()) > top.cap:
            raise OverflowError("hydration exceeds top-level cap")
        return LsmBatches(tuple(lsm.levels[:-1]) + (merged.with_capacity(top.cap),))

    state = Q3State(
        cust_by_ck=place(state.cust_by_ck, arrange_batch(fc, (0,))),
        ord_by_ck=place(state.ord_by_ck, arrange_batch(fo, (1,))),
        ord_by_ok=place(state.ord_by_ok, arrange_batch(fo, (0,))),
        li_by_ok=place(state.li_by_ok, arrange_batch(fl, (0,))),
        accum=state.accum,
    )
    # stream lineitem through the now-full order and customer arrangements
    dl = arrange_batch(fl, (0,))
    s = join_against(dl, list(state.ord_by_ok.levels))
    if not s:
        return state
    s = arrange_batch(consolidate(_concat_all(s)), (4,))
    s2 = join_against(s, list(state.cust_by_ck.levels))
    if not s2:
        return state
    canonical = _project_cols(consolidate(_concat_all(s2)), (7, 3, 4, 5, 6, 0, 1, 2))
    joined, _errs = _CLOSURE.apply(canonical)
    grouped = arrange_batch(joined, (0, 1, 2))
    raw_contrib, _e = _contributions(grouped, (0, 1, 2), _AGGS)
    contrib = consolidate_accums(raw_contrib)
    top = state.accum.levels[-1]
    merged = consolidate_accums(AccumState.concat(top, contrib))
    if int(merged.count()) > top.cap:
        raise OverflowError("hydration exceeds accum cap")
    return Q3State(
        state.cust_by_ck,
        state.ord_by_ck,
        state.ord_by_ok,
        state.li_by_ok,
        LsmAccums(tuple(state.accum.levels[:-1]) + (merged.with_capacity(top.cap),)),
    )


def hydration_output(state: Q3State, time) -> UpdateBatch:
    """The initial contents of the view (all groups, diff +1) after hydrate."""
    top = state.accum.levels[-1]
    live = top.live
    t = device_time_scalar(time)
    return UpdateBatch(
        hashes=torch.where(live, top.hashes, PAD_HASH),
        keys=(),
        vals=tuple(top.keys) + tuple(top.accums),
        times=torch.where(live, t, torch.full_like(top.hashes, PAD_TIME)),
        diffs=live.to(DIFF_DTYPE),
    )


def read_view(state: Q3State) -> dict:
    """The maintained view on the host: {(orderkey, orderdate, shippriority):
    revenue} over every live group, summed across the accumulator levels."""
    levels = state.accum.levels
    table = levels[0]
    for lvl in levels[1:]:
        table = AccumState.concat(table, lvl)
    table = consolidate_accums(table)
    live = (table.live & (table.nrows > 0)).cpu().numpy()
    keys = [k.cpu().numpy()[live] for k in table.keys]
    rev = table.accums[0].cpu().numpy()[live]
    return {
        (int(a), int(b), int(c)): int(r)
        for a, b, c, r in zip(*keys, rev)
    }

