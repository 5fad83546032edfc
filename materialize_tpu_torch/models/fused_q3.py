"""TPC-H Q3 incremental maintenance: one tick on one GPU, or mesh-sharded.

Counterpart of materialize_tpu/models/fused_q3.py (`q3_tick`,
`q3_tick_single`, `q3_tick_sharded`, `q3_state_global`, `hydrate`,
`hydration_output`). One tick runs three MFP filters, the three delta-join
paths through LSM-levelled arrangements, the revenue closure, the
accumulable SUM reduce and the LSM inserts and merges. Capacities are
static; overflow flags (bool tensors, read by the caller after the tick)
replace resizing. The tick's only host reads are the probe-widening
decisions of the accumulator lookups (ops/reduce.py, HOST_SYNCS).

On a worker mesh (parallel/mesh.py) every arrangement is hash-sharded by its
key over the workers, and every stream whose key changes is exchanged to
its key's owner (parallel/devicemesh/exchange.py) before it is joined,
inserted or reduced: eight exchanges a tick with the customer path, six
without.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
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
from ..ops.consolidate import compact_to, compact_where, consolidate, merge_consolidate
from ..ops.kernels import route_dest
from ..ops.join import join_against
from ..ops.reduce import (
    AccumState,
    AggregateExpr,
    _contributions,
    _emit_output,
    collision_errs,
    consolidate_accums,
)
from ..parallel.devicemesh.exchange import exchange, mesh_run
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
    """Static capacities (per worker on a mesh)."""

    cust: int = 1 << 14
    orders: int = 1 << 15
    lineitem: int = 1 << 16
    delta: int = 1 << 10  # per-tick delta rows per input (before the exchange)
    bucket: int = 1 << 9  # rows per destination of one exchange (mesh only)
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
    comm=None,
    with_cust: bool = True,
):
    """One Q3 maintenance tick. Returns (state', out_delta, errs, overflow).

    Raw deltas carry full table schemas. `time` (a Python int) doubles as
    the LSM merge schedule counter, so ticks should be consecutive integers.
    On a mesh, `comm` is this worker's `WorkerComm`, each worker feeds its own
    slice of the deltas and rows are routed by key hash to one of the
    `comm.size` workers; with `comm` None the tick runs alone. `with_cust=False` leaves the customer delta path
    out (TPC-H RF1/RF2 never touch customer). `overflow` is a bool tensor of
    shape (1,).
    """
    time = int(time)
    over = torch.zeros((), dtype=torch.bool, device=d_ord.device)
    jcaps = (caps.join_out,) * caps.levels

    def track(flag):
        nonlocal over
        over = over | flag

    def maybe_exchange(batch: UpdateBatch) -> UpdateBatch:
        """Route to the hash owner, then re-canonicalize (rows from n senders
        interleave). Off the mesh this is the identity: the input is already
        consolidated by arrange_batch."""
        if comm is None:
            return batch
        out, f = exchange(batch, comm, comm.size, caps.bucket)
        track(f)
        return consolidate(out, compact=False)

    fo, _ = _ORD_MFP.apply(d_ord)
    fl, _ = _LI_MFP.apply(d_li)

    # probe/insert streams skip the compaction: dead rows stay inert and
    # these batches are never capacity-shrunk
    do_ck = maybe_exchange(arrange_batch(fo, (1,), compact=False))
    do_ok = maybe_exchange(arrange_batch(fo, (0,), compact=False))
    dl = maybe_exchange(arrange_batch(fl, (0,), compact=False))

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
        dc = maybe_exchange(arrange_batch(fc, (0,), compact=False))
        # path 0: d customer ⋈ orders(ck) ⋈ lineitem(ok)
        s0s, f = lsm_join(dc, state.ord_by_ck, jcaps)
        track(f)
        s0 = maybe_exchange(arrange_batch(squeeze(s0s), (1,), compact=False))  # key ok
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
    s1 = maybe_exchange(arrange_batch(squeeze(s1s), (0,), compact=False))  # key ok
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
    s2 = maybe_exchange(arrange_batch(squeeze(s2s), (4,), compact=False))  # key ck
    s2s, f = lsm_join(s2, new_cust, jcaps)
    track(f)
    outs += [_project_cols(s, (7, 3, 4, 5, 6, 0, 1, 2)) for s in s2s]
    new_li, f = lsm_insert(state.li_by_ok, dl, time, RATIO)
    track(f)

    # closure + reduce (the closure is elementwise: run it on the compacted rows)
    joined, errs1 = _CLOSURE.apply(squeeze(outs))
    grouped = maybe_exchange(arrange_batch(joined, (0, 1, 2), compact=False))

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


def q3_tick_sharded(mesh: tuple, caps: Q3Caps, with_cust: bool = True):
    """Mesh-sharded tick over the workers of `mesh` (parallel/mesh.py).

    Returns step(states, d_custs, d_ords, d_lis, t) -> one (state', out,
    errs, overflow) per worker, where states and deltas hold one value per
    worker (`q3_state_global`, `split_batch`) and `caps` are per worker.
    """
    n = len(mesh)

    def tick(comm, state, d_cust, d_ord, d_li, time):
        return q3_tick(state, d_cust, d_ord, d_li, time, caps=caps, comm=comm,
                       with_cust=with_cust)

    def step(states, d_custs, d_ords, d_lis, time):
        return mesh_run(tick, mesh, states, d_custs, d_ords, d_lis, (int(time),) * n)

    return step


def q3_state_global(caps: Q3Caps, mesh: tuple) -> tuple:
    """The empty state of a mesh: one `Q3State` per worker at the per-worker
    `caps`, on its device (the JAX package's global state split on axis 0)."""
    return tuple(Q3State.empty(caps, device=d) for d in mesh)


def split_batch(batch: UpdateBatch, mesh: tuple) -> tuple:
    """A global batch cut into len(mesh) equal contiguous parts, one per
    worker, on its device (`shard_map`'s P(axis) split); the capacity is
    first padded to a multiple of the worker count."""
    n = len(mesh)
    b = batch.with_capacity(-(-batch.cap // n) * n)
    part = b.cap // n

    def cut(w, c):
        return c[w * part : (w + 1) * part].to(mesh[w])

    return tuple(
        UpdateBatch(cut(w, b.hashes), tuple(cut(w, k) for k in b.keys),
                    tuple(cut(w, v) for v in b.vals), cut(w, b.times), cut(w, b.diffs))
        for w in range(n)
    )


def shard_state(state: Q3State, caps: Q3Caps, mesh: tuple) -> tuple:
    """Partition a one-device state (`hydrate`'s) over the workers of `mesh`.

    Every live row of every LSM level and accumulator level goes to worker
    `route_dest(hash, n)`, the owner the exchange routes its key to, into
    the same level of an empty state at the per-worker `caps`. The filter is
    stable, so every part stays sorted and consolidated. Raises
    OverflowError when a worker's share exceeds its level's capacity.
    """
    n = len(mesh)
    shards = q3_state_global(caps, mesh)

    def split(lsm, empties: list) -> list:
        levels: list = [[] for _ in range(n)]
        for i, lvl in enumerate(lsm.levels):
            dest = route_dest(lvl.hashes, n)
            live = lvl.live
            for w in range(n):
                cap = empties[w].levels[i].cap
                part, over = compact_where(lvl, live & (dest == w), cap, mesh[w])
                if bool(over):
                    raise OverflowError(f"a worker's share exceeds its level capacity {cap}")
                levels[w].append(part)
        return [type(lsm)(tuple(ls)) for ls in levels]

    parts = {f.name: split(getattr(state, f.name), [getattr(s, f.name) for s in shards])
             for f in fields(Q3State)}
    return tuple(Q3State(**{k: v[w] for k, v in parts.items()}) for w in range(n))


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

