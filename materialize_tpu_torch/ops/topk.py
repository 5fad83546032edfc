"""TopK: affected-group recompute by a segmented sort and a rank window.

Counterpart of materialize_tpu/ops/topk.py, the parts the fused renderer
runs. A tick gathers the full contents of every group its delta touches
(`distinct_keys`, then `_gather_materialize` against each arrangement
level), ranks each group's rows with one sort and windows them by
[offset, offset + limit) over a segmented running sum of multiplicities
(`topk_select`); the output is new top-k minus old top-k. `gather_groups`
and `topk_step` are the host renderer's tick, sized by one host read of
each level's match count.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..expr.scalar import derived_null
from ..repr.batch import DIFF_DTYPE, PAD_TIME, UpdateBatch, bucket_cap, device_time_scalar
from ..repr.hashing import PAD_HASH, value_view
from .consolidate import _masked, advance_times, consolidate, row_equal_prev
from .kernels import batch_permute, multi_take
from .search import searchsorted, sort_perm


@dataclass(frozen=True)
class TopKPlan:
    """Mirrors the reference's TopKPlan.

    order_by: tuple of (val column index, descending) pairs.
    limit None = no limit (offset only).
    nulls_last: per-order-column NULL placement; None = the pg default
    (NULLS LAST ascending, NULLS FIRST descending).
    """

    group_cols: tuple[int, ...]
    order_by: tuple[tuple[int, bool], ...]
    limit: int | None
    offset: int = 0
    nulls_last: tuple[bool, ...] | None = None


def distinct_keys(delta_keyed: UpdateBatch) -> UpdateBatch:
    """Distinct (hash, key) probes of a keyed batch: one live row per key,
    diff 1, no vals, live rows first."""
    b = delta_keyed
    order = sort_perm([*reversed(b.keys), b.hashes])
    g = multi_take((b.hashes, *b.keys, b.live), order)
    h, ks, live_in = g[0], tuple(g[1:-1]), g[-1]
    n = h.shape[0]
    same = row_equal_prev((h, *ks))
    # the first live row of each (hash, key) run survives; a run may mix
    # live and dead rows
    seg = torch.cumsum((~same).to(torch.int64), 0) - 1
    idx = torch.arange(n, dtype=torch.int64, device=h.device)
    first = torch.full((n,), n, dtype=torch.int64, device=h.device).scatter_reduce(
        0, seg, torch.where(live_in, idx, n), "amin")
    first_live = (first[seg] == idx) & live_in
    keys = tuple(_masked(first_live, k, 0) for k in ks)
    g = multi_take(
        (
            _masked(first_live, h, PAD_HASH),
            *keys,
            torch.where(first_live, 0, PAD_TIME),
            first_live.to(DIFF_DTYPE),
        ),
        sort_perm((~first_live,)),
    )
    return UpdateBatch(g[0], tuple(g[1:-2]), (), g[-2], g[-1])


def _gather_ranges(probes: UpdateBatch, arr: UpdateBatch):
    lo = searchsorted(arr.hashes, probes.hashes, side="left")
    hi = searchsorted(arr.hashes, probes.hashes, side="right")
    return lo, torch.where(probes.live, hi - lo, 0)


def _gather_materialize(probes: UpdateBatch, arr: UpdateBatch, out_cap: int) -> UpdateBatch:
    """All arrangement rows whose key matches a probe key (collision-checked),
    into a batch of capacity `out_cap`; matches past it are dropped."""
    lo, counts = _gather_ranges(probes, arr)
    return _gather_rows(probes, arr, lo, counts, out_cap)


def gather_with_total(probes: UpdateBatch, arr: UpdateBatch, out_cap: int):
    """(candidate matches, `_gather_materialize`) with one search of the
    ranges for both."""
    lo, counts = _gather_ranges(probes, arr)
    return counts.sum(), _gather_rows(probes, arr, lo, counts, out_cap)


def _gather_rows(probes: UpdateBatch, arr: UpdateBatch, lo, counts, out_cap: int):
    cum = torch.cumsum(counts, 0)
    total = cum[-1]
    j = torch.arange(out_cap, dtype=torch.int64, device=cum.device)
    pi = searchsorted(cum, j, side="right").clamp(max=probes.cap - 1)
    prev = torch.where(pi > 0, cum[(pi - 1) % probes.cap], 0)
    ai = (lo[pi] + (j - prev)).clamp(0, arr.cap - 1)
    valid = j < total
    a_row = batch_permute(arr, ai)
    p_keys = multi_take(probes.keys, pi) if probes.keys else ()
    eq = torch.ones((out_cap,), dtype=torch.bool, device=cum.device)
    for pk, ak in zip(p_keys, a_row.keys):
        eq = eq & (value_view(pk) == value_view(ak))
    ok = valid & eq & (a_row.diffs != 0)
    return UpdateBatch(
        hashes=_masked(ok, a_row.hashes, PAD_HASH),
        keys=tuple(_masked(ok, k, 0) for k in a_row.keys),
        vals=tuple(_masked(ok, v, 0) for v in a_row.vals),
        times=_masked(ok, a_row.times, PAD_TIME),
        diffs=_masked(ok, a_row.diffs, 0),
    )


def gather_groups(probes: UpdateBatch, batches: list, as_of: int,
                  val_dtypes=()) -> UpdateBatch:
    """Current contents (as of `as_of`) of every probed group, consolidated:
    each arrangement batch is searched once, its match count read on the
    host to size the gather."""
    from .reduce import host_int

    parts = []
    for arr in batches:
        lo, counts = _gather_ranges(probes, arr)
        total = host_int(counts.sum())
        if total:
            parts.append(_gather_rows(probes, arr, lo, counts, bucket_cap(total)))
    if not parts:
        return UpdateBatch.empty(8, tuple(k.dtype for k in probes.keys), val_dtypes,
                                 device=probes.device)
    acc = parts[0]
    for p in parts[1:]:
        acc = UpdateBatch.concat(acc, p)
    return consolidate(advance_times(acc, as_of))


def topk_step(arrangement, delta_keyed: UpdateBatch, plan: TopKPlan, time: int) -> UpdateBatch:
    """One tick of TopK: new top-k minus old top-k of the touched groups.

    `arrangement` is the input keyed by plan.group_cols, as `delta_keyed`
    is; this inserts the delta into it."""
    probes = distinct_keys(delta_keyed)
    vdt = tuple(v.dtype for v in delta_keyed.vals)
    old_rows = gather_groups(probes, arrangement.batches, time, vdt)
    arrangement.insert(delta_keyed, already_keyed=True)
    new_rows = gather_groups(probes, arrangement.batches, time, vdt)
    p = plan
    old_top = topk_select(old_rows, p.order_by, p.limit, p.offset, time, p.nulls_last)
    new_top = topk_select(new_rows, p.order_by, p.limit, p.offset, time, p.nulls_last)
    return consolidate(UpdateBatch.concat(new_top, negate(old_top)))


def topk_select(rows: UpdateBatch, order_by, limit, offset: int, time: int,
                nulls_last=None) -> UpdateBatch:
    """Window [offset, offset + limit) of each group's multiset, by order_by.

    rows: consolidated group contents (keys = group cols). A row with diff
    3 straddling the window keeps its in-window part. Ties in order_by go
    to the other val columns, ascending. `nulls_last` per order column;
    None = pg default (last ascending, first descending).
    """
    n = rows.cap
    d = rows.diffs.clamp(min=0) * rows.live  # negative multiplicities ignored
    if nulls_last is None:
        nulls_last = tuple(not desc for _c, desc in order_by)
    sort_cols: list = []
    used = [c for c, _ in order_by]
    for i in reversed(range(len(rows.vals))):
        if i not in used:
            sort_cols.append(_ord_view(rows.vals[i], False, True))
    for (c, desc), nl in zip(reversed(order_by), reversed(nulls_last)):
        sort_cols.append(_ord_view(rows.vals[c], desc, nl))
    sort_cols.extend(reversed(rows.keys))
    sort_cols.append(rows.hashes)
    order = sort_perm(sort_cols)
    b = batch_permute(rows, order)
    d = d[order]

    run_start = ~row_equal_prev((b.hashes, *b.keys))
    cum_excl = torch.cumsum(d, 0) - d
    idx = torch.arange(n, dtype=torch.int64, device=d.device)
    first_idx = torch.cummax(torch.where(run_start, idx, -1), 0).values
    cum_before = cum_excl - cum_excl[first_idx]

    lim = (1 << 62) if limit is None else limit
    hi_ = (cum_before + d).clamp(max=offset + lim)
    lo_ = cum_before.clamp(min=offset)
    out_d = (hi_ - lo_).clamp(min=0)
    ok = (out_d > 0) & b.live
    t = device_time_scalar(time)
    # raw output: the full row lives in vals; keys were only for grouping
    return UpdateBatch(
        hashes=_masked(ok, b.hashes, PAD_HASH),
        keys=(),
        vals=b.vals,
        times=torch.where(ok, t, PAD_TIME),
        diffs=torch.where(ok, out_d, 0),
    )


def _ord_view(col: torch.Tensor, desc: bool, nulls_last: bool) -> torch.Tensor:
    """Sortable view honoring direction and NULL placement.

    NULL sentinels (NaN, INT_MIN, -128) map to the view's extreme so they
    land where `nulls_last` says in either direction. A real value equal to
    the extreme ties with NULL in ordering only.
    """
    c = col.to(torch.int8) if col.dtype == torch.bool else col
    null = derived_null(c)
    if c.dtype.is_floating_point:
        view = -c if desc else c
        return torch.where(null, float("inf") if nulls_last else float("-inf"), view)
    # bitwise NOT reverses the order of two's-complement ints with no
    # INT_MIN overflow (~x = -x - 1)
    view = ~c if desc else c
    info = torch.iinfo(c.dtype)
    return torch.where(null, info.max if nulls_last else info.min, view)


def negate(b: UpdateBatch) -> UpdateBatch:
    return UpdateBatch(b.hashes, b.keys, b.vals, b.times, -b.diffs)
