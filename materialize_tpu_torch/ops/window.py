"""Window functions: affected-partition recompute, vectorized on the device.

Counterpart of materialize_tpu/ops/window.py. A tick gathers the full
contents of every partition its delta touches from the input arrangement
(`topk.gather_groups`), sorts them once with one segmented sort
(`search.sort_perm`, then `batch_permute`, which is `multi_take`), and
computes every window function with segmented prefix sums; the output is
new windows minus old windows.

Multiplicities: row_number, lag, lead and ntile give duplicate instances of
a row distinct values, so a consolidated row with diff d expands into d
instances through a `probe` search of the running multiplicities (the same
sized gather as group gathers). rank, dense_rank, first_value, last_value
and running aggregates are computed per consolidated row and broadcast to
its instances.

Frames follow PostgreSQL's defaults: with ORDER BY the frame is RANGE
BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW (running aggregates include
every peer of the current row); without ORDER BY every row of the partition
is a peer.

The reference's segmented running min/max is a `jax.lax.associative_scan`;
here it is a log-step (Hillis-Steele) scan of `torch.where` over shifted
copies, exact for min and max. `jax.lax.cummax` is `torch.cummax`, and
`jax.ops.segment_max` a `scatter_reduce`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..expr.scalar import derived_null, null_sentinel, torch_dtype
from ..repr.batch import DIFF_DTYPE, PAD_TIME, UpdateBatch, bucket_cap, device_time_scalar
from ..repr.hashing import PAD_HASH, value_view
from .consolidate import consolidate, row_equal_prev
from .kernels import batch_permute
from .search import searchsorted, sort_perm
from .topk import _ord_view, distinct_keys, gather_groups, negate


@dataclass(frozen=True)
class WindowFuncSpec:
    """One window function column.

    func: row_number | rank | dense_rank | ntile | lag | lead | first_value |
          last_value | sum | count | min | max
    arg: val-column index of the argument (None for row_number/rank/
         dense_rank/count(*); the ntile bucket count rides in `offset`).
    offset: lag/lead distance (default 1) or ntile bucket count.
    out_dtype: numpy dtype name of the output column.
    """

    func: str
    arg: int | None = None
    offset: int = 1
    out_dtype: str = "int64"


@dataclass(frozen=True)
class WindowPlan:
    partition_cols: tuple  # val-column indices
    order_by: tuple  # ((val col, desc), ...)
    funcs: tuple  # of WindowFuncSpec
    nulls_last: tuple | None = None  # per order column; None = pg default


def _as_int8(col: torch.Tensor) -> torch.Tensor:
    return col.to(torch.int8) if col.dtype == torch.bool else col


def _sentinel_like(col: torch.Tensor) -> torch.Tensor:
    return torch.full((), null_sentinel(col.dtype), dtype=col.dtype, device=col.device)


def _seg_scan_min(view: torch.Tensor, reset: torch.Tensor, take_max: bool) -> torch.Tensor:
    """Segmented running min (or max) of `view`, restarting where `reset`:
    a log-step inclusive scan, each step combining every row with the
    partial result `off` rows before it unless a reset lies between."""
    pick = torch.maximum if take_max else torch.minimum
    v, f = view, reset
    n = v.shape[0]
    off = 1
    while off < n:
        head_v, tail_v = v[:off], v[off:]
        tail = torch.where(f[off:], tail_v, pick(v[:-off], tail_v))
        v = torch.cat([head_v, tail])
        f = torch.cat([f[:off], f[off:] | f[:-off]])
        off *= 2
    return v


def _seg_max_at(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Each row's segment maximum of `vals` (segments `ids`, every id < n)."""
    n = vals.shape[0]
    init = torch.full((n,), torch.iinfo(vals.dtype).min, dtype=vals.dtype, device=vals.device)
    return init.scatter_reduce(0, ids, vals, "amax")[ids]


def window_compute(rows: UpdateBatch, plan: WindowPlan, time: int, out_cap: int) -> UpdateBatch:
    """All window outputs for the partitions present in `rows`.

    rows: consolidated partition contents (keys = partition cols, vals = the
    full row). Output: one instance per unit of multiplicity, vals = the row
    ++ one column per plan.funcs entry, every diff 1.
    """
    n = rows.cap
    dev = rows.device
    # -- one segmented sort of the consolidated rows ------------------------
    nl_tup = plan.nulls_last
    if nl_tup is None:
        nl_tup = tuple(not desc for _c, desc in plan.order_by)
    sort_cols: list = []
    used = [c for c, _ in plan.order_by]
    for i in reversed(range(len(rows.vals))):
        if i not in used:
            sort_cols.append(value_view(rows.vals[i]))
    for (c, desc), nl in zip(reversed(plan.order_by), reversed(nl_tup)):
        sort_cols.append(_ord_view(rows.vals[c], desc, nl))
    for k in reversed(rows.keys):
        sort_cols.append(value_view(k))
    sort_cols.append(rows.hashes)
    b = batch_permute(rows, sort_perm(sort_cols))
    d = b.diffs.clamp(min=0) * b.live

    idx = torch.arange(n, dtype=torch.int64, device=dev)
    part_start = ~row_equal_prev((b.hashes, *b.keys))
    if plan.order_by:
        peer_start = part_start | ~row_equal_prev(tuple(b.vals[c] for c, _ in plan.order_by))
    else:
        peer_start = part_start
    cum_incl = torch.cumsum(d, 0)
    total = cum_incl[-1]
    cum_before = cum_incl - d
    part_first = torch.cummax(torch.where(part_start, idx, -1), 0).values
    peer_first = torch.cummax(torch.where(peer_start, idx, -1), 0).values
    part_id = torch.cumsum(part_start.to(torch.int64), 0) - 1
    peer_id = torch.cumsum(peer_start.to(torch.int64), 0) - 1
    part_start_cnt = cum_before[part_first]
    peer_start_cnt = cum_before[peer_first]
    # instances through the end of the partition / the peer run
    part_end_cnt = _seg_max_at(cum_incl, part_id)
    peer_last_row = _seg_max_at(idx, peer_id)

    # -- expansion: one output instance per unit of multiplicity ------------
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    src = searchsorted(cum_incl, j, side="right").clamp(0, n - 1)
    valid = (j < total) & b.live[src]
    part_start_j = part_start_cnt[src]
    idx_in_part = j - part_start_j

    def frame_agg(spec: WindowFuncSpec):
        """Running aggregate over the default frame (through current peers)."""
        if spec.func == "count" and spec.arg is None:
            contrib = d
            nonnull = d
        else:
            col = _as_int8(b.vals[spec.arg])
            null = derived_null(col)
            nn = (~null).to(DIFF_DTYPE) * d
            nonnull = nn
            if spec.func == "count":
                contrib = nn
            elif spec.func == "sum":
                if col.dtype.is_floating_point:
                    contrib = torch.where(null, 0.0, col) * d.to(col.dtype)
                else:
                    contrib = torch.where(null, 0, col).to(torch.int64) * d
            else:  # min / max over the frame
                take_max = spec.func == "max"
                if col.dtype.is_floating_point:
                    ext = float("-inf") if take_max else float("inf")
                else:
                    info = torch.iinfo(col.dtype)
                    ext = info.min if take_max else info.max
                view = torch.where(null | (d == 0), ext, col)
                frame_val = _seg_scan_min(view, part_start, take_max)[peer_last_row]
                rc = torch.cumsum(nn, 0)
                frame_nn = rc[peer_last_row] - (rc[part_first] - nn[part_first])
                return torch.where(frame_nn > 0, frame_val, _sentinel_like(col))[src]
        r = torch.cumsum(contrib, 0)
        frame_sum = r[peer_last_row] - (r[part_first] - contrib[part_first])
        if spec.func == "count":
            return frame_sum[src]
        rc = torch.cumsum(nonnull, 0)
        frame_nn = rc[peer_last_row] - (rc[part_first] - nonnull[part_first])
        return torch.where(frame_nn > 0, frame_sum, _sentinel_like(frame_sum))[src]

    func_cols = []
    for spec in plan.funcs:
        if spec.func == "row_number":
            out = idx_in_part + 1
        elif spec.func == "rank":
            out = peer_start_cnt[src] - part_start_j + 1
        elif spec.func == "dense_rank":
            out = peer_id[src] - peer_id[part_first[src]] + 1
        elif spec.func == "ntile":
            nt = spec.offset
            size = part_end_cnt[src] - part_start_j
            small_sz = torch.div(size, nt, rounding_mode="floor")
            big = size - small_sz * nt  # parts with an extra row
            cut = big * (small_sz + 1)
            out = torch.where(
                idx_in_part < cut,
                torch.div(idx_in_part, (small_sz + 1).clamp(min=1), rounding_mode="floor"),
                big + torch.div(idx_in_part - cut, small_sz.clamp(min=1), rounding_mode="floor"),
            ) + 1
        elif spec.func in ("lag", "lead"):
            col = _as_int8(b.vals[spec.arg])
            if spec.func == "lag":
                t = j - spec.offset
                ok = t >= part_start_j
            else:
                t = j + spec.offset
                ok = t < part_end_cnt[src]
            src_t = src[t.clamp(0, out_cap - 1)]
            out = torch.where(ok, col[src_t], _sentinel_like(col))
        elif spec.func == "first_value":
            out = _as_int8(b.vals[spec.arg])[part_first[src]]
        elif spec.func == "last_value":
            out = _as_int8(b.vals[spec.arg])[peer_last_row[src]]
        elif spec.func in ("sum", "count", "min", "max"):
            out = frame_agg(spec)
        else:  # pragma: no cover
            raise NotImplementedError(spec.func)
        func_cols.append(out.to(torch_dtype(spec.out_dtype)))

    vals = tuple(torch.where(valid, v[src], torch.zeros_like(v[src])) for v in b.vals) + tuple(
        torch.where(valid, c, torch.zeros_like(c)) for c in func_cols
    )
    return UpdateBatch(
        hashes=torch.where(valid, b.hashes[src], PAD_HASH),
        keys=(),
        vals=vals,
        times=torch.where(valid, device_time_scalar(time), PAD_TIME),
        diffs=valid.to(DIFF_DTYPE),
    )


def _total_instances(rows: UpdateBatch) -> torch.Tensor:
    return (rows.diffs.clamp(min=0) * rows.live).sum()


def window_step(arrangement, delta_keyed: UpdateBatch, plan: WindowPlan, time: int):
    """One tick: new windows minus old windows of the affected partitions.

    `arrangement` is keyed by plan.partition_cols, as `delta_keyed` is; this
    inserts the delta into it. The two instance counts are read on the
    host, to size the expansions."""
    from .reduce import host_int

    probes = distinct_keys(delta_keyed)
    vdt = tuple(v.dtype for v in delta_keyed.vals)
    old_rows = gather_groups(probes, arrangement.batches, time, vdt)
    arrangement.insert(delta_keyed, already_keyed=True)
    new_rows = gather_groups(probes, arrangement.batches, time, vdt)
    old_n = host_int(_total_instances(old_rows))
    new_n = host_int(_total_instances(new_rows))
    old_out = window_compute(old_rows, plan, time, bucket_cap(max(old_n, 1)))
    new_out = window_compute(new_rows, plan, time, bucket_cap(max(new_n, 1)))
    return consolidate(UpdateBatch.concat(new_out, negate(old_out)))
