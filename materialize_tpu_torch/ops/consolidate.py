"""Consolidation: sort updates and sum diffs of identical (key, val, time) rows.

Counterpart of materialize_tpu/ops/consolidate.py. `consolidate` orders a
batch by its (key hash, row hash, time) key, sums the diffs of equal-row
runs with the `run_sum` kernel and moves the live rows to the front;
`merge_consolidate` merges two batches already in canonical order in O(n)
through a `probe2` interleave, with no sort; `compact_to` squeezes the live
rows of a batch into a smaller capacity (`compact_where`: any rows, of a
batch or an accumulator table).
"""

from __future__ import annotations

from dataclasses import fields

import torch

from ..repr.batch import PAD_TIME, UpdateBatch, device_time_scalar
from ..repr.hashing import PAD_HASH, hash_columns, value_view
from .kernels import batch_permute, run_sum
from .search import searchsorted2, sort_perm


def row_equal_prev(cols) -> torch.Tensor:
    """eq[i] = all columns equal between row i and i-1 (eq[0] = False),
    compared through `value_view`."""
    eq = None
    for raw in cols:
        c = value_view(raw)
        e = c[1:] == c[:-1]
        eq = e if eq is None else (eq & e)
    return torch.cat([torch.zeros((1,), dtype=torch.bool, device=eq.device), eq])


def pack_sort_key(batch: UpdateBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """The canonical ordering key as a (key_hash, row_hash) pair; row_hash is
    a content hash of the val columns, so duplicate rows inside one key group
    land adjacent. PAD_HASH rows carry the maximal hi key and sort last."""
    if batch.vals:
        row_hash = hash_columns(batch.vals)
    else:
        row_hash = torch.zeros_like(batch.hashes)
    return batch.hashes, row_hash


def _inverse_perm(pos: torch.Tensor) -> torch.Tensor:
    """perm with perm[pos[i]] = i (the reference's `(pos * 0).at[pos].set(iota)`)."""
    perm = torch.empty_like(pos)
    perm[pos] = torch.arange(pos.shape[0], dtype=pos.dtype, device=pos.device)
    return perm


def _stable_partition_perm(live: torch.Tensor) -> torch.Tensor:
    """Permutation moving live rows to the front, stably, in O(n)."""
    li = live.to(torch.int64)
    front = torch.cumsum(li, 0) - 1
    total = front[-1] + 1
    back = total + torch.cumsum(1 - li, 0) - 1
    return _inverse_perm(torch.where(live, front, back))


def scatter_to(col: torch.Tensor, idx: torch.Tensor, cap: int, fill) -> torch.Tensor:
    """A (cap,) column of `fill` with col[i] written at idx[i]; idx == cap drops."""
    out = torch.full((cap + 1,), fill, dtype=col.dtype, device=col.device)
    out[idx] = col
    return out[:cap]


# the padding of a column, by its field name; every other column pads with 0
_FILLS = {"hashes": PAD_HASH, "times": PAD_TIME}


def compact_where(table, mask: torch.Tensor, cap: int, device=None):
    """O(n) compaction of the rows of `table` (an UpdateBatch or AccumState)
    where `mask` holds into a fresh one of capacity `cap`, on `device` (by
    default the table's own).

    Returns (table', overflow). Order among the kept rows is preserved; rows
    beyond `cap` are dropped with the overflow flag (a bool tensor) raised.
    """
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    over = pos[-1] + 1 > cap
    # dropped rows, and kept rows past `cap`, land in the dropped slot `cap`
    idx = torch.where(mask, pos, cap).clamp(max=cap)

    def take(name, c):
        out = scatter_to(c, idx, cap, _FILLS.get(name, 0))
        return out if device is None else out.to(device)

    parts = {}
    for f in fields(table):
        v = getattr(table, f.name)
        parts[f.name] = tuple(take(f.name, c) for c in v) if isinstance(v, tuple) \
            else take(f.name, v)
    return type(table)(**parts), over


def compact_to(batch: UpdateBatch, cap: int):
    """O(n) compaction of live rows into a fresh batch of capacity `cap`.

    Returns (batch', overflow), as `compact_where` with the live rows.
    """
    return compact_where(batch, batch.live, cap)


def _masked(live: torch.Tensor, col: torch.Tensor, fill) -> torch.Tensor:
    return torch.where(live, col, torch.full_like(col, fill))


def _consolidate_sorted(b: UpdateBatch, compact: bool) -> UpdateBatch:
    """Run-merge + mask tail of `consolidate` and `merge_consolidate`.

    Requires `b` ordered so equal (key, row, time) rows are adjacent."""
    same = row_equal_prev([b.hashes, *b.keys, *b.vals, b.times])
    run_start = ~same
    (diff_out,) = run_sum(run_start, (b.diffs,))

    live = run_start & (diff_out != 0) & (b.hashes != PAD_HASH)
    diffs = _masked(live, diff_out, 0)
    if not compact:
        return UpdateBatch(b.hashes, b.keys, b.vals, b.times, diffs)

    masked = UpdateBatch(
        _masked(live, b.hashes, PAD_HASH),
        tuple(_masked(live, k, 0) for k in b.keys),
        tuple(_masked(live, v, 0) for v in b.vals),
        _masked(live, b.times, PAD_TIME),
        diffs,
    )
    return batch_permute(masked, _stable_partition_perm(live))


def consolidate(batch: UpdateBatch, compact: bool = True) -> UpdateBatch:
    """Canonicalize a batch: hash-sorted, equal rows merged, no zero diffs.

    With ``compact=False`` annihilated rows keep their hash and time in place
    with diff 0: the output is still hash-sorted and probe-able, but dead
    rows occupy interior slots. Output has the same capacity.
    """
    k_hi, k_lo = pack_sort_key(batch)
    order = sort_perm((batch.times, k_lo, k_hi))
    return _consolidate_sorted(batch_permute(batch, order), compact)


def _merge_perm(ka_hi, ka_lo, kb_hi, kb_lo) -> torch.Tensor:
    """Gather permutation that interleaves two pair-sorted runs (a before b on ties)."""
    na, nb = int(ka_hi.shape[0]), int(kb_hi.shape[0])
    dev = ka_hi.device
    pa = torch.arange(na, dtype=torch.int64, device=dev) + searchsorted2(
        kb_hi, kb_lo, ka_hi, ka_lo, side="left"
    )
    pb = torch.arange(nb, dtype=torch.int64, device=dev) + searchsorted2(
        ka_hi, ka_lo, kb_hi, kb_lo, side="right"
    )
    return _inverse_perm(torch.cat([pa, pb]))


def merge_consolidate(a: UpdateBatch, b: UpdateBatch, since: int | None = None) -> UpdateBatch:
    """Merge two batches that are ALREADY in canonical order, in O(n).

    Output capacity = a.cap + b.cap, live rows compacted to the front. With
    `since`, times first advance to the compaction frontier.
    """
    ka_hi, ka_lo = pack_sort_key(a)
    kb_hi, kb_lo = pack_sort_key(b)
    cat = batch_permute(UpdateBatch.concat(a, b), _merge_perm(ka_hi, ka_lo, kb_hi, kb_lo))
    if since is not None:
        cat = advance_times(cat, since)
    return _consolidate_sorted(cat, compact=True)


def advance_times(batch: UpdateBatch, since: int) -> UpdateBatch:
    """Logical compaction: forward every live time to at least `since`."""
    since = device_time_scalar(since)
    is_pad = batch.times == PAD_TIME
    new_times = torch.where(is_pad, batch.times, batch.times.clamp(min=since))
    return UpdateBatch(batch.hashes, batch.keys, batch.vals, new_times, batch.diffs)
