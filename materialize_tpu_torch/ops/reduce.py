"""Accumulable reductions (SUM and COUNT) as segmented kernels.

Counterpart of materialize_tpu/ops/reduce.py. Per-key state is a sorted
table of accumulator vectors (`AccumState`); a tick's delta batch is
segment-summed into per-key contributions (`consolidate_accums`), looked up
against the table (`lookup_accums`) and emitted self-correctingly as
(-old aggregate, +new aggregate) per affected key (`_emit_output`).
Float sums accumulate in i64 fixed point (`AggregateExpr.fixed_scale`), so
every accumulator column, and `run_sum`, stays integer; the emitted column
descales to float32. `accumulable_step` is the host-driven tick of the
host renderer's ReduceNode.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..expr.scalar import EvalErr, Literal, eval_expr3
from ..repr.batch import DIFF_DTYPE, PAD_TIME, UpdateBatch, _ext, device_time_scalar
from ..repr.hashing import PAD_HASH, hash_columns, mix_columns, value_view
from .consolidate import _inverse_perm, _masked, _stable_partition_perm, row_equal_prev
from .kernels import multi_take, run_sum
from .search import searchsorted, searchsorted2, sort_perm

# Lookups scan 4 slots of a probe's hash bucket unconditionally and re-scan
# at 64 only when some probe's bucket is larger (probe widening).
_MAX_HASH_COLLISIONS = 4
_WIDE_HASH_COLLISIONS = 64

# Host reads, counted under a lock (mesh workers look up from their own
# threads): "lookup_widen", the one `lookup_accums` makes to decide the
# widening; "host_path", every count that the host renderer
# (dataflow/runtime.py) and its operators read to size a buffer or skip work.
HOST_SYNCS = {"lookup_widen": 0, "host_path": 0}
_SYNCS_LOCK = threading.Lock()


def host_int(t: torch.Tensor) -> int:
    """Read a 0-d device tensor on the host, counted in HOST_SYNCS["host_path"]."""
    with _SYNCS_LOCK:
        HOST_SYNCS["host_path"] += 1
    return int(t)


@dataclass
class AccumState:
    """Per-key accumulators: one row per live key, sorted by (hash, keys)."""

    hashes: torch.Tensor  # int64 [cap], u32 values, PAD_HASH = padding
    keys: tuple  # key columns [cap]
    accums: tuple  # one accumulator column per aggregate [cap]
    nrows: torch.Tensor  # int64 [cap], group size (sum of diffs)

    @property
    def cap(self) -> int:
        return int(self.hashes.shape[0])

    @property
    def live(self) -> torch.Tensor:
        return self.hashes != PAD_HASH

    def count(self) -> torch.Tensor:
        return self.live.sum()

    @staticmethod
    def empty(cap: int, key_dtypes, accum_dtypes, device="cuda") -> "AccumState":
        return AccumState(
            hashes=torch.full((cap,), PAD_HASH, dtype=torch.int64, device=device),
            keys=tuple(torch.zeros((cap,), dtype=dt, device=device) for dt in key_dtypes),
            accums=tuple(torch.zeros((cap,), dtype=dt, device=device) for dt in accum_dtypes),
            nrows=torch.zeros((cap,), dtype=DIFF_DTYPE, device=device),
        )

    @staticmethod
    def concat(a: "AccumState", b: "AccumState") -> "AccumState":
        return AccumState(
            torch.cat([a.hashes, b.hashes]),
            tuple(torch.cat([x, y]) for x, y in zip(a.keys, b.keys)),
            tuple(torch.cat([x, y]) for x, y in zip(a.accums, b.accums)),
            torch.cat([a.nrows, b.nrows]),
        )

    def with_capacity(self, cap: int) -> "AccumState":
        cur = self.cap
        if cap == cur:
            return self
        if cap < cur:
            return AccumState(
                self.hashes[:cap],
                tuple(k[:cap] for k in self.keys),
                tuple(a[:cap] for a in self.accums),
                self.nrows[:cap],
            )
        pad = cap - cur
        return AccumState(
            _ext(self.hashes, pad, PAD_HASH),
            tuple(_ext(k, pad, 0) for k in self.keys),
            tuple(_ext(a, pad, 0) for a in self.accums),
            _ext(self.nrows, pad, 0),
        )


@dataclass(frozen=True)
class AggregateExpr:
    """One aggregate: func in {sum, count}, over `expr`.

    `fixed_scale` > 0 marks a float sum accumulated in fixed point: each
    input is scaled by 2**fixed_scale, rounded (half to even) to the i64
    accumulator, and the emitted column descales back to float32. Insert
    and retract of one value quantize identically, so retractions cancel
    exactly. |sum * 2^fixed_scale| must fit i64; `accum_overflow_errs`
    flags totals past 2^60.
    """

    func: str
    expr: object
    accum_dtype: str = "int64"
    fixed_scale: int = 0


FLOAT_FIXED_SCALE = 24  # the reference's float accumulation quantum


def agg_out_dtype(a: AggregateExpr) -> np.dtype:
    """Output column dtype of one aggregate (the accumulator's, except
    fixed-point float sums, which descale to float32)."""
    return np.dtype(np.float32) if a.fixed_scale else np.dtype(a.accum_dtype)


def _accum_pack(s: AccumState) -> tuple[torch.Tensor, torch.Tensor]:
    """Ordering key of an accum table as a (key_hash, mix) pair."""
    if s.keys:
        return s.hashes, mix_columns(s.keys)
    return s.hashes, torch.zeros_like(s.hashes)


def _accum_take(s: AccumState, idx: torch.Tensor) -> AccumState:
    """Gather every AccumState column at `idx` through one multi_take."""
    nk = len(s.keys)
    g = multi_take((s.hashes, *s.keys, *s.accums, s.nrows), idx)
    return AccumState(g[0], tuple(g[1 : 1 + nk]), tuple(g[1 + nk : -1]), g[-1])


def _consolidate_accums_sorted(s: AccumState):
    """Run-merge + compaction over a packed-key-ordered table.

    Returns (state', dup): `dup` (a bool tensor) flags live same-key rows
    that survived unmerged (a packed-key double collision in the merge)."""
    run_start = ~row_equal_prev((s.hashes, *s.keys))
    summed = run_sum(run_start, (*s.accums, s.nrows))
    accums, nrows = summed[:-1], summed[-1]
    nonzero = nrows != 0
    for a in accums:
        nonzero = nonzero | (a != 0)
    live = run_start & nonzero & (s.hashes != PAD_HASH)
    masked = AccumState(
        _masked(live, s.hashes, PAD_HASH),
        tuple(_masked(live, k, 0) for k in s.keys),
        tuple(_masked(live, a, 0) for a in accums),
        _masked(live, nrows, 0),
    )
    out = _accum_take(masked, _stable_partition_perm(live))
    # unmerged duplicates sit within a few slots of each other
    dup = torch.zeros((), dtype=torch.bool, device=out.hashes.device)
    for d in (1, 2, 3):
        eq = (out.hashes[d:] == out.hashes[:-d]) & (out.hashes[d:] != PAD_HASH)
        for k in out.keys:
            kv = value_view(k)
            eq = eq & (kv[d:] == kv[:-d])
        dup = dup | eq.any()
    return out, dup


def consolidate_accums(s: AccumState) -> AccumState:
    """Order by (packed key, keys), sum accumulators of equal keys, drop
    empty groups."""
    p_hi, p_lo = _accum_pack(s)
    order = sort_perm((*reversed(s.keys), p_lo, p_hi))
    out, _dup = _consolidate_accums_sorted(_accum_take(s, order))
    return out


def merge_consolidate_accums(a: AccumState, b: AccumState):
    """O(n) merge of two consolidated accum tables by packed key.

    Returns (state', dup); see `_consolidate_accums_sorted`."""
    ka_hi, ka_lo = _accum_pack(a)
    kb_hi, kb_lo = _accum_pack(b)
    na, nb = a.cap, b.cap
    dev = a.hashes.device
    pa = torch.arange(na, dtype=torch.int64, device=dev) + searchsorted2(
        kb_hi, kb_lo, ka_hi, ka_lo, side="left"
    )
    pb = torch.arange(nb, dtype=torch.int64, device=dev) + searchsorted2(
        ka_hi, ka_lo, kb_hi, kb_lo, side="right"
    )
    perm = _inverse_perm(torch.cat([pa, pb]))
    return _consolidate_accums_sorted(_accum_take(AccumState.concat(a, b), perm))


_ACCUM_DTYPES = {"int64": torch.int64, "int32": torch.int32}


def _contributions(delta: UpdateBatch, key_cols: tuple[int, ...], aggs):
    """Per-row aggregate contributions of a raw delta batch (unconsolidated).

    Returns (AccumState, err_batch): rows whose aggregate input errors
    contribute nothing and go to the error batch."""
    cols = list(delta.vals)
    n = delta.cap
    dev = delta.device
    live = delta.live
    keys = tuple(delta.vals[i] for i in key_cols)
    if keys:
        hashes = torch.where(live, hash_columns(keys), PAD_HASH)
    else:
        hashes = torch.where(live, torch.zeros_like(delta.hashes), PAD_HASH)

    err = torch.zeros((n,), dtype=torch.int32, device=dev)
    accums = []
    for agg in aggs:
        dt = _ACCUM_DTYPES[agg.accum_dtype]
        if agg.func == "count":
            if isinstance(agg.expr, Literal) and agg.expr.value is not None:
                accums.append(delta.diffs.to(dt))  # count(*): every row counts
            else:
                # count(x): NULL inputs don't count
                _v, nv, ev = eval_expr3(agg.expr, cols, n)
                err = torch.maximum(err, ev)
                accums.append(torch.where(nv, 0, delta.diffs).to(dt))
        elif agg.func == "sum":
            v, nv, ev = eval_expr3(agg.expr, cols, n)
            err = torch.maximum(err, ev)
            if agg.fixed_scale:
                # float sum: quantize once per value; exact under retraction
                q = torch.round(v.to(torch.float32) * float(1 << agg.fixed_scale)).to(dt)
                contrib = q * delta.diffs.to(dt)
            else:
                contrib = v.to(dt) * delta.diffs.to(dt)
            # NULL inputs contribute nothing
            accums.append(torch.where(nv, torch.zeros_like(contrib), contrib))
        else:
            raise NotImplementedError(f"accumulable agg {agg.func}")
    err = torch.where(live, err, 0)
    ok = live & (err == 0)
    nrows = torch.where(ok, delta.diffs, 0)
    accums = tuple(torch.where(ok, a, torch.zeros_like(a)) for a in accums)
    hashes = torch.where(ok, hashes, PAD_HASH)
    err_mask = err != 0
    errs = UpdateBatch(
        hashes=torch.where(err_mask, torch.zeros_like(delta.hashes), PAD_HASH),
        keys=(),
        vals=(err.to(torch.int64),),
        times=_masked(err_mask, delta.times, PAD_TIME),
        diffs=_masked(err_mask, delta.diffs, 0),
    )
    return AccumState(hashes, keys, accums, nrows), errs


def _scan_bucket(state: AccumState, probe: AccumState, lo, hi, width: int):
    """Scan `width` slots of each probe's hash bucket for its keys."""
    found = torch.zeros_like(probe.live)
    idx = torch.zeros_like(lo)
    for off in range(width):
        cand = (lo + off).clamp(0, state.cap - 1)
        eq = (lo + off) < hi
        for pk, sk in zip(probe.keys, state.keys):
            eq = eq & (value_view(pk) == value_view(sk)[cand])
        eq = eq & probe.live
        idx = torch.where(eq & ~found, cand, idx)
        found = found | eq
    return found, idx


def lookup_accums(state: AccumState, probe: AccumState):
    """Gather state entries matching probe keys.

    Returns (found, accums tuple, nrows, missed) aligned with probe rows.
    Scans _MAX_HASH_COLLISIONS slots of each probe's hash bucket, and all
    _WIDE_HASH_COLLISIONS only when some bucket is larger and unresolved:
    that decision is one host read (counted in HOST_SYNCS). `missed` marks
    probes still unresolved; callers must surface an error for them.
    """
    lo = searchsorted(state.hashes, probe.hashes, side="left")
    hi = searchsorted(state.hashes, probe.hashes, side="right")
    found, idx = _scan_bucket(state, probe, lo, hi, _MAX_HASH_COLLISIONS)
    narrow_missed = (probe.live & ~found & ((hi - lo) > _MAX_HASH_COLLISIONS)).any()
    with _SYNCS_LOCK:
        HOST_SYNCS["lookup_widen"] += 1
    if narrow_missed.item():
        found, idx = _scan_bucket(state, probe, lo, hi, _WIDE_HASH_COLLISIONS)
    g = multi_take((*state.accums, state.nrows), idx)
    accums = tuple(torch.where(found, a, torch.zeros_like(a)) for a in g[:-1])
    nrows = torch.where(found, g[-1], 0)
    missed = probe.live & ~found & ((hi - lo) > _WIDE_HASH_COLLISIONS)
    return found, accums, nrows, missed


def _error_rows(mask: torch.Tensor, code: int, time: int) -> UpdateBatch:
    t = device_time_scalar(time)
    zeros = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    return UpdateBatch(
        hashes=torch.where(mask, zeros, PAD_HASH),
        keys=(),
        vals=(torch.where(mask, code, zeros),),
        times=torch.where(mask, t, zeros + PAD_TIME),
        diffs=mask.to(DIFF_DTYPE),
    )


def collision_errs(probe: AccumState, missed: torch.Tensor, time: int) -> UpdateBatch:
    """Error-collection rows for unresolved hash-bucket probes."""
    return _error_rows(missed, int(EvalErr.HASH_COLLISION_EXHAUSTED), time)


# fixed-point accumulators flag before i64 wraps: 2^60 leaves 8x headroom
# over any single further contribution
_ACCUM_OVERFLOW_BOUND = 1 << 60


def accum_overflow_errs(contrib: AccumState, old_accums, aggs: tuple, time: int):
    """Error rows for fixed-point accumulators near the i64 bound: the
    tick's contributions and the new totals (old + contribution) of affected
    keys. None, with no device work, when no aggregate is fixed-point."""
    scales = tuple(getattr(a, "fixed_scale", 0) for a in aggs)
    if not any(scales):
        return None
    over = torch.zeros_like(contrib.live)
    for c, o, s in zip(contrib.accums, old_accums, scales):
        if s:
            over = over | (c.abs() > _ACCUM_OVERFLOW_BOUND) | (
                (o + c).abs() > _ACCUM_OVERFLOW_BOUND)
    return _error_rows(over & contrib.live, int(EvalErr.NUMERIC_OVERFLOW), time)


def _emit_output(delta_keys: AccumState, old_accums, old_nrows, time: int,
                 aggs: tuple = ()) -> UpdateBatch:
    """Self-correcting output: -old aggregate row, +new aggregate row per key.

    Output rows are (key cols ++ one col per aggregate), diff ±1 at `time`,
    interleaved old/new per key. With `aggs`, fixed-point float
    accumulators descale to float32 output columns."""
    live = delta_keys.live
    new_accums = tuple(o + d for o, d in zip(old_accums, delta_keys.accums))
    new_nrows = old_nrows + delta_keys.nrows
    scales = tuple(a.fixed_scale for a in aggs) if aggs else (0,) * len(new_accums)

    def descale(a, s):
        return a.to(torch.float32) / float(1 << s) if s else a

    old_accums = tuple(descale(a, s) for a, s in zip(old_accums, scales))
    new_accums = tuple(descale(a, s) for a, s in zip(new_accums, scales))
    old_present = live & (old_nrows > 0)
    new_present = live & (new_nrows > 0)

    def interleave(a, b):
        return torch.stack([a, b], dim=1).reshape(-1)

    t = device_time_scalar(time)
    hashes = interleave(
        _masked(old_present, delta_keys.hashes, PAD_HASH),
        _masked(new_present, delta_keys.hashes, PAD_HASH),
    )
    vals = tuple(interleave(k, k) for k in delta_keys.keys) + tuple(
        interleave(o, n) for o, n in zip(old_accums, new_accums)
    )
    pad_t = torch.full_like(delta_keys.hashes, PAD_TIME)
    times = interleave(
        torch.where(old_present, t, pad_t), torch.where(new_present, t, pad_t)
    )
    diffs = interleave(-old_present.to(DIFF_DTYPE), new_present.to(DIFF_DTYPE))
    return UpdateBatch(hashes, (), vals, times, diffs)


def accumulable_step(state: AccumState, delta: UpdateBatch, key_cols: tuple[int, ...],
                     aggs: tuple, time: int):
    """One tick of an accumulable reduce: (state, delta, t) -> (state', out, errs).

    `out` is consolidated (unchanged -old/+new pairs cancel); rows whose
    aggregate input errors land in `errs`. The state's capacity grows as
    needed; callers rebucket.
    """
    from .consolidate import consolidate

    raw_contrib, errs = _contributions(delta, key_cols, aggs)
    contrib = consolidate_accums(raw_contrib)
    _found, old_accums, old_nrows, missed = lookup_accums(state, contrib)
    out = consolidate(_emit_output(contrib, old_accums, old_nrows, time, aggs))
    errs = consolidate(UpdateBatch.concat(errs, collision_errs(contrib, missed, time)))
    ov = accum_overflow_errs(contrib, old_accums, aggs, time)
    if ov is not None:
        errs = consolidate(UpdateBatch.concat(errs, ov))
    new_state = consolidate_accums(AccumState.concat(state, contrib))
    return new_state, out, errs
