"""LSM arrangements: fixed-capacity levels with a deterministic merge schedule.

Counterpart of materialize_tpu/arrangement/lsm.py. K levels of consolidated
sorted batches (or accumulator tables), small to large; level i merges into
level i+1 whenever ``tick % ratio^(i+1) == 0``. The schedule depends only
on the tick, which is a Python int here, so the host decides each merge
with no device read. Overflow flags stay bool tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.consolidate import merge_consolidate
from ..ops.join import join_with_total
from ..ops.reduce import AccumState, lookup_accums, merge_consolidate_accums
from ..repr.batch import UpdateBatch


def _false(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=device)


@dataclass
class LsmBatches:
    """K levels of consolidated sorted batches, small -> large."""

    levels: tuple  # tuple[UpdateBatch]

    @staticmethod
    def empty(caps: tuple, key_dtypes, val_dtypes, device="cuda") -> "LsmBatches":
        return LsmBatches(
            tuple(UpdateBatch.empty(c, key_dtypes, val_dtypes, device) for c in caps)
        )


@dataclass
class LsmAccums:
    levels: tuple  # tuple[AccumState]

    @staticmethod
    def empty(caps: tuple, key_dtypes, accum_dtypes, device="cuda") -> "LsmAccums":
        return LsmAccums(
            tuple(AccumState.empty(c, key_dtypes, accum_dtypes, device) for c in caps)
        )


def _empty_batch_like(b: UpdateBatch) -> UpdateBatch:
    return UpdateBatch.empty(b.cap, [k.dtype for k in b.keys], [v.dtype for v in b.vals],
                             b.device)


def _empty_accum_like(s: AccumState) -> AccumState:
    return AccumState.empty(s.cap, [k.dtype for k in s.keys], [a.dtype for a in s.accums],
                            s.hashes.device)


def lsm_insert(lsm: LsmBatches, delta: UpdateBatch, tick: int, ratio: int = 4):
    """Insert a keyed, consolidated delta; run the tick's scheduled merges.

    Returns (lsm', overflow)."""
    levels = list(lsm.levels)
    overflow = _false(delta.device)
    # merges, deepest first (uses the pre-merge contents of lower levels)
    for i in range(len(levels) - 2, -1, -1):
        if int(tick) % ratio ** (i + 1) == 0:
            lo, hi = levels[i], levels[i + 1]
            merged = merge_consolidate(hi, lo)
            overflow = overflow | (merged.count() > hi.cap)
            levels[i], levels[i + 1] = _empty_batch_like(lo), merged.with_capacity(hi.cap)
    # delta lands in level 0 (delta is arranged = canonically sorted)
    l0 = merge_consolidate(levels[0], delta)
    overflow = overflow | (l0.count() > levels[0].cap)
    levels[0] = l0.with_capacity(levels[0].cap)
    return LsmBatches(tuple(levels)), overflow


def lsm_join(probe: UpdateBatch, lsm: LsmBatches, out_caps: tuple):
    """Join a probe batch against every level. Returns (outs list, overflow).

    Each level's match ranges are searched once, for its overflow total and
    its materialization (the reference's jit merges the two searches)."""
    outs = []
    overflow = _false(probe.device)
    for level, cap in zip(lsm.levels, out_caps):
        total, out = join_with_total(probe, level, cap)
        outs.append(out)
        overflow = overflow | (total > cap)
    return outs, overflow


def accum_lsm_lookup(lsm: LsmAccums, probe: AccumState):
    """Total accumulators for probe keys: the sum of per-level partials.

    Returns (accums, nrows, missed)."""
    tot_accums = tot_nrows = missed_any = None
    for level in lsm.levels:
        _f, accs, nrows, missed = lookup_accums(level, probe)
        if tot_accums is None:
            tot_accums, tot_nrows, missed_any = list(accs), nrows, missed
        else:
            tot_accums = [a + b for a, b in zip(tot_accums, accs)]
            tot_nrows = tot_nrows + nrows
            missed_any = missed_any | missed
    return tuple(tot_accums), tot_nrows, missed_any


def accum_lsm_insert(lsm: LsmAccums, contrib: AccumState, tick: int, ratio: int = 4):
    """Add consolidated per-key contributions; run scheduled merges."""
    levels = list(lsm.levels)
    overflow = _false(contrib.hashes.device)
    for i in range(len(levels) - 2, -1, -1):
        if int(tick) % ratio ** (i + 1) == 0:
            lo, hi = levels[i], levels[i + 1]
            merged, dup = merge_consolidate_accums(hi, lo)
            overflow = overflow | (merged.count() > hi.cap) | dup
            levels[i], levels[i + 1] = _empty_accum_like(lo), merged.with_capacity(hi.cap)
    l0, dup = merge_consolidate_accums(levels[0], contrib)
    overflow = overflow | (l0.count() > levels[0].cap) | dup
    levels[0] = l0.with_capacity(levels[0].cap)
    return LsmAccums(tuple(levels)), overflow
