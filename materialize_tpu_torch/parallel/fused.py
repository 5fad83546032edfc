"""Fixed-capacity operator steps: every capacity fixed up front, overflow
reported as a flag instead of a resize.

Counterpart of materialize_tpu/parallel/fused.py. The host renderer
(dataflow/runtime.py) sizes outputs from host-read counts; these steps keep
every shape static, as a tick over a mesh needs, and return an overflow
flag (a bool tensor) that the caller reacts to by rebuilding larger.
"""

from __future__ import annotations

from ..ops.consolidate import consolidate
from ..ops.join import join_with_total
from ..ops.reduce import (
    AccumState,
    _contributions,
    _emit_output,
    collision_errs,
    consolidate_accums,
    lookup_accums,
)
from ..repr.batch import UpdateBatch, device_time_scalar


def arrangement_insert(arr: UpdateBatch, delta: UpdateBatch):
    """Insert a (keyed, consolidated) delta into a fixed-capacity
    arrangement batch. Returns (arr', overflow): arr' keeps arr's capacity;
    overflow means live rows were dropped."""
    merged = consolidate(UpdateBatch.concat(arr, delta))
    return merged.with_capacity(arr.cap), merged.count() > arr.cap


def fused_accumulable_step(state: AccumState, delta: UpdateBatch, key_cols: tuple,
                           aggs: tuple, time):
    """`accumulable_step` with the state's capacity held fixed.

    Returns (state', out, errs, overflow)."""
    t = device_time_scalar(time)
    raw, errs = _contributions(delta, key_cols, aggs)
    contrib = consolidate_accums(raw)
    _found, old_accums, old_nrows, missed = lookup_accums(state, contrib)
    errs = consolidate(UpdateBatch.concat(errs, collision_errs(contrib, missed, t)))
    out = consolidate(_emit_output(contrib, old_accums, old_nrows, t))
    merged = consolidate_accums(AccumState.concat(state, contrib))
    return merged.with_capacity(state.cap), out, errs, merged.count() > state.cap


def fused_join_delta(probe: UpdateBatch, arr: UpdateBatch, out_cap: int, swap: bool = False):
    """A join with a static output capacity; returns (out, overflow)."""
    total, out = join_with_total(probe, arr, out_cap, swap)
    return out, total > out_cap
