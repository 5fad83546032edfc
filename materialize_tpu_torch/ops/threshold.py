"""Threshold and Distinct: per-row multiplicity maps.

Counterpart of materialize_tpu/ops/threshold.py. Both keep a per-row count
table (an AccumState with no accumulators) and emit, for every row a tick
touches, f(new count) - f(old count): Distinct with f(m) = [m > 0],
Threshold with f(m) = max(m, 0). The fused renderer applies `_multiplicity`
inside its tick; `threshold_step` is the host renderer's tick.
"""

from __future__ import annotations

import torch

from ..repr.batch import DIFF_DTYPE, PAD_TIME, UpdateBatch, device_time_scalar
from ..repr.hashing import PAD_HASH
from .consolidate import _masked, consolidate
from .reduce import AccumState, _contributions, collision_errs, consolidate_accums, lookup_accums


def _multiplicity(mode: str, counts: torch.Tensor) -> torch.Tensor:
    if mode == "distinct":
        return (counts > 0).to(DIFF_DTYPE)
    if mode == "threshold":
        return counts.clamp(min=0)
    raise ValueError(mode)


def threshold_step(state: AccumState, delta: UpdateBatch, mode: str, time: int):
    """One tick: (count table, delta, t) -> (table', out, errs), `out`'s
    diffs f(new count) - f(old count) for every touched row. The whole row
    is the key."""
    all_cols = tuple(range(len(delta.vals)))
    raw_contrib, _errs = _contributions(delta, all_cols, ())
    contrib = consolidate_accums(raw_contrib)
    _found, _accs, old_n, missed = lookup_accums(state, contrib)
    new_n = old_n + contrib.nrows
    out_d = _multiplicity(mode, new_n) - _multiplicity(mode, old_n)
    live = contrib.live & (out_d != 0)
    out = UpdateBatch(
        hashes=_masked(live, contrib.hashes, PAD_HASH),
        keys=(),
        vals=contrib.keys,  # the full row was the key
        times=torch.where(live, device_time_scalar(time), PAD_TIME),
        diffs=torch.where(live, out_d, 0),
    )
    new_state = consolidate_accums(AccumState.concat(state, contrib))
    return new_state, consolidate(out), collision_errs(contrib, missed, time)
