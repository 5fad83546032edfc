"""MFP then accumulable reduce (SUM/COUNT) in one step.

Counterpart of materialize_tpu/ops/fused_reduce.py: `SELECT keys, sum/count
FROM src WHERE ... GROUP BY keys` evaluates the filter and maps, builds the
contributions, consolidates them, looks them up in the state, emits the
self-correcting output and merges the state in one call. The JAX package
compiles it into one program; here it runs eagerly, and the host renderer
(dataflow/runtime.py FusedMfpReduceNode) keeps the state's capacity sticky
(grow-only, powers of two).
"""

from __future__ import annotations

from ..expr.linear import MapFilterProject
from ..repr.batch import UpdateBatch
from .consolidate import consolidate
from .reduce import AccumState, accumulable_step


def fused_mfp_reduce_step(state: AccumState, delta: UpdateBatch, time: int,
                          mfp: MapFilterProject, key_cols: tuple[int, ...], aggs: tuple):
    """(state, delta, t) -> (state', out, errs)."""
    oks, errs1 = (delta, None) if mfp.is_identity() else mfp.apply(delta)
    new_state, out, errs2 = accumulable_step(state, oks, key_cols, aggs, time)
    errs = errs2 if errs1 is None else consolidate(UpdateBatch.concat(errs1, errs2))
    return new_state, out, errs
