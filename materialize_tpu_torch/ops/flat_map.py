"""FlatMap: per-row table functions (generate_series) as sized two passes.

Counterpart of materialize_tpu/ops/flat_map.py. The fan-out has the sized
join's shape:

  count:        each row's series cardinality from its (lo, hi, step)
                expressions, and their running sum;
  materialize:  output slot j maps back to (input row, offset) by a `probe`
                search of the running sums (`search.searchsorted`); the
                series value is lo[row] + offset * step[row].

Rows with a NULL argument give no series rows; a zero step is a per-row
error (STEP_ZERO) in the error stream. The fused renderer gives the output a
static capacity and raises the overflow flag past it; the host renderer
sizes it by the count pass.
"""

from __future__ import annotations

import torch

from ..expr.scalar import EvalErr, _floordiv, eval_expr3
from ..repr.batch import PAD_TIME, UpdateBatch
from ..repr.hashing import PAD_HASH
from .consolidate import _masked
from .search import searchsorted


def _series_bounds(batch: UpdateBatch, exprs):
    """(lo, step, count [int64], err [int32]) per input row."""
    cols = list(batch.vals)
    n = batch.cap
    dev = batch.device
    lo, lnull, lerr = eval_expr3(exprs[0], cols, n, dev)
    hi, hnull, herr = eval_expr3(exprs[1], cols, n, dev)
    st, snull, serr = eval_expr3(exprs[2], cols, n, dev)
    lo, hi, st = lo.to(torch.int64), hi.to(torch.int64), st.to(torch.int64)
    null = lnull | hnull | snull
    err = torch.maximum(torch.maximum(lerr, herr), serr)
    err = torch.where(null, 0, err)
    step_zero = (st == 0) & ~null
    err = torch.where(step_zero, int(EvalErr.STEP_ZERO), err)
    safe = torch.where(st == 0, torch.ones_like(st), st)
    span_ok = ((st > 0) & (hi >= lo)) | ((st < 0) & (hi <= lo))
    count = torch.where(span_ok, _floordiv(hi - lo, safe) + 1, 0)
    ok = batch.live & ~null & (err == 0)
    count = torch.where(ok, count, 0)
    err = torch.where(batch.live, err, 0)
    return lo, st, count, err


def flat_map_total(batch: UpdateBatch, exprs) -> torch.Tensor:
    """Rows the series of `batch` make (a 0-d tensor; no host read)."""
    _lo, _st, count, _err = _series_bounds(batch, exprs)
    return count.sum()


def flat_map_materialize(batch: UpdateBatch, exprs, out_cap: int):
    """(out, errs, overflow): out rows are the input row ++ its series value;
    rows past `out_cap` are dropped with `overflow` (a bool tensor) raised."""
    lo, st, count, err = _series_bounds(batch, exprs)
    cum = torch.cumsum(count, 0)
    total = cum[-1]
    over = total > out_cap

    j = torch.arange(out_cap, dtype=torch.int64, device=cum.device)
    pi = searchsorted(cum, j, side="right").clamp(max=batch.cap - 1)
    # cum[pi - 1] at pi == 0 wraps to cum[-1] in the reference, then is masked
    prev = torch.where(pi > 0, cum[(pi - 1) % batch.cap], 0)
    off = j - prev
    value = lo[pi] + off * st[pi]
    valid = j < total

    out = UpdateBatch(
        hashes=torch.where(valid, 0, PAD_HASH),
        keys=(),
        vals=tuple(v[pi] for v in batch.vals) + (value,),
        times=_masked(valid, batch.times[pi], PAD_TIME),
        diffs=torch.where(valid, batch.diffs[pi], 0),
    )
    err_mask = err != 0
    errs = UpdateBatch(
        hashes=torch.where(err_mask, 0, PAD_HASH),
        keys=(),
        vals=(err.to(torch.int64),),
        times=_masked(err_mask, batch.times, PAD_TIME),
        diffs=torch.where(err_mask, batch.diffs, 0),
    )
    return out, errs, over
