"""Batched incremental join: count pass, then materialize pass.

Counterpart of materialize_tpu/ops/join.py. A probe batch joins an
arrangement batch:

  count:       lo/hi = `probe` of probe hashes in the sorted arrangement
               hash column; match counts = hi - lo.
  materialize: output slot j maps back to (probe row, match offset) by a
               `probe` over the running count prefix sum; both sides are
               gathered with `multi_take`, true key equality is verified
               (hash collisions annihilate via diff 0), and the row is
               (vals_l ++ vals_r, max(t_l, t_r), d_l * d_r).
"""

from __future__ import annotations

import torch

from ..repr.batch import PAD_TIME, UpdateBatch, bucket_cap
from ..repr.hashing import PAD_HASH, value_view
from .kernels import multi_take
from .search import searchsorted


def _probe_ranges(probe: UpdateBatch, arr: UpdateBatch):
    lo = searchsorted(arr.hashes, probe.hashes, side="left")
    hi = searchsorted(arr.hashes, probe.hashes, side="right")
    counts = torch.where(probe.live, hi - lo, 0)
    return lo, counts


def join_total(probe: UpdateBatch, arr: UpdateBatch) -> torch.Tensor:
    """Number of candidate matches (a 0-d tensor; no host sync)."""
    _, counts = _probe_ranges(probe, arr)
    return counts.sum()


def join_materialize(
    probe: UpdateBatch, arr: UpdateBatch, out_cap: int, swap: bool = False
) -> UpdateBatch:
    """Materialize probe ⋈ arr into a raw batch of capacity `out_cap`.

    Output vals are probe.vals ++ arr.vals, or arr.vals ++ probe.vals when
    `swap`. Matches past out_cap are dropped (callers flag the overflow
    with `join_total`).
    """
    lo, counts = _probe_ranges(probe, arr)
    return _materialize_ranges(probe, arr, lo, counts, out_cap, swap)


def join_with_total(
    probe: UpdateBatch, arr: UpdateBatch, out_cap: int, swap: bool = False
) -> tuple:
    """(`join_total`, `join_materialize`) of one (probe, arr) pair, with the
    match ranges searched once for both."""
    lo, counts = _probe_ranges(probe, arr)
    return counts.sum(), _materialize_ranges(probe, arr, lo, counts, out_cap, swap)


def _materialize_ranges(probe: UpdateBatch, arr: UpdateBatch, lo, counts, out_cap: int,
                        swap: bool) -> UpdateBatch:
    cum = torch.cumsum(counts, 0)
    total = cum[-1]

    j = torch.arange(out_cap, dtype=torch.int64, device=cum.device)
    # probe row owning output slot j: first i with cum[i] > j
    pi = searchsorted(cum, j, side="right").clamp(max=probe.cap - 1)
    # cum[pi - 1] at pi == 0 wraps to cum[-1] in the reference, then is masked
    prev = torch.where(pi > 0, cum[(pi - 1) % probe.cap], 0)
    ai = (lo[pi] + (j - prev)).clamp(0, arr.cap - 1)
    valid = j < total

    nkp = len(probe.keys)
    p_g = multi_take((*probe.keys, *probe.vals, probe.hashes, probe.times, probe.diffs), pi)
    a_g = multi_take((*arr.keys, *arr.vals, arr.times, arr.diffs), ai)

    eq = torch.ones((out_cap,), dtype=torch.bool, device=cum.device)
    for pk, ak in zip(p_g[:nkp], a_g[: len(arr.keys)]):
        eq = eq & (value_view(pk) == value_view(ak))

    diffs = torch.where(valid & eq, p_g[-1] * a_g[-1], 0)
    times = torch.maximum(p_g[-2], a_g[-2])
    ok = valid & eq & (diffs != 0)
    left = tuple(p_g[nkp : nkp + len(probe.vals)])
    right = tuple(a_g[len(arr.keys) : len(arr.keys) + len(arr.vals)])
    vals = (right + left) if swap else (left + right)
    return UpdateBatch(
        hashes=torch.where(ok, p_g[-3], PAD_HASH),
        keys=(),
        vals=vals,
        times=torch.where(ok, times, PAD_TIME),
        diffs=diffs,
    )


def join_against(probe: UpdateBatch, batches: list) -> list:
    """Join a probe batch against every batch of an arrangement (host driver:
    one host read of each count). Returns the non-empty raw outputs."""
    outs = []
    for arr in batches:
        total = int(join_total(probe, arr))
        if total == 0:
            continue
        outs.append(join_materialize(probe, arr, bucket_cap(total)))
    return outs
