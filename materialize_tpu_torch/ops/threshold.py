"""Threshold and Distinct: per-row multiplicity maps.

Counterpart of materialize_tpu/ops/threshold.py. Both keep a per-row count
table (an AccumState with no accumulators) and emit, for every row a tick
touches, f(new count) - f(old count): Distinct with f(m) = [m > 0],
Threshold with f(m) = max(m, 0). The fused renderer applies `_multiplicity`
inside its tick; the host-driven `threshold_step` comes with the host
runtime.
"""

from __future__ import annotations

import torch

from ..repr.batch import DIFF_DTYPE


def _multiplicity(mode: str, counts: torch.Tensor) -> torch.Tensor:
    if mode == "distinct":
        return (counts > 0).to(DIFF_DTYPE)
    if mode == "threshold":
        return counts.clamp(min=0)
    raise ValueError(mode)
