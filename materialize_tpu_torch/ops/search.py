"""Branchless searches and the stable multi-key sort permutation.

Counterpart of materialize_tpu/ops/search.py. `searchsorted` and
`searchsorted2` are the `probe` / `probe2` kernels (ops/kernels/probe.py).
"""

from __future__ import annotations

import torch

from .kernels.probe import probe, probe2


def searchsorted(a: torch.Tensor, q: torch.Tensor, side: str = "left") -> torch.Tensor:
    """np.searchsorted over a sorted int64 array: int64 insertion points in [0, n]."""
    return probe(a, q, side)


def searchsorted2(a_hi, a_lo, q_hi, q_lo, side: str = "left") -> torch.Tensor:
    """Two-key searchsorted: `a` sorted by (hi, lo) pairs."""
    return probe2(a_hi, a_lo, q_hi, q_lo, side)


def sort_perm(cols) -> torch.Tensor:
    """`np.lexsort(cols)`: the int64 permutation that stably sorts by
    (cols[-1], ..., cols[0]), the last column primary.

    torch has no lexsort, so this chains stable sorts from the least
    significant key to the most significant. A stable sort with a fixed key
    order is deterministic: the permutation equals the reference's
    `lax.sort` with an iota payload exactly.
    """
    cols = [c.to(torch.int8) if c.dtype == torch.bool else c for c in cols]
    perm = torch.arange(cols[0].shape[0], dtype=torch.int64, device=cols[0].device)
    for c in cols:
        _, order = torch.sort(c[perm], stable=True)
        perm = perm[order]
    return perm
