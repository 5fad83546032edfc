"""probe / probe2: batched fixed-depth binary search.

Counterparts of materialize_tpu/ops/kernels/probe.py. `probe` searches one
sorted int64 column (u32 hashes carried as int64, or the join's prefix sum
of match counts); `probe2` searches (hi, lo) pairs compared
lexicographically (the merge interleaves). Both return int64 insertion
points in [0, n].

On a CUDA tensor each wrapper launches one tile kernel of `csrc/probe.cu`,
templated over the key (one int64 column, or the pair): tiles of sorted
queries search the rows of `a` between their first and last query, staged
in shared memory when they fit, else through a staged sample of them that
narrows each query to a few cache lines; unsorted tiles run the reference's
loop (see the note there for what bounds it). On the CPU each runs the
plain version below: the unrolled ceil(log2 n) + 1 compare/select steps of
the JAX reference, step for step.
"""

from __future__ import annotations

import torch

from . import registry

_I64 = (torch.int64,)


def _pred(a_elem, q, side: str):
    return (a_elem < q) if side == "left" else (a_elem <= q)


def _pred2(a_hi, a_lo, q_hi, q_lo, side: str):
    if side == "left":
        return (a_hi < q_hi) | ((a_hi == q_hi) & (a_lo < q_lo))
    return (a_hi < q_hi) | ((a_hi == q_hi) & (a_lo <= q_lo))


def plain_searchsorted(a: torch.Tensor, q: torch.Tensor, side: str = "left") -> torch.Tensor:
    n = int(a.shape[0])
    pos = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    if n == 0:
        return pos
    cur = n
    while cur > 1:
        half = cur >> 1
        pos = torch.where(_pred(a[pos + (half - 1)], q, side), pos + half, pos)
        cur -= half
    return pos + _pred(a[pos], q, side).to(torch.int64)


def plain_searchsorted2(a_hi, a_lo, q_hi, q_lo, side: str = "left") -> torch.Tensor:
    n = int(a_hi.shape[0])
    pos = torch.zeros(q_hi.shape, dtype=torch.int64, device=q_hi.device)
    if n == 0:
        return pos
    cur = n
    while cur > 1:
        half = cur >> 1
        mid = pos + (half - 1)
        pos = torch.where(_pred2(a_hi[mid], a_lo[mid], q_hi, q_lo, side), pos + half, pos)
        cur -= half
    return pos + _pred2(a_hi[pos], a_lo[pos], q_hi, q_lo, side).to(torch.int64)


def _side_code(side: str) -> int:
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    return int(side == "right")


def probe(a: torch.Tensor, q: torch.Tensor, side: str = "left") -> torch.Tensor:
    """Insertion points of q[m] in the sorted a[n] (np.searchsorted semantics).

    The queries may come in any order; sorted ones, as every caller gives
    them, take the kernel's staged branches."""
    code = _side_code(side)
    dev = registry.device_index(a, q)
    if dev < 0:
        return plain_searchsorted(a, q, side)
    registry.require(a, _I64, "probe: a")
    registry.require(q, _I64, "probe: q")
    n, m = a.shape[0], q.shape[0]
    out = q.new_empty(m)
    if m == 0:
        return out
    if n == 0:
        return out.zero_()
    registry.launch("probe", (a, q, side), (n, m))
    registry.run("mz_probe", dev, a.data_ptr(), n, q.data_ptr(), m, code, out.data_ptr())
    return out


def probe2(a_hi, a_lo, q_hi, q_lo, side: str = "left") -> torch.Tensor:
    """Insertion points of (q_hi, q_lo) pairs in the pair-sorted (a_hi, a_lo).

    Precondition: `a` is sorted by (hi, lo), as the reference assumes. The
    queries may come in any order; sorted ones, as a merge gives them, take
    the kernel's fast branch."""
    code = _side_code(side)
    dev = registry.device_index(a_hi, a_lo, q_hi, q_lo)
    if dev < 0:
        return plain_searchsorted2(a_hi, a_lo, q_hi, q_lo, side)
    registry.require(a_hi, _I64, "probe2: a_hi")
    registry.require(a_lo, _I64, "probe2: a_lo")
    registry.require(q_hi, _I64, "probe2: q_hi")
    registry.require(q_lo, _I64, "probe2: q_lo")
    n, m = a_hi.shape[0], q_hi.shape[0]
    if a_lo.shape[0] != n or q_lo.shape[0] != m:
        raise ValueError("probe2: hi and lo columns differ in length")
    out = q_hi.new_empty(m)
    if m == 0:
        return out
    if n == 0:
        return out.zero_()
    registry.launch("probe2", (a_hi, a_lo, q_hi, q_lo, side), (n, m))
    registry.run("mz_probe2", dev, a_hi.data_ptr(), a_lo.data_ptr(), n, q_hi.data_ptr(),
                 q_lo.data_ptr(), m, code, out.data_ptr())
    return out

