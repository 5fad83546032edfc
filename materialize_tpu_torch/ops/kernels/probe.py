"""probe / probe2: batched fixed-depth binary search.

Counterparts of materialize_tpu/ops/kernels/probe.py. `probe` searches one
sorted int64 column (u32 hashes carried as int64, or the join's prefix sum
of match counts); `probe2` searches (hi, lo) pairs compared
lexicographically (the merge interleaves). Both return int64 insertion
points in [0, n].

On a CUDA tensor the wrapper launches `csrc/probe.cu` (one thread per query,
the same unrolled loop; see the note there for what bounds it). On the CPU
it runs the plain version below: the unrolled ceil(log2 n) + 1
compare/select steps of the JAX reference, step for step.
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
    """Insertion points of q[m] in the sorted a[n] (np.searchsorted semantics)."""
    code = _side_code(side)
    if not registry.on_cuda(a, q):
        return plain_searchsorted(a, q, side)
    registry.require(a, _I64, "probe: a")
    registry.require(q, _I64, "probe: q")
    n, m = int(a.shape[0]), int(q.shape[0])
    out = torch.empty((m,), dtype=torch.int64, device=q.device)
    if m == 0:
        return out
    if n == 0:
        return out.zero_()
    lib = registry.library("probe")
    registry.launch("probe", (a, q, side), (n, m))
    with registry.on_device(q.device) as stream:
        err = lib.mz_probe(registry.ptr(a), n, registry.ptr(q), m, code, registry.ptr(out),
                           stream)
    registry.check(err, "probe")
    return out


def probe2(a_hi, a_lo, q_hi, q_lo, side: str = "left") -> torch.Tensor:
    """Insertion points of (q_hi, q_lo) pairs in the pair-sorted (a_hi, a_lo)."""
    code = _side_code(side)
    if not registry.on_cuda(a_hi, a_lo, q_hi, q_lo):
        return plain_searchsorted2(a_hi, a_lo, q_hi, q_lo, side)
    for t, nm in ((a_hi, "a_hi"), (a_lo, "a_lo"), (q_hi, "q_hi"), (q_lo, "q_lo")):
        registry.require(t, _I64, f"probe2: {nm}")
    n, m = int(a_hi.shape[0]), int(q_hi.shape[0])
    if int(a_lo.shape[0]) != n or int(q_lo.shape[0]) != m:
        raise ValueError("probe2: hi and lo columns differ in length")
    out = torch.empty((m,), dtype=torch.int64, device=q_hi.device)
    if m == 0:
        return out
    if n == 0:
        return out.zero_()
    lib = registry.library("probe")
    registry.launch("probe2", (a_hi, a_lo, q_hi, q_lo, side), (n, m))
    with registry.on_device(q_hi.device) as stream:
        err = lib.mz_probe2(registry.ptr(a_hi), registry.ptr(a_lo), n, registry.ptr(q_hi),
                            registry.ptr(q_lo), m, code, registry.ptr(out), stream)
    registry.check(err, "probe2")
    return out

