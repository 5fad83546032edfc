"""Carrying state across between the JAX package and the port, as numpy.

The JAX package holds its state in pytrees (`UpdateBatch`, `AccumState`,
`LsmBatches`, `LsmAccums`, `Q3State`, and `FusedDataflow`'s state, a dict
{path: LsmBatches | LsmAccums} whose leaves come in the order of its keys
sorted as strings, so "x/10:..." before "x/2:..."). `to_numpy` lists a
port object's arrays in the JAX pytree leaf order, with hashes and times
narrowed back to u32 as the JAX package stores them; `from_numpy` rebuilds
a port object of the same structure as `template` from such a list (u32
columns widen to int64, every other column keeps its dtype). Neither
imports JAX: the caller flattens the JAX side itself
(`jax.tree_util.tree_leaves`).

A mesh-sharded JAX state is one global pytree whose every leaf is split on
axis 0 into equal parts, one per device; `split_leaves` cuts such leaves
into one list per worker, and `join_leaves` puts per-worker lists back.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from .arrangement.lsm import LsmAccums, LsmBatches
from .models.fused_q3 import Q3State
from .ops.reduce import AccumState
from .repr.batch import UpdateBatch


def _walk(obj) -> Iterator[tuple[torch.Tensor, bool]]:
    """(tensor, is_u32) for every array of `obj`, in JAX pytree leaf order."""
    if isinstance(obj, UpdateBatch):
        yield obj.hashes, True
        for c in (*obj.keys, *obj.vals):
            yield c, False
        yield obj.times, True
        yield obj.diffs, False
    elif isinstance(obj, AccumState):
        yield obj.hashes, True
        for c in (*obj.keys, *obj.accums, obj.nrows):
            yield c, False
    elif isinstance(obj, (LsmBatches, LsmAccums)):
        for lvl in obj.levels:
            yield from _walk(lvl)
    elif isinstance(obj, Q3State):
        for part in (obj.cust_by_ck, obj.ord_by_ck, obj.ord_by_ok, obj.li_by_ok, obj.accum):
            yield from _walk(part)
    elif isinstance(obj, dict):
        for key in sorted(obj):
            yield from _walk(obj[key])
    else:
        raise TypeError(f"not a port state object: {type(obj).__name__}")


def to_numpy(obj) -> list[np.ndarray]:
    """The arrays of a port object as numpy, in JAX pytree leaf order."""
    out = []
    for t, u32 in _walk(obj):
        a = t.detach().cpu().numpy()
        out.append(a.astype(np.uint32) if u32 else a)
    return out


def _rebuild(template, it: Iterator[torch.Tensor]):
    if isinstance(template, UpdateBatch):
        h = next(it)
        keys = tuple(next(it) for _ in template.keys)
        vals = tuple(next(it) for _ in template.vals)
        return UpdateBatch(h, keys, vals, next(it), next(it))
    if isinstance(template, AccumState):
        h = next(it)
        keys = tuple(next(it) for _ in template.keys)
        accums = tuple(next(it) for _ in template.accums)
        return AccumState(h, keys, accums, next(it))
    if isinstance(template, LsmBatches):
        return LsmBatches(tuple(_rebuild(lvl, it) for lvl in template.levels))
    if isinstance(template, LsmAccums):
        return LsmAccums(tuple(_rebuild(lvl, it) for lvl in template.levels))
    if isinstance(template, Q3State):
        return Q3State(*(
            _rebuild(p, it)
            for p in (template.cust_by_ck, template.ord_by_ck, template.ord_by_ok,
                      template.li_by_ok, template.accum)
        ))
    if isinstance(template, dict):
        return {key: _rebuild(template[key], it) for key in sorted(template)}
    raise TypeError(f"not a port state object: {type(template).__name__}")


def from_numpy(template, arrays, device="cuda"):
    """A port object shaped like `template`, holding `arrays` (JAX leaf order)."""
    specs = list(_walk(template))
    arrays = list(arrays)
    if len(arrays) != len(specs):
        raise ValueError(f"expected {len(specs)} arrays, got {len(arrays)}")
    tensors = []
    for a, (_t, u32) in zip(arrays, specs):
        a = np.asarray(a)
        if u32 != (a.dtype == np.uint32):
            raise TypeError(f"leaf dtype {a.dtype} does not match the port's layout")
        tensors.append(torch.tensor(a.astype(np.int64) if u32 else a, device=device))
    return _rebuild(template, iter(tensors))


def split_leaves(arrays, n: int) -> list[list[np.ndarray]]:
    """Global leaves sharded on axis 0 -> one list of leaves per worker."""
    out: list[list[np.ndarray]] = [[] for _ in range(n)]
    for a in arrays:
        a = np.asarray(a)
        if a.shape[0] % n:
            raise ValueError(f"a leaf of {a.shape[0]} rows does not split into {n} parts")
        for w, part in enumerate(np.split(a, n)):
            out[w].append(part)
    return out


def join_leaves(parts) -> list[np.ndarray]:
    """One list of leaves per worker -> the global leaves (axis 0)."""
    return [np.concatenate(ws) for ws in zip(*parts)]
