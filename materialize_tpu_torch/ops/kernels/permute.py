"""multi_take: one index vector over a whole payload, clip mode.

Counterpart of materialize_tpu/ops/kernels/permute.py. Gathers every column
at `idx`, clamping out-of-range indices into [0, n - 1] (jnp.take's
mode="clip"). On a CUDA tensor the wrapper groups the columns by element
width and calls `csrc/multi_take.cu` once per group, which launches once
per 16 columns: a gather moves bits, so every dtype of one width (bool as a
1-byte integer, as the reference moves it as int8) shares a launch. On the CPU it runs the
plain version: one clamped `index_select` per column.
"""

from __future__ import annotations

import ctypes

import torch

from . import registry


def plain_multi_take(cols: tuple, idx: torch.Tensor) -> tuple:
    if not cols:
        return ()
    n = int(cols[0].shape[0])
    if n == 0:
        raise ValueError("multi_take: cannot gather from empty columns")
    ix = idx.clamp(0, n - 1)
    return tuple(c.index_select(0, ix) for c in cols)


def multi_take(cols: tuple, idx: torch.Tensor) -> tuple:
    """Gather every column at `idx` (int64), clamped into range."""
    cols = tuple(cols)
    if not cols:
        return ()
    dev = registry.device_index(idx, *cols)
    if dev < 0:
        return plain_multi_take(cols, idx)
    registry.require(idx, (torch.int64,), "multi_take: idx")
    n, m = int(cols[0].shape[0]), int(idx.shape[0])
    for c in cols:
        if c.dim() != 1 or not c.is_contiguous() or int(c.shape[0]) != n:
            raise ValueError("multi_take: columns must be contiguous 1-D and of one length")
    if n == 0:
        raise ValueError("multi_take: cannot gather from empty columns")
    out = [c.new_empty(m) for c in cols]
    if m == 0:
        return tuple(out)
    groups: dict[int, list[int]] = {}
    for i, c in enumerate(cols):
        groups.setdefault(c.element_size(), []).append(i)
    registry.launch("multi_take", (cols, idx), (len(cols), n, m))
    for width, members in groups.items():
        ins = (ctypes.c_void_p * len(members))(*(cols[i].data_ptr() for i in members))
        outs = (ctypes.c_void_p * len(members))(*(out[i].data_ptr() for i in members))
        registry.run("mz_multi_take", dev, ins, outs, len(members), width, idx.data_ptr(), n, m)
    return tuple(out)


def batch_permute(batch, perm: torch.Tensor):
    """`UpdateBatch` rows at `perm`, through one fused multi-column gather."""
    from ...repr.batch import UpdateBatch

    nk, nv = len(batch.keys), len(batch.vals)
    cols = (batch.hashes, *batch.keys, *batch.vals, batch.times, batch.diffs)
    g = multi_take(cols, perm)
    return UpdateBatch(
        g[0], tuple(g[1 : 1 + nk]), tuple(g[1 + nk : 1 + nk + nv]), g[-2], g[-1]
    )
