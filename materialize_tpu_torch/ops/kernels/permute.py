"""multi_take: one index vector over a whole payload, clip mode.

Counterpart of materialize_tpu/ops/kernels/permute.py. Gathers every column
at `idx`, clamping out-of-range indices into [0, n - 1] (jnp.take's
mode="clip"). On a CUDA tensor the wrapper groups the columns by element
width and launches `csrc/multi_take.cu` once per group of up to 16 columns:
a gather moves bits, so every dtype of one width (bool as a 1-byte integer,
as the reference moves it as int8) shares a launch. On the CPU it runs the
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
    if not registry.on_cuda(idx, *cols):
        return plain_multi_take(cols, idx)
    registry.require(idx, (torch.int64,), "multi_take: idx")
    n, m = int(cols[0].shape[0]), int(idx.shape[0])
    for c in cols:
        if c.dim() != 1 or not c.is_contiguous() or int(c.shape[0]) != n:
            raise ValueError("multi_take: columns must be contiguous 1-D and of one length")
    if n == 0:
        raise ValueError("multi_take: cannot gather from empty columns")
    out = [torch.empty((m,), dtype=c.dtype, device=c.device) for c in cols]
    if m == 0:
        return tuple(out)
    groups: dict[int, list[int]] = {}
    for i, c in enumerate(cols):
        groups.setdefault(c.element_size(), []).append(i)
    lib = registry.library("multi_take")
    max_k = lib.mz_take_max_cols()
    registry.launch("multi_take", (cols, idx), (len(cols), n, m))
    with registry.on_device(idx.device) as stream:
        for width, members in groups.items():
            for s in range(0, len(members), max_k):
                part = members[s : s + max_k]
                ins = (ctypes.c_void_p * len(part))(*(cols[i].data_ptr() for i in part))
                outs = (ctypes.c_void_p * len(part))(*(out[i].data_ptr() for i in part))
                err = lib.mz_multi_take(
                    ctypes.cast(ins, ctypes.c_void_p), ctypes.cast(outs, ctypes.c_void_p),
                    len(part), width, registry.ptr(idx), n, m, stream,
                )
                registry.check(err, "multi_take")
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
