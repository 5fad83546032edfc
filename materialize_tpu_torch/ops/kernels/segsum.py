"""run_sum: collapse equal-row runs of a sorted batch in one pass.

Counterpart of materialize_tpu/ops/kernels/segsum.py. Given run-start flags
over a canonically ordered batch, produce per column
``out[i] = run_total if run_start[i] else 0``. Rows before the first run
start belong to no run.

On a CUDA tensor the wrapper launches `csrc/run_sum.cu` once for all the
call's columns: a single-pass backward segmented scan with decoupled
look-back (see the note there), which reads the flags once and every column
once. Its look-back state is scratch of the call: one allocation, zeroed by
one memset on the call's stream, so concurrent callers on other streams
never share it. It takes int32 and int64 columns, mixed, whose wrapping
sums are exact in any order. A float column on the card raises
NotImplementedError: Q3 never sums floats, and float sums on the card wait
for the slice that brings float aggregates. On the CPU the wrapper runs the
plain version: the reference's segment-sum chain (a cumsum of run starts, a
scatter-add, a gather).
"""

from __future__ import annotations

import ctypes

import torch

from . import registry

_INT_COLS = (torch.int32, torch.int64)


def plain_run_sum(run_start: torch.Tensor, cols: tuple) -> tuple:
    n = int(run_start.shape[0])
    seg = torch.cumsum(run_start.to(torch.int64), 0) - 1
    in_run = seg >= 0
    seg = seg.clamp(min=0)
    out = []
    for c in cols:
        sums = torch.zeros((n,), dtype=c.dtype, device=c.device)
        sums.index_add_(0, seg, torch.where(in_run, c, torch.zeros_like(c)))
        out.append(torch.where(run_start, sums[seg], torch.zeros_like(c)))
    return tuple(out)


def run_sum(run_start: torch.Tensor, cols: tuple) -> tuple:
    """Run totals at run-start rows, 0 elsewhere, for every column."""
    cols = tuple(cols)
    if not cols:
        return ()
    dev = registry.device_index(run_start, *cols)
    if dev < 0:
        return plain_run_sum(run_start, cols)
    registry.require(run_start, (torch.bool,), "run_sum: run_start")
    n = run_start.shape[0]
    for c in cols:
        if c.dtype.is_floating_point:
            raise NotImplementedError("run_sum on the card takes integer columns only")
        registry.require(c, _INT_COLS, "run_sum: column")
        if c.shape[0] != n:
            raise ValueError("run_sum: columns must match run_start in length")
    out = tuple(torch.empty_like(c) for c in cols)
    if n == 0:
        return out
    k = len(cols)
    scratch = run_start.new_empty(registry.c_fn("mz_run_sum_scratch_bytes")(n, k),
                                  dtype=torch.uint8)
    # the columns' pointers, their outputs' pointers, their widths: one array
    ptrs = (ctypes.c_int64 * (3 * k))(*[c.data_ptr() for c in cols],
                                      *[o.data_ptr() for o in out],
                                      *[c.element_size() for c in cols])
    registry.launch("run_sum", (run_start, cols), (k, n))
    registry.run("mz_run_sum", dev, run_start.data_ptr(), ptrs, k, n, scratch.data_ptr())
    return out
