"""run_sum: collapse equal-row runs of a sorted batch in one pass.

Counterpart of materialize_tpu/ops/kernels/segsum.py. Given run-start flags
over a canonically ordered batch, produce per column
``out[i] = run_total if run_start[i] else 0``. Rows before the first run
start belong to no run.

On a CUDA tensor the wrapper launches `csrc/run_sum.cu` (a backward
segmented scan; see the note there) once per column. It takes int32 and
int64 columns, whose wrapping sums are exact in any order. A float column
on the card raises NotImplementedError: Q3 never sums floats, and float
sums on the card wait for the slice that brings float aggregates. On the
CPU the wrapper runs the plain version: the reference's segment-sum chain
(a cumsum of run starts, a scatter-add, a gather).
"""

from __future__ import annotations

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
    if not registry.on_cuda(run_start, *cols):
        return plain_run_sum(run_start, cols)
    registry.require(run_start, (torch.bool,), "run_sum: run_start")
    n = int(run_start.shape[0])
    for c in cols:
        if c.dtype.is_floating_point:
            raise NotImplementedError("run_sum on the card takes integer columns only")
        registry.require(c, _INT_COLS, "run_sum: column")
        if int(c.shape[0]) != n:
            raise ValueError("run_sum: columns must match run_start in length")
    out = tuple(torch.empty_like(c) for c in cols)
    if n == 0:
        return out
    lib = registry.library("run_sum")
    registry.launch("run_sum", (run_start, cols), (len(cols), n))
    with registry.on_device(run_start.device) as stream:
        for c, o in zip(cols, out):
            width = c.element_size()
            scratch = torch.empty((lib.mz_run_sum_scratch_bytes(n, width),), dtype=torch.uint8,
                                  device=c.device)
            err = lib.mz_run_sum(registry.ptr(run_start), registry.ptr(c), n, width,
                                 registry.ptr(o), registry.ptr(scratch), stream)
            registry.check(err, "run_sum")
    return out
