"""Fused renderer: a supported LIR plan -> one tick of tensor operations.

Counterpart of materialize_tpu/dataflow/fused.py. `FusedCompiler` walks a
`DataflowDescription` once, allocates every stateful operator's
fixed-capacity state (LSM levels of batches or accumulator tables) under a
stable path, and emits the tick

    tick(state, source_deltas, time, since) -> (state', outs, errs, overflow)

operator by operator. The JAX package traces that emission into one jitted
program; here it runs eagerly, on the device of the dataflow, launching the
hand-written kernels (`probe`, `probe2`, `multi_take`, `run_sum`) through
the operators. Every operator returns new tensors and never writes into
one of `state`, so the pre-tick state survives the tick. Overflow flags and
output counts stay device tensors until the tick ends, when one stacked
read carries them to the host: the retry decision and the per-object
counts.

All state is fixed-capacity; overflow flags replace resizing. The host
driver (`FusedDataflow`) retries a tick from the pre-tick state with
doubled capacities when a flag trips, so results are never lossy.
Constructs the fused path does not render (LetRec, TemporalFilter,
BasicAgg, a FlatMap other than generate_series, any string function) raise
`FusedUnsupported`; `render_dataflow` (runtime.py) then takes the host
renderer.

With a mesh (parallel/mesh.py) the tick runs on every worker of it at once
(`mesh_tick`), each over its own hash shard of every state, and every batch
headed for stateful-operator state is first exchanged to the worker owning
its key hash (`_exchanged`): the SQL engine's multi-worker mode, where the
JAX package runs the same emission under `shard_map`.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..arrangement.lsm import (
    LsmAccums,
    LsmBatches,
    accum_lsm_insert,
    accum_lsm_lookup,
    lsm_insert,
    lsm_join,
)
from ..arrangement.spine import Arrangement, arrange_batch
from ..obs import profiler as _prof
from ..ops.consolidate import _masked, advance_times, compact_to, consolidate
from ..ops.join import join_with_total
from ..ops.reduce import (
    _contributions,
    _emit_output,
    accum_overflow_errs,
    agg_out_dtype,
    collision_errs,
    consolidate_accums,
)
from ..ops.threshold import _multiplicity
from ..ops.topk import distinct_keys, gather_with_total, negate, topk_select
from ..parallel.devicemesh.exchange import exchange, mesh_tick, note_overflow_retry
from ..repr.batch import PAD_TIME, UpdateBatch, bucket_cap, device_time_scalar
from ..repr.hashing import PAD_HASH
from . import plan as lir
from .runtime import (
    ERR_DTYPES,
    _expr_dtype,
    accum_state_nbytes,
    arrangement_nbytes,
    batch_nbytes,
    materialize_counts,
    peek_error_message,
    torch_dtypes,
)

# error-stream compaction buffer: errors are almost always empty, so the
# concatenated per-operator error streams compact here before their
# canonicalizing sort (an overflow of real error rows trips the retry)
_ERR_COMPACT_CAP = 8192


class FusedUnsupported(Exception):
    """Plan uses a construct the fused renderer does not render."""


@dataclass(frozen=True)
class FusedCaps:
    """Static capacities for one dataflow (all powers of two).

    `scaled(k)` multiplies every capacity at once: the overflow-retry knob.
    On a mesh these are per-worker capacities; `bucket` is the exchange's
    per-destination bucket (0: equal to `delta`, which no send of one
    worker's delta can overflow).
    """

    delta: int = 1 << 10  # per-source per-tick delta rows
    arrangement: int = 1 << 14  # top LSM level per join/topk arrangement
    groups: int = 1 << 13  # top accumulator-table level per reduce
    join_out: int = 1 << 12  # join output cap (largest level; see join_caps)
    gather: int = 1 << 12  # topk gathered group contents per level
    bucket: int = 0  # exchange bucket per destination (0 = delta)
    levels: int = 3
    ratio: int = 8  # LSM merge-schedule ratio
    cap_ratio: int = 4  # per-level join-output taper

    def scaled(self, k: int) -> "FusedCaps":
        return FusedCaps(
            delta=self.delta * k,
            arrangement=self.arrangement * k,
            groups=self.groups * k,
            join_out=self.join_out * k,
            gather=self.gather * k,
            bucket=self.bucket * k,
            levels=self.levels,
            ratio=self.ratio,
            cap_ratio=self.cap_ratio,
        )

    def arr_levels(self, full: int) -> tuple:
        from ..models.fused_q3 import level_caps

        return level_caps(full, max(self.delta, 64), self.levels, ratio=self.ratio)

    def join_caps(self, probe_cap: int, arr_caps) -> tuple:
        """Per-level join output caps, small level to large: level i gets
        join_out / cap_ratio^(levels-1-i), floored at the probe width and
        capped by the pair bound probe_cap * level cap where that is
        tighter. A level whose matches exceed its cap trips the retry."""
        if hasattr(arr_caps, "levels"):
            arr_caps = tuple(b.cap for b in arr_caps.levels)
        n = len(arr_caps)
        ratio = max(int(self.cap_ratio), 1)
        out = []
        for i, c in enumerate(arr_caps):
            cap = max(self.join_out // (ratio ** (n - 1 - i)), bucket_cap(probe_cap))
            cap = min(cap, self.join_out, bucket_cap(probe_cap * c))
            out.append(max(cap, 8))
        return tuple(out)


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------


@dataclass
class _Ctx:
    """Per-tick context threaded through the emission."""

    state_in: dict
    state_out: dict
    env: dict  # source/object id -> UpdateBatch delta
    time: int  # device time of the tick
    since: int  # device time of the compaction frontier
    errs: list
    overflow: list  # bool tensors
    memo: dict  # id(plan node) -> emitted UpdateBatch
    comm: object = None  # the worker's WorkerComm on a mesh


class FusedCompiler:
    """Walks LIR plans; builds the state template and emits the tick.

    With `axis_name` set (a tick over a mesh of `n_shards` workers), every
    batch headed for stateful-operator state is first exchanged to the
    worker owning its key hash: exchange before the state is touched, never
    after stateless MFPs."""

    def __init__(self, desc: lir.DataflowDescription, caps: FusedCaps, device="cuda",
                 axis_name: str | None = None, n_shards: int = 1):
        self.desc = desc
        self.caps = caps
        self.device = device
        self.axis_name = axis_name
        self.n_shards = n_shards
        self.dtypes: dict[str, tuple] = {
            sid: tuple(dts) for sid, dts in desc.source_imports.items()
        }
        # state templates keyed by stable path id, built during a dry walk
        self.state_template: dict[str, object] = {}
        self._counter = 0
        self._emitters: dict = {}  # id(node) -> (kind, state paths)
        for bd in desc.objects_to_build:
            self._check_supported(bd.plan)
            self.dtypes[bd.id] = tuple(bd.dtypes)
        self._alloc_memo: set[int] = set()
        for bd in desc.objects_to_build:
            self._allocate(bd.plan, bd.id)

    # -- support check ------------------------------------------------------
    def _check_supported(self, e) -> None:
        if isinstance(e, (lir.LetRec, lir.TemporalFilter, lir.BasicAgg)):
            raise FusedUnsupported(type(e).__name__)
        from ..expr.scalar import expr_has_dictfunc

        if isinstance(e, lir.FlatMap) and (
            e.func != "generate_series" or any(expr_has_dictfunc(x) for x in e.exprs)
        ):
            raise FusedUnsupported("FlatMap")

        def no_dictfunc(exprs):
            # string-function tables are host state: host path only
            if any(expr_has_dictfunc(x) for x in exprs):
                raise FusedUnsupported("DictFunc")

        if isinstance(e, lir.Mfp):
            no_dictfunc(list(e.mfp.map_exprs) + list(e.mfp.predicates))
        if isinstance(e, lir.Join) and e.closure is not None:
            no_dictfunc(list(e.closure.map_exprs) + list(e.closure.predicates))
        if isinstance(e, lir.Reduce) and not e.distinct:
            no_dictfunc([a.expr for a in e.aggs])
        for child in _children(e):
            self._check_supported(child)

    # -- dtype inference ----------------------------------------------------
    def infer_dtypes(self, e) -> tuple:
        if isinstance(e, lir.Get):
            return self.dtypes[e.id]
        if isinstance(e, lir.Constant):
            return tuple(e.dtypes)
        if isinstance(e, lir.Mfp):
            cols = list(self.infer_dtypes(e.input))
            for m in e.mfp.map_exprs:
                cols.append(_expr_dtype(m, cols))
            if e.mfp.projection is not None:
                cols = [cols[i] for i in e.mfp.projection]
            return tuple(cols)
        if isinstance(e, (lir.Negate, lir.Threshold, lir.ArrangeBy, lir.TopK)):
            return self.infer_dtypes(e.input)
        if isinstance(e, lir.FlatMap):
            return self.infer_dtypes(e.input) + (np.dtype(np.int64),)
        if isinstance(e, lir.Union):
            return self.infer_dtypes(e.inputs[0])
        if isinstance(e, lir.Reduce):
            ins = self.infer_dtypes(e.input)
            keys = tuple(ins[i] for i in e.key_cols)
            if e.distinct:
                return keys
            return keys + tuple(agg_out_dtype(a) for a in e.aggs)
        if isinstance(e, lir.Join):
            cols = []
            for i in e.inputs:
                cols.extend(self.infer_dtypes(i))
            if e.closure is not None and e.closure.projection is not None:
                base = list(cols)
                for m in e.closure.map_exprs:
                    base.append(_expr_dtype(m, base))
                cols = [base[i] for i in e.closure.projection]
            return tuple(cols)
        raise FusedUnsupported(f"dtypes: {type(e).__name__}")

    # -- state allocation ---------------------------------------------------
    def _path(self, obj_id: str, kind: str) -> str:
        self._counter += 1
        return f"{obj_id}/{self._counter}:{kind}"

    def _batches(self, full: int, key_dts, val_dts) -> LsmBatches:
        return LsmBatches.empty(self.caps.arr_levels(full), torch_dtypes(key_dts),
                                torch_dtypes(val_dts), self.device)

    def _accums(self, key_dts, accum_dts) -> LsmAccums:
        return LsmAccums.empty(self.caps.arr_levels(self.caps.groups), torch_dtypes(key_dts),
                               torch_dtypes(accum_dts), self.device)

    def _allocate(self, e, obj_id: str) -> None:
        """Pre-build the state template of every stateful operator, in the
        traversal order `_emit` uses (shared subtrees allocate once)."""
        if id(e) in self._alloc_memo:
            return
        self._alloc_memo.add(id(e))
        for child in _children(e):
            self._allocate(child, obj_id)
        arr = self.caps.arrangement
        if isinstance(e, lir.Join):
            in_dts = [self.infer_dtypes(i) for i in e.inputs]
            if isinstance(e.plan, lir.LinearJoinPlan):
                slots = []
                for si, st in enumerate(e.plan.stages):
                    left_dts = _accum_dtypes_linear(in_dts, si)
                    lkd = tuple(left_dts[c] for c in st.stream_key)
                    rkd = tuple(in_dts[si + 1][c] for c in st.lookup_key)
                    lpath = self._path(obj_id, f"join{si}L")
                    rpath = self._path(obj_id, f"join{si}R")
                    self.state_template[lpath] = self._batches(arr, lkd, left_dts)
                    self.state_template[rpath] = self._batches(arr, rkd, in_dts[si + 1])
                    slots.append((lpath, rpath))
                self._emitters[id(e)] = ("linear_join", slots)
            else:
                arrs: dict = {}
                for path in e.plan.paths:
                    for st in path:
                        key = (st.other_input, st.lookup_key)
                        if key not in arrs:
                            dts = in_dts[st.other_input]
                            p = self._path(obj_id, f"delta_in{st.other_input}")
                            self.state_template[p] = self._batches(
                                arr, tuple(dts[c] for c in st.lookup_key), dts)
                            arrs[key] = p
                self._emitters[id(e)] = ("delta_join", arrs)
        elif isinstance(e, lir.Reduce):
            in_dts = self.infer_dtypes(e.input)
            kd = tuple(in_dts[i] for i in e.key_cols)
            if e.distinct:
                p = self._path(obj_id, "distinct")
                self.state_template[p] = self._accums(kd, ())
            else:
                p = self._path(obj_id, "reduce")
                self.state_template[p] = self._accums(kd, tuple(a.accum_dtype for a in e.aggs))
            self._emitters[id(e)] = ("reduce", p)
        elif isinstance(e, lir.Threshold):
            p = self._path(obj_id, "threshold")
            self.state_template[p] = self._accums(self.infer_dtypes(e.input), ())
            self._emitters[id(e)] = ("threshold", p)
        elif isinstance(e, lir.TopK):
            in_dts = self.infer_dtypes(e.input)
            kd = tuple(in_dts[i] for i in e.plan.group_cols)
            p = self._path(obj_id, "topk")
            self.state_template[p] = self._batches(arr, kd, in_dts)
            self._emitters[id(e)] = ("topk", p)

    # -- emission -----------------------------------------------------------
    def emit_tick(self, ctx: _Ctx) -> dict:
        """Emit every object build; returns {obj_id: oks batch}."""
        outs = {}
        for bd in self.desc.objects_to_build:
            out = self._emit(bd.plan, ctx)
            ctx.env[bd.id] = out
            outs[bd.id] = out
        return outs

    def _emit(self, e, ctx: _Ctx) -> UpdateBatch:
        hit = ctx.memo.get(id(e))
        if hit is not None:
            return hit
        # a profiler range named after the plan node (a no-op when off)
        with _prof.named_scope(f"mzt:{type(e).__name__}"):
            out = self._emit_new(e, ctx)
        ctx.memo[id(e)] = out
        return out

    def _emit_new(self, e, ctx: _Ctx) -> UpdateBatch:
        if isinstance(e, lir.Get):
            return ctx.env[e.id]
        if isinstance(e, lir.Constant):
            # constants are injected by the host as pseudo-source deltas
            return ctx.env[_const_id(e)]
        if isinstance(e, lir.Mfp):
            inp = self._emit(e.input, ctx)
            if e.mfp.is_identity():
                return inp
            out, errs = e.mfp.apply(inp)
            ctx.errs.append(errs)
            return out
        if isinstance(e, lir.Negate):
            return negate(self._emit(e.input, ctx))
        if isinstance(e, lir.ArrangeBy):
            return self._emit(e.input, ctx)
        if isinstance(e, lir.Union):
            parts = [self._emit(i, ctx) for i in e.inputs]
            acc = parts[0]
            for p in parts[1:]:
                acc = UpdateBatch.concat(acc, p)
            return consolidate(acc)
        if isinstance(e, lir.FlatMap):
            # generate_series has a static fan-out bound (caps.join_out) and
            # an overflow flag, so it fuses like a sized join
            from ..ops.flat_map import flat_map_materialize

            out, errs, over = flat_map_materialize(self._emit(e.input, ctx), e.exprs,
                                                   self.caps.join_out)
            ctx.errs.append(errs)
            ctx.overflow.append(over)
            return out
        if isinstance(e, lir.Join):
            return self._emit_join(e, ctx)
        if isinstance(e, lir.Reduce):
            if e.distinct:
                return self._emit_multiplicity(e, ctx, e.key_cols, "distinct")
            return self._emit_reduce(e, ctx)
        if isinstance(e, lir.Threshold):
            n_cols = len(self.infer_dtypes(e.input))
            return self._emit_multiplicity(e, ctx, tuple(range(n_cols)), "threshold")
        if isinstance(e, lir.TopK):
            return self._emit_topk(e, ctx)
        raise FusedUnsupported(type(e).__name__)

    def _union_outs(self, outs: list, out_cap: int, ctx: _Ctx) -> UpdateBatch:
        """Concat partials, O(n)-compact the live rows, sort small, then shrink.

        Raw live rows are a multiset count (+/- pairs and duplicates from
        different levels cancel in the consolidation), so the compaction
        keeps 2 x out_cap of headroom; the final shrink checks the
        consolidated count against out_cap. Either overflow trips the retry.
        """
        acc = outs[0]
        for p in outs[1:]:
            acc = UpdateBatch.concat(acc, p)
        mid_cap = 2 * out_cap
        if acc.cap > mid_cap:
            acc, over = compact_to(acc, mid_cap)
            ctx.overflow.append(over)
        merged = consolidate(acc)
        if merged.cap <= out_cap:
            return merged
        ctx.overflow.append(merged.count() > out_cap)
        return merged.with_capacity(out_cap)

    def _exchanged(self, keyed: UpdateBatch, ctx: _Ctx) -> UpdateBatch:
        """Route a keyed batch to the worker owning its hash (a no-op off the
        mesh): co-keyed rows meet before they probe or enter sharded state."""
        if self.axis_name is None:
            return keyed
        bucket = self.caps.bucket or self.caps.delta
        out, f = exchange(keyed, ctx.comm, self.n_shards, bucket)
        ctx.overflow.append(f)
        return consolidate(out, compact=False)

    def _emit_join(self, e: lir.Join, ctx: _Ctx) -> UpdateBatch:
        caps = self.caps
        kind, slots = self._emitters[id(e)]
        deltas = [self._emit(i, ctx) for i in e.inputs]
        if kind == "linear_join":
            stream = deltas[0]
            for si, st in enumerate(e.plan.stages):
                lpath, rpath = slots[si]
                L = ctx.state_in[lpath]
                R = ctx.state_in[rpath]
                dlk = self._exchanged(arrange_batch(stream, st.stream_key), ctx)
                drk = self._exchanged(arrange_batch(deltas[si + 1], st.lookup_key), ctx)
                outs, f1 = lsm_join(dlk, R, caps.join_caps(dlk.cap, R))
                outs2, f2 = lsm_join(drk, L, caps.join_caps(drk.cap, L), swap=True)
                total, dd = join_with_total(dlk, drk, caps.join_out)
                ctx.overflow.extend([f1, f2, total > caps.join_out])
                newL, f3 = lsm_insert(L, dlk, ctx.time, caps.ratio, since=ctx.since)
                newR, f4 = lsm_insert(R, drk, ctx.time, caps.ratio, since=ctx.since)
                ctx.overflow.extend([f3, f4])
                ctx.state_out[lpath] = newL
                ctx.state_out[rpath] = newR
                stream = self._union_outs(outs + outs2 + [dd], caps.join_out, ctx)
        else:  # delta join
            arrs = slots  # {(input, key): path}
            # start-of-tick arrangements, updated as each path publishes
            cur = {k: ctx.state_in[p] for k, p in arrs.items()}
            outs_all = []
            for k, path_stages in enumerate(e.plan.paths):
                stream = deltas[k]
                for st in path_stages:
                    probe = self._exchanged(arrange_batch(stream, st.stream_key), ctx)
                    lsm = cur[(st.other_input, st.lookup_key)]
                    parts, f = lsm_join(probe, lsm, caps.join_caps(probe.cap, lsm))
                    ctx.overflow.append(f)
                    stream = self._union_outs(parts, caps.join_out, ctx)
                outs_all.append(_project_cols(stream, e.plan.permutations[k]))
                # publish input k's delta into its arrangements
                for (inp, key), path in arrs.items():
                    if inp == k:
                        keyed = self._exchanged(arrange_batch(deltas[k], key), ctx)
                        newA, f = lsm_insert(cur[(inp, key)], keyed, ctx.time, caps.ratio,
                                             since=ctx.since)
                        ctx.overflow.append(f)
                        cur[(inp, key)] = newA
                        ctx.state_out[path] = newA
            stream = self._union_outs(outs_all, caps.join_out, ctx)
        if e.closure is not None:
            stream, cerrs = e.closure.apply(stream)
            ctx.errs.append(cerrs)
        return stream

    def _emit_reduce(self, e: lir.Reduce, ctx: _Ctx) -> UpdateBatch:
        _kind, path = self._emitters[id(e)]
        lsm: LsmAccums = ctx.state_in[path]
        inp = self._emit(e.input, ctx)
        if self.axis_name is not None:
            inp = self._exchanged(arrange_batch(inp, e.key_cols), ctx)
        raw, errs = _contributions(inp, e.key_cols, e.aggs)
        ctx.errs.append(errs)
        contrib = consolidate_accums(raw)
        old_accums, old_nrows, missed = accum_lsm_lookup(lsm, contrib)
        ctx.errs.append(collision_errs(contrib, missed, ctx.time))
        ov = accum_overflow_errs(contrib, old_accums, e.aggs, ctx.time)
        if ov is not None:
            ctx.errs.append(ov)
        out = consolidate(_emit_output(contrib, old_accums, old_nrows, ctx.time, e.aggs))
        new_lsm, f = accum_lsm_insert(lsm, contrib, ctx.time, self.caps.ratio)
        ctx.overflow.append(f)
        ctx.state_out[path] = new_lsm
        return out

    def _emit_multiplicity(self, e, ctx: _Ctx, key_cols, mode: str) -> UpdateBatch:
        """Distinct / Threshold: a multiplicity map over a per-row count table."""
        _kind, path = self._emitters[id(e)]
        lsm: LsmAccums = ctx.state_in[path]
        inp = self._emit(e.input, ctx)
        if self.axis_name is not None:
            inp = self._exchanged(arrange_batch(inp, tuple(key_cols)), ctx)
        raw, _errs = _contributions(inp, tuple(key_cols), ())
        contrib = consolidate_accums(raw)
        _accs, old_n, missed = accum_lsm_lookup(lsm, contrib)
        ctx.errs.append(collision_errs(contrib, missed, ctx.time))
        new_n = old_n + contrib.nrows
        out_d = _multiplicity(mode, new_n) - _multiplicity(mode, old_n)
        live = contrib.live & (out_d != 0)
        out = UpdateBatch(
            hashes=_masked(live, contrib.hashes, PAD_HASH),
            keys=(),
            vals=contrib.keys,
            times=torch.where(live, ctx.time, PAD_TIME),
            diffs=torch.where(live, out_d, 0),
        )
        new_lsm, f = accum_lsm_insert(lsm, contrib, ctx.time, self.caps.ratio)
        ctx.overflow.append(f)
        ctx.state_out[path] = new_lsm
        return consolidate(out)

    def _emit_topk(self, e: lir.TopK, ctx: _Ctx) -> UpdateBatch:
        caps = self.caps
        _kind, path = self._emitters[id(e)]
        lsm: LsmBatches = ctx.state_in[path]
        inp = self._emit(e.input, ctx)
        keyed = self._exchanged(arrange_batch(inp, e.plan.group_cols), ctx)
        probes = distinct_keys(keyed)
        old_rows, f1 = _gather_lsm(probes, lsm, caps.gather, ctx.time)
        new_lsm, f2 = lsm_insert(lsm, keyed, ctx.time, caps.ratio, since=ctx.since)
        new_rows, f3 = _gather_lsm(probes, new_lsm, caps.gather, ctx.time)
        ctx.overflow.extend([f1, f2, f3])
        ctx.state_out[path] = new_lsm
        p = e.plan
        old_top = topk_select(old_rows, p.order_by, p.limit, p.offset, ctx.time, p.nulls_last)
        new_top = topk_select(new_rows, p.order_by, p.limit, p.offset, ctx.time, p.nulls_last)
        return consolidate(UpdateBatch.concat(new_top, negate(old_top)))


def _gather_lsm(probes: UpdateBatch, lsm: LsmBatches, cap: int, time: int):
    """Every arrangement row matching a probe key, across levels, with
    times advanced to `time`. A level whose matches exceed `cap` (what
    `_gather_materialize` would drop) trips the overflow flag."""
    parts = []
    overflow = torch.zeros((), dtype=torch.bool, device=probes.device)
    for level in lsm.levels:
        total, part = gather_with_total(probes, level, cap)
        overflow = overflow | (total > cap)
        parts.append(part)
    acc = parts[0]
    for p in parts[1:]:
        acc = UpdateBatch.concat(acc, p)
    return consolidate(advance_times(acc, time)), overflow


def _to(obj, device):
    """A state object (batch, accumulator table, LSM) with its tensors on
    `device` (the same tensors where they are there already)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(_to(x, device) for x in obj)
    return type(obj)(**{f.name: _to(getattr(obj, f.name), device) for f in fields(obj)})


def _joined(parts: list, device) -> UpdateBatch:
    """The workers' batches concatenated in worker order on `device`
    (`shard_map`'s P(axis) output)."""
    acc = _to(parts[0], device)
    for p in parts[1:]:
        acc = UpdateBatch.concat(acc, _to(p, device))
    return acc


def _project_cols(batch: UpdateBatch, perm) -> UpdateBatch:
    return UpdateBatch(
        batch.hashes, (), tuple(batch.vals[i] for i in perm), batch.times, batch.diffs
    )


def _accum_dtypes_linear(in_dts: list, stage_i: int) -> list:
    """Column dtypes of the accumulated stream entering stage i."""
    cols: list = []
    for k in range(stage_i + 1):
        cols.extend(in_dts[k])
    return cols


def _children(e):
    if isinstance(e, (lir.Mfp, lir.Negate, lir.Threshold, lir.ArrangeBy, lir.TopK,
                      lir.BasicAgg, lir.Reduce, lir.TemporalFilter, lir.FlatMap)):
        return (e.input,)
    if isinstance(e, (lir.Union, lir.Join)):
        return tuple(e.inputs)
    if isinstance(e, lir.LetRec):
        return tuple(b[1] for b in e.bindings) + (e.body,)
    return ()


def _const_id(e: lir.Constant) -> str:
    return f"__const_{id(e)}"


def _collect_constants(e, acc: dict) -> None:
    if isinstance(e, lir.Constant):
        acc[_const_id(e)] = e
    for c in _children(e):
        _collect_constants(c, acc)


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------


class FusedDataflow:
    """Drives a fused dataflow tick by tick: `step`, `peek`, `compact`.

    Overflow retries re-run the same tick from the pre-tick state with
    doubled capacities (lossless by design). `host_syncs` counts the
    device reads that `step` makes: a source's live count (only when its
    batch is larger than the delta capacity, or operator logging is on)
    and the one stacked read of flags and counts at the end of each tick
    (the reduce's lookups count theirs in ops/reduce.py's HOST_SYNCS).

    With `mesh` (a tuple of worker devices, parallel/mesh.py) the tick runs
    on every worker at once (`mesh_tick`), and `state` is a tuple of one
    state dict per worker, on that worker's device: the JAX package's global
    state arrays split on axis 0. Each tick's source deltas are padded to
    the global delta capacity (`n_shards` x the per-worker one) and cut by
    position into one equal part per worker, so a small batch lands whole
    on worker 0 and only the exchanges spread it. Outputs and errors are
    joined in worker order on the dataflow's `device`, counts summed, and
    any worker's overflow reruns the whole tick. A worker that raises ends
    the tick and its error is raised.
    """

    def __init__(
        self,
        desc: lir.DataflowDescription,
        caps: Optional[FusedCaps] = None,
        mesh=None,
        axis_name: str = "workers",
        traces=None,
        operator_logging: bool = False,
        device="cuda",
    ):
        # `traces`: the TraceManager, when arrangement sharing is on. Fused
        # state cannot import a host spine, so a plan whose stateful
        # operators would import an existing shared trace yields to the host
        # renderer; with nothing to import the fused render stays private
        # (it exports nothing).
        if traces is not None:
            from ..arrangement.trace_manager import shared_trace_keys

            if any(k in traces.traces for k in shared_trace_keys(desc)):
                raise FusedUnsupported("shared-trace import (host-resident spine)")
        self.desc = desc
        self.caps = caps or FusedCaps()
        self.device = torch.device(device)
        self.mesh = tuple(mesh) if mesh is not None else None
        self.axis_name = axis_name
        self.n_shards = len(self.mesh) if self.mesh is not None else 1
        self._scale = 1
        self._build()
        self.state = self._tiled_template()
        self.index_traces: dict[str, Arrangement] = {}
        self.index_errs: dict[str, Arrangement] = {}
        for idx_id, (_obj_id, key_cols) in desc.index_exports.items():
            self.index_traces[idx_id] = Arrangement(key_cols=tuple(key_cols), device=device)
            self.index_errs[idx_id] = Arrangement(key_cols=(), device=device)
        self.sink_outputs: dict[str, list] = {s: [] for s in desc.sink_exports}
        self.frontier = desc.as_of
        self.since = 0
        self._emitted_consts: set[str] = set()
        self.operator_logging = operator_logging
        # the whole tick is one pseudo-operator: elapsed/invocations always
        # on, row counts gated, `retries` counts overflow-ladder escalations
        self.retries = 0
        self.host_syncs = 0
        self._elapsed_ns = 0
        self._invocations = 0
        self._rows_in = 0
        self._rows_out = 0
        self._profile_name = next(
            iter(desc.index_exports),
            next(iter(b.id for b in desc.objects_to_build), "fused"),
        )

    # -- build ----------------------------------------------------------------
    def _build(self) -> None:
        on_mesh = self.mesh is not None
        self.compiler = FusedCompiler(
            self.desc, self.caps.scaled(self._scale),
            self.mesh[0] if on_mesh else self.device,
            axis_name=self.axis_name if on_mesh else None, n_shards=self.n_shards)
        self.consts: dict[str, lir.Constant] = {}
        for bd in self.desc.objects_to_build:
            _collect_constants(bd.plan, self.consts)
        if on_mesh:
            self._mesh_tick = mesh_tick(self._tick, self.mesh, self.axis_name)

    def _tick(self, comm, state: dict, deltas: dict, time: int, since: int):
        """One worker's tick (`comm` None off the mesh): (state', outs, errs,
        [overflow, counts..., error count] stacked in one int64 tensor for
        the tick's one read)."""
        ctx = _Ctx(
            state_in=state, state_out=dict(state), env=dict(deltas), time=time,
            since=since, errs=[], overflow=[], memo={}, comm=comm,
        )
        outs = self.compiler.emit_tick(ctx)
        if ctx.errs:
            # error streams are almost always empty: O(n)-compact the concat
            # into a small buffer before the canonicalizing sort. The buffer
            # scales with the retry ladder: the error-row count depends on
            # the data, so a fixed buffer could make a burst retry forever.
            err_cap = _ERR_COMPACT_CAP * self._scale
            errs = ctx.errs[0]
            for p in ctx.errs[1:]:
                errs = UpdateBatch.concat(errs, p)
            if errs.cap > err_cap:
                errs, err_over = compact_to(errs, err_cap)
                ctx.overflow.append(err_over)
            errs = consolidate(errs)
        else:
            dev = comm.device if comm is not None else self.device
            errs = UpdateBatch.empty(8, (), torch_dtypes(ERR_DTYPES), dev)
        over = torch.zeros((), dtype=torch.int64, device=errs.device)
        if ctx.overflow:
            over = torch.stack([f.reshape(()) for f in ctx.overflow]).any().to(torch.int64)
        counts = [outs[bd.id].count() for bd in self.desc.objects_to_build]
        return ctx.state_out, outs, errs, torch.stack([over, *counts, errs.count()])

    def _tiled_template(self):
        """The empty state: a dict {path: LSM}, or on a mesh one such dict
        per worker on its device (the template at per-worker capacities)."""
        tmpl = dict(self.compiler.state_template)
        if self.mesh is None:
            return tmpl
        return tuple({p: _to(st, dev) for p, st in tmpl.items()} for dev in self.mesh)

    def worker_states(self) -> list:
        """The state dicts, one per worker (one off the mesh)."""
        return [self.state] if self.mesh is None else list(self.state)

    def ensure_delta_capacity(self, n_rows: int) -> None:
        """Grow capacities (and migrate state) until a tick of `n_rows`
        input rows fits: bulk hydration ticks skip the retry ladder."""
        if self._delta_cap() >= max(n_rows, 1):
            return
        while self._delta_cap() < n_rows:
            self._scale *= 2
        self.retries += 1
        self._build()
        self._migrate_state()

    def _migrate_state(self) -> None:
        """Pad existing state into the new (larger) capacity template. On a
        mesh each worker's levels pad at their own tail, so live rows keep
        their owning worker."""
        tmpl = self._tiled_template()
        grown = []
        for cur, want in zip(self.worker_states(), [tmpl] if self.mesh is None else tmpl):
            grown.append({
                path: t if path not in cur else type(t)(tuple(
                    have.with_capacity(w.cap) for have, w in zip(cur[path].levels, t.levels)))
                for path, t in want.items()
            })
        self.state = grown[0] if self.mesh is None else tuple(grown)

    def _delta_cap(self) -> int:
        """The global per-source delta capacity (n_shards x the per-worker one)."""
        return self.caps.scaled(self._scale).delta * self.n_shards

    # -- drive --------------------------------------------------------------
    def step(self, tick: int, source_deltas: dict[str, UpdateBatch]) -> dict:
        t0 = _time.perf_counter_ns()
        delta_cap = self._delta_cap()
        deltas: dict[str, UpdateBatch] = {}
        rows_in = 0
        for sid, dts in self.desc.source_imports.items():
            b = source_deltas.get(sid)
            if b is None:
                deltas[sid] = UpdateBatch.empty(delta_cap, (), torch_dtypes(dts), self.device)
                continue
            if b.cap > delta_cap or self.operator_logging:
                # a batch no larger than the delta capacity always fits
                n = int(b.count())
                self.host_syncs += 1
                rows_in += n
                if n > delta_cap:
                    # oversized input tick: grow before trying
                    self.ensure_delta_capacity(n)
                    return self.step(tick, source_deltas)
            deltas[sid] = b.with_capacity(delta_cap)
        for cid, c in self.consts.items():
            deltas[cid] = self._const_delta(cid, c, tick, delta_cap)

        with _prof.annotate(f"mzt_fused_tick:{self._profile_name}"):
            t, since = device_time_scalar(tick), device_time_scalar(self.since)
            if self.mesh is None:
                state2, outs, errs, read = self._tick(None, self.state, deltas, t, since)
            else:
                from ..models.fused_q3 import split_batch

                n = self.n_shards
                parts = {k: split_batch(b, self.mesh) for k, b in deltas.items()}
                per = self._mesh_tick(self.state,
                                      [{k: p[w] for k, p in parts.items()} for w in range(n)],
                                      (t,) * n, (since,) * n)
                state2 = tuple(p[0] for p in per)
                read = torch.stack([p[3].to(self.device) for p in per]).sum(0)
            # the tick's one device read: the overflow flags and the counts
            host = read.tolist()
            self.host_syncs += 1
        over, counts = bool(host[0]), host[1:]
        if over:
            # lossless retry: drop results, double capacities, re-run the
            # same tick from the unchanged pre-tick state
            if self.mesh is not None:
                note_overflow_retry()
            self.retries += 1
            self._elapsed_ns += _time.perf_counter_ns() - t0
            self._scale *= 2
            self._build()
            self._migrate_state()
            return self.step(tick, source_deltas)
        self.state = state2
        for cid, c in self.consts.items():
            if all(r[1] <= tick for r in c.rows):
                self._emitted_consts.add(cid)
        if self.mesh is not None:
            # the workers' outputs joined in worker order, those read below
            outs = {bd.id: _joined([p[1][bd.id] for p in per], self.device)
                    for i, bd in enumerate(self.desc.objects_to_build) if counts[i] > 0}
            errs = _joined([p[2] for p in per], self.device) if counts[-1] > 0 else None

        results: dict = {}
        err_delta = errs if counts[-1] > 0 else None
        for i, bd in enumerate(self.desc.objects_to_build):
            oks = outs[bd.id] if counts[i] > 0 else None
            results[bd.id] = None if (oks is None and err_delta is None) else (oks, err_delta)
        for idx_id, (obj_id, _k) in self.desc.index_exports.items():
            d = results.get(obj_id)
            if d is not None:
                oks, ie = d
                if oks is not None:
                    self.index_traces[idx_id].insert(oks)
                if ie is not None:
                    self.index_errs[idx_id].insert(ie)
        for sink_id, obj_id in self.desc.sink_exports.items():
            d = results.get(obj_id)
            if d is not None and d[0] is not None:
                self.sink_outputs[sink_id].append((tick, d[0]))
        self._elapsed_ns += _time.perf_counter_ns() - t0
        self._invocations += 1
        if self.operator_logging:
            self._rows_in += rows_in
            self._rows_out += int(sum(counts[:-1]))
        self.frontier = tick + 1
        return results

    def _const_delta(self, cid: str, c: lir.Constant, tick: int, delta_cap: int) -> UpdateBatch:
        tdts = torch_dtypes(c.dtypes)
        if cid in self._emitted_consts:
            return UpdateBatch.empty(delta_cap, (), tdts, self.device)
        pending = [r for r in c.rows if r[1] <= tick]
        if not pending:
            return UpdateBatch.empty(delta_cap, (), tdts, self.device)
        cols = tuple(
            np.array([r[0][i] for r in pending], dtype=c.dtypes[i])
            for i in range(len(c.dtypes))
        )
        times = np.array([max(r[1], tick) for r in pending], dtype=np.uint64)
        diffs = np.array([r[2] for r in pending], dtype=np.int64)
        return UpdateBatch.build((), cols, times, diffs, cap=delta_cap, device=self.device)

    # -- reads / maintenance ----------------------------------------------------
    def peek(self, index_id: str, at: Optional[int] = None,
             byte_budget: int | None = None) -> list[tuple]:
        at = self.frontier - 1 if at is None else at
        acc: dict[tuple, int] = {}
        for data, _t, d in self.index_errs[index_id].rows_host(at):
            acc[data] = acc.get(data, 0) + d
        if any(v > 0 for v in acc.values()):
            raise RuntimeError(peek_error_message(index_id, acc))
        out: dict[tuple, int] = {}
        for data, _t, d in self.index_traces[index_id].rows_host(at):
            out[data] = out.get(data, 0) + d
        return materialize_counts(out, index_id, byte_budget=byte_budget)

    def compact(self, since: int) -> None:
        self.since = max(self.since, since)
        for arr in self.index_traces.values():
            arr.compact(since)
        for arr in self.index_errs.values():
            arr.compact(since)

    def operator_info(self) -> list:
        # one tick is one pseudo-operator (the host renderer's 5-tuple shape)
        return [("fused", 0, "FusedTick", self._elapsed_ns, self._invocations)]

    def operator_rates(self) -> list:
        return [("fused", 0, "FusedTick", self._rows_in, self._rows_out, self.retries)]

    def arrangement_info(self) -> list:
        """(object, operator, name, batches, capacity, live rows, bytes) of
        every state path and index spine. Bytes are the port's own: hashes
        and times take 8 B a row here (4 B in the JAX package).
        On a mesh each state path's row sums its workers' levels: the JAX
        package's global arrays."""
        out = []
        states = self.worker_states()
        for path, st in states[0].items():
            levels = [b for w in states for b in w[path].levels]
            n = sum(int(b.count()) for b in levels)
            cap = sum(b.cap for b in levels)
            if isinstance(st, LsmBatches):
                nbytes = sum(batch_nbytes(b) for b in levels)
            else:
                nbytes = sum(accum_state_nbytes(a) for a in levels)
            out.append(("fused", 0, path, len(st.levels), cap, n, nbytes))
        for kind, spines in (("index_trace", self.index_traces), ("index_errs", self.index_errs)):
            for idx_id, arr in spines.items():
                out.append((idx_id, -1, kind, len(arr.batches), arr.total_cap(),
                            int(arr.count()), arrangement_nbytes(arr)))
        return out
