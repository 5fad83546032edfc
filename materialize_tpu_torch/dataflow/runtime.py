"""Render LIR plans into stateful operators and drive them tick by tick.

Counterpart of materialize_tpu/dataflow/runtime.py: the host-orchestrated
renderer, `Dataflow`, which `render_dataflow` gives every dataflow unless
the fused renderer is asked for and takes the plan. The control plane (the
operator graph, frontiers, state capacities) lives in Python; every batch
of data work is a sequence of torch operations and the hand-written kernels
(`probe`, `probe2`, `multi_take`, `run_sum`) on the dataflow's device.

Per tick every collection produces an optional delta `(oks, errs)`; `None`
means "no change", so quiet subgraphs do no device work. Operators size
their outputs by reading counts from the device (`ops.reduce.host_int`,
counted in `ops.reduce.HOST_SYNCS["host_path"]`).

With `traces=` (an `arrangement.trace_manager.TraceManager`), stateful
operators over imported collections share one arrangement (or one
accumulable reduce) per collection and key across dataflows:
`SharedArrangeNode`, `SharedReduceNode` and the shared sides of the join
nodes read the trace through a `TraceHandle`.

Not ported yet: the sharded replica's exchange (`shard=`, `ShardContext`,
`ExchangeNode`, over `parallel/netexchange.py` and `cluster/mesh.py`);
asking for it raises.
"""

from __future__ import annotations

import time as _time
from typing import Optional

import numpy as np
import torch

from ..arrangement.spine import Arrangement, arrange_batch
from ..expr.scalar import NULL_I64, null_sentinel, torch_dtype
from ..obs import profiler as _prof
from ..ops.consolidate import consolidate
from ..ops.join import join_against
from ..ops.reduce import AccumState, accumulable_step, agg_out_dtype, host_int
from ..ops.threshold import threshold_step
from ..ops.topk import negate as negate_batch
from ..ops.topk import topk_step
from ..repr.batch import MAX_DEVICE_TIME, PAD_TIME, UpdateBatch, bucket_cap, device_time_scalar
from ..repr.hashing import PAD_HASH
from . import plan as lir
from .antichain import EMPTY, Antichain

ERR_DTYPES = (np.dtype(np.int64),)

Delta = Optional[tuple]  # (oks or None, errs or None), or None for no change


def torch_dtypes(dtypes) -> tuple:
    """torch dtypes of numpy dtypes (plans carry numpy dtypes)."""
    return tuple(torch_dtype(d) for d in dtypes)


def _union(parts: list) -> Optional[UpdateBatch]:
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    acc = parts[0]
    for p in parts[1:]:
        acc = UpdateBatch.concat(acc, p)
    return consolidate(acc)


def _project(batch: UpdateBatch, cols: tuple) -> UpdateBatch:
    return UpdateBatch(batch.hashes, (), tuple(batch.vals[i] for i in cols), batch.times,
                       batch.diffs)


def _quiet(d: Delta) -> bool:
    """No oks for a one-input operator to work on."""
    return d is None or d[0] is None


def _errs_only(d: Delta) -> Delta:
    """What a one-input operator passes on when `_quiet(d)`: the errs, if any."""
    return None if d is None or d[1] is None else (None, d[1])


class Node:
    """One rendered LIR operator."""

    def step(self, tick: int, ins: list) -> Delta:
        raise NotImplementedError

    def compact(self, since: int) -> None:
        pass

    def state_info(self) -> list:
        """[(arrangement name, n_batches, capacity, records)]."""
        return []


class ConstantNode(Node):
    def __init__(self, expr: lir.Constant, device):
        self.rows = expr.rows
        self.dtypes = expr.dtypes
        self.emitted = False
        self.device = device

    def step(self, tick, ins):
        if self.emitted:
            return None
        pending = [r for r in self.rows if r[1] <= tick]
        if not pending:
            return None
        self.emitted = all(r[1] <= tick for r in self.rows)
        cols = tuple(
            np.array([r[0][i] for r in pending], dtype=self.dtypes[i])
            for i in range(len(self.dtypes))
        )
        times = np.array([max(r[1], tick) for r in pending], dtype=np.uint64)
        diffs = np.array([r[2] for r in pending], dtype=np.int64)
        return UpdateBatch.build((), cols, times, diffs, device=self.device), None


class MfpNode(Node):
    def __init__(self, mfp):
        self.mfp = mfp

    def step(self, tick, ins):
        if _quiet(ins[0]):
            return _errs_only(ins[0])
        oks, errs = ins[0]
        if self.mfp.is_identity():
            return oks, errs
        out, new_errs = self.mfp.apply(oks)
        return out, _union([errs, new_errs])


class FlatMapNode(Node):
    """generate_series through the two-pass sized fan-out (ops/flat_map.py),
    its output capacity sized by the count pass."""

    def __init__(self, expr):
        self.exprs = tuple(expr.exprs)

    def step(self, tick, ins):
        from ..ops.flat_map import flat_map_materialize, flat_map_total

        if _quiet(ins[0]):
            return _errs_only(ins[0])
        oks, errs = ins[0]
        total = host_int(flat_map_total(oks, self.exprs))
        out, new_errs, _over = flat_map_materialize(oks, self.exprs, bucket_cap(total))
        return out, _union([errs, new_errs])


class NegateNode(Node):
    def step(self, tick, ins):
        d = ins[0]
        if d is None:
            return None
        oks, errs = d
        return (negate_batch(oks) if oks is not None else None), errs


class UnionNode(Node):
    def step(self, tick, ins):
        oks = _union([d[0] for d in ins if d is not None])
        errs = _union([d[1] for d in ins if d is not None])
        if oks is None and errs is None:
            return None
        return oks, errs


class ArrangeByNode(Node):
    def __init__(self, key_cols: tuple, device):
        self.arr = Arrangement(key_cols=key_cols, device=device)

    def step(self, tick, ins):
        d = ins[0]
        if d is None:
            return None
        oks, errs = d
        if oks is not None:
            self.arr.insert(oks)
        return oks, errs

    def compact(self, since):
        self.arr.compact(since)

    def state_info(self):
        return [("arrange_by", len(self.arr.batches), self.arr.total_cap(), self.arr.count())]


def _shared_state_info(h) -> tuple:
    """(batches, cap, records) to report for a shared trace handle: the
    exporter owns the memory; importers report zero cap and records, so a
    sum over dataflows counts every shared trace once."""
    nb, cap, rec = h.trace.state_info()
    if h.imported:
        return nb, 0, 0
    return nb, cap, rec


class SharedArrangeNode(Node):
    """ArrangeBy over a shared trace: pass the delta through, offering it to
    the trace (one insert a tick across every reader) instead of keeping a
    private spine."""

    def __init__(self, handle, key_cols: tuple):
        self.h = handle
        self.key_cols = key_cols

    def step(self, tick, ins):
        d = ins[0]
        if d is None:
            return None
        oks, errs = d
        if oks is not None:
            self.h.offer(tick, arrange_batch(oks, self.key_cols))
        return oks, errs

    def state_info(self):
        return [(self.h.name(),) + _shared_state_info(self.h)]


class LinearJoinNode(Node):
    """Binary join chain; each stage keeps arrangements of both sides.

    `shared` (one (stream handle, lookup handle) pair per stage, None where
    private) swaps a side's private arrangement for a shared trace: the
    tick's delta is offered first (so `thru(t)` includes it), dA joins the
    other side through t, dB joins this side before t, and the dA x dB term
    is emitted only when the right side is private. Only stage 0's stream,
    an imported collection, can be shared."""

    def __init__(self, jplan: lir.LinearJoinPlan, closure, device, shared=None):
        self.stages = jplan.stages
        self.closure = closure
        self.shared = shared or [(None, None) for _ in self.stages]
        self.state = [
            (None if lh is not None else Arrangement(key_cols=s.stream_key, device=device),
             None if rh is not None else Arrangement(key_cols=s.lookup_key, device=device))
            for s, (lh, rh) in zip(self.stages, self.shared)
        ]

    def _binary(self, stage_i: int, dl, dr, tick: int):
        stage = self.stages[stage_i]
        left_arr, right_arr = self.state[stage_i]
        lh, rh = self.shared[stage_i]
        outs = []
        dlk = arrange_batch(dl, stage.stream_key) if dl is not None else None
        drk = arrange_batch(dr, stage.lookup_key) if dr is not None else None
        if lh is not None:
            lh.offer(tick, dlk)
        if rh is not None:
            rh.offer(tick, drk)
        if dlk is not None:
            outs += join_against(dlk, rh.thru(tick) if rh is not None else right_arr.batches)
        if drk is not None:
            outs += join_against(drk, lh.before(tick) if lh is not None else left_arr.batches,
                                 swap=True)
        if rh is None and dlk is not None and drk is not None:
            outs += join_against(dlk, [drk])  # arrange_batch consolidated drk
        if lh is None and dlk is not None:
            left_arr.insert(dlk, already_keyed=True)
        if rh is None and drk is not None:
            right_arr.insert(drk, already_keyed=True)
        return _union(outs)

    def step(self, tick, ins):
        errs = _union([d[1] for d in ins if d is not None])
        stream = ins[0][0] if ins[0] is not None else None
        for i in range(len(self.stages)):
            right = ins[i + 1][0] if ins[i + 1] is not None else None
            stream = self._binary(i, stream, right, tick)
        if stream is None and errs is None:
            return None
        if stream is not None and self.closure is not None:
            stream, cerrs = self.closure.apply(stream)
            errs = _union([errs, cerrs])
        return stream, errs

    def compact(self, since):
        for left, right in self.state:
            if left is not None:
                left.compact(since)
            if right is not None:
                right.compact(since)

    def state_info(self):
        out = []
        for i, (left, right) in enumerate(self.state):
            lh, rh = self.shared[i]
            if left is not None:
                out.append((f"join_stage{i}_left", len(left.batches), left.total_cap(),
                            left.count()))
            else:
                out.append((f"join_stage{i}_left:{lh.name()}",) + _shared_state_info(lh))
            if right is not None:
                out.append((f"join_stage{i}_right", len(right.batches), right.total_cap(),
                            right.count()))
            else:
                out.append((f"join_stage{i}_right:{rh.name()}",) + _shared_state_info(rh))
        return out


class DeltaJoinNode(Node):
    """Delta join: one update path per input, streaming through the other
    inputs' arrangements with no intermediate state. Paths run in input
    order; input k's delta enters k's arrangements after path k runs, so
    path k sees inputs j < k up to date and inputs j > k as of the previous
    paths.

    `shared` maps (input, lookup key) to a TraceHandle for inputs that are
    imported collections; a shared trace gives path k the inputs j < k
    through the tick and j > k before it by time, not by insertion order."""

    def __init__(self, jplan: lir.DeltaJoinPlan, closure, device, shared=None):
        self.plan = jplan
        self.closure = closure
        self.shared: dict = shared or {}
        self.arrs: dict = {}
        for path in jplan.paths:
            for st in path:
                key = (st.other_input, st.lookup_key)
                if key not in self.arrs and key not in self.shared:
                    self.arrs[key] = Arrangement(key_cols=st.lookup_key, device=device)

    def _lookup_batches(self, k: int, st, tick: int) -> list:
        key = (st.other_input, st.lookup_key)
        h = self.shared.get(key)
        if h is None:
            return self.arrs[key].batches
        return h.thru(tick) if st.other_input < k else h.before(tick)

    def step(self, tick, ins):
        errs = _union([d[1] for d in ins if d is not None])
        outs = []
        # shared arrangements take their input's delta first (offers are
        # idempotent; the first reader of a tick wins)
        for (inp, key), h in self.shared.items():
            dk = ins[inp][0] if ins[inp] is not None else None
            h.offer(tick, arrange_batch(dk, key) if dk is not None else None)
        for k, path in enumerate(self.plan.paths):
            dk = ins[k][0] if ins[k] is not None else None
            stream = dk
            for st in path:
                if stream is None:
                    break
                probe = arrange_batch(stream, st.stream_key)
                stream = _union(join_against(probe, self._lookup_batches(k, st, tick)))
            if stream is not None:
                outs.append(_project(stream, self.plan.permutations[k]))
            # now publish input k's delta to its private arrangements
            if dk is not None:
                for (inp, key), arr in self.arrs.items():
                    if inp == k:
                        arr.insert(arrange_batch(dk, key), already_keyed=True)
        out = _union(outs)
        if out is None and errs is None:
            return None
        if out is not None and self.closure is not None:
            out, cerrs = self.closure.apply(out)
            errs = _union([errs, cerrs])
        return out, errs

    def compact(self, since):
        for arr in self.arrs.values():
            arr.compact(since)

    def state_info(self):
        out = [
            (f"delta_in{inp}_key{list(key)}", len(a.batches), a.total_cap(), a.count())
            for (inp, key), a in self.arrs.items()
        ]
        for (inp, key), h in self.shared.items():
            out.append((f"delta_in{inp}_key{list(key)}:{h.name()}",) + _shared_state_info(h))
        return out


def _accum_empty(key_dtypes, accum_dtypes, device) -> AccumState:
    return AccumState.empty(8, torch_dtypes(key_dtypes), torch_dtypes(accum_dtypes), device)


class ReduceNode(Node):
    def __init__(self, expr: lir.Reduce, in_dtypes: tuple, device):
        self.key_cols = expr.key_cols
        self.aggs = expr.aggs
        self.state = _accum_empty(tuple(in_dtypes[i] for i in expr.key_cols),
                                  tuple(a.accum_dtype for a in expr.aggs), device)

    def step(self, tick, ins):
        if _quiet(ins[0]):
            return _errs_only(ins[0])
        oks, errs = ins[0]
        self.state, out, agg_errs = accumulable_step(self.state, oks, self.key_cols, self.aggs,
                                                     tick)
        n = host_int(self.state.count())
        if bucket_cap(n) < self.state.cap:
            self.state = self.state.with_capacity(bucket_cap(n))
        return out, _union([errs, agg_errs])

    def state_info(self):
        return [("reduce_accums", 1, self.state.cap, int(self.state.count()))]


class SharedReduceNode(Node):
    """Accumulable reduce over a shared aggregate trace: the accumulator
    table steps once a tick across every reader (SharedReduceTrace memoizes
    the emission), and an importing dataflow hydrates from the trace's
    cumulative output instead of re-aggregating its input snapshot."""

    def __init__(self, handle):
        self.h = handle

    def step(self, tick, ins):
        d = ins[0]
        if self.h._hydrating(tick):
            if self.h.trusted:
                # live peek: the shared state already reflects the
                # collection through this tick
                out, agg_errs = self.h.trace.snapshot(tick)
            else:
                # installed import: aggregate the own input snapshot
                # privately; the shared state takes over after as_of
                out, agg_errs = self._private_hydration(tick, d)
            errs = _union([d[1] if d is not None else None, agg_errs])
            if out is None and errs is None:
                return None
            return out, errs
        if _quiet(d):
            return _errs_only(d)
        oks, errs = d
        out, agg_errs = self.h.trace.step(tick, oks)
        return out, _union([errs, agg_errs])

    def _private_hydration(self, tick, d):
        """Aggregate the hydration snapshot against an empty throwaway
        accumulator (what a private ReduceNode would emit)."""
        if d is None or d[0] is None:
            return None, None
        tr = self.h.trace
        scratch = AccumState.empty(8, tuple(k.dtype for k in tr.state.keys),
                                   tuple(a.dtype for a in tr.state.accums),
                                   tr.state.hashes.device)
        _state, out, errs = accumulable_step(scratch, d[0], tr.key_cols, tr.aggs, tick)
        return out, errs

    def state_info(self):
        return [(self.h.name(),) + _shared_state_info(self.h)]


class FusedMfpReduceNode(Node):
    """Mfp then Reduce in one step (ops/fused_reduce.py); the state's
    capacity is sticky (grow-only, powers of two)."""

    def __init__(self, mfp, expr: lir.Reduce, mfp_out_dtypes: tuple, device):
        self.mfp = mfp
        self.key_cols = expr.key_cols
        self.aggs = expr.aggs
        self.state = _accum_empty(tuple(mfp_out_dtypes[i] for i in expr.key_cols),
                                  tuple(a.accum_dtype for a in expr.aggs), device)
        self.state_cap = 8

    def step(self, tick, ins):
        from ..ops.fused_reduce import fused_mfp_reduce_step

        if _quiet(ins[0]):
            return _errs_only(ins[0])
        oks, errs = ins[0]
        self.state, out, agg_errs = fused_mfp_reduce_step(
            self.state, oks, tick, self.mfp, self.key_cols, self.aggs)
        n = host_int(self.state.count())
        if bucket_cap(n) > self.state_cap:
            self.state_cap = bucket_cap(n)
        self.state = self.state.with_capacity(self.state_cap)
        return out, _union([errs, agg_errs])

    def state_info(self):
        return [("fused_reduce_accums", 1, self.state.cap, int(self.state.count()))]


_ABSENT = object()


class BasicAggNode(Node):
    """ReducePlan::Basic: string_agg, array_agg, list_agg, jsonb_agg and the
    string min/max. Keeps each group's multiset of elements on the host
    (strings are host data; the device carries dictionary codes) and
    re-renders the affected groups each tick as a retract/insert pair.
    Elements render in the sort order of their decoded values. Each
    re-render interns a string into the append-only dictionary."""

    def __init__(self, e, in_dtypes: tuple, device):
        self.nk = len(e.key_cols)
        self.func = e.func
        self.delim, self.argtype, self.dct = e.extra
        self.in_dtypes = tuple(np.dtype(d) for d in in_dtypes)
        el_dt = self.in_dtypes[self.nk]
        self.el_null = None if el_dt.kind == "f" else int(null_sentinel(el_dt))
        self.groups: dict = {}  # key tuple -> {element raw value: count}
        self.current: dict = {}  # key tuple -> emitted rendered code (or None)
        self.device = device

    def _decode_el(self, el):
        from ..expr.strings import decode_storage_value

        return decode_storage_value(self.argtype, el, self.dct, bool_style="tf")

    def _render(self, multiset: dict):
        """Rendered value (a str) or None (SQL NULL) for one group."""
        distinct, nulls = [], 0
        for el, cnt in multiset.items():
            if cnt < 0:
                raise ValueError("basic aggregate saw net-negative multiplicity")
            if el is None or el == self.el_null:
                nulls += cnt
            else:
                rendered = self._decode_el(el)
                # order by value (strings and jsonb by canonical text,
                # numbers numerically), never by dictionary code
                sk = rendered if self.argtype in ("str", "jsonb") else el
                distinct.append((sk, rendered, cnt))
        if self.func in ("min_str", "max_str"):
            if not distinct:
                return None
            pick = min if self.func == "min_str" else max
            return pick(distinct, key=lambda p: p[0])[1]
        live = []
        for _sk, rendered, cnt in sorted(distinct, key=lambda p: p[0]):
            live.extend([rendered] * cnt)
        if self.func == "string_agg":
            # string_agg skips NULL inputs; an all-NULL group is NULL
            return self.delim.join(live) if live else None
        if self.func == "jsonb_agg":
            import json as _json

            at = self.argtype

            def as_json(r):
                if at == "jsonb":
                    return _json.loads(r)
                if at == "int" or (isinstance(at, tuple) and at[0] == "numeric"):
                    return float(r) if "." in r else int(r)
                if at == "float":
                    return float(r)
                if at == "bool":
                    return r == "t"
                return r  # strings stay JSON strings

            elements = [as_json(r) for r in live] + [None] * nulls
            return _json.dumps(elements, separators=(",", ":"))

        # array_agg / list_agg keep NULL elements (pg semantics), NULLs last
        def q(s: str) -> str:
            if s == "" or any(ch in '{},"\\' or ch.isspace() for ch in s) or s.upper() == "NULL":
                return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
            return s

        return "{" + ",".join([q(s) for s in live] + ["NULL"] * nulls) + "}"

    def step(self, tick, ins):
        if _quiet(ins[0]):
            return _errs_only(ins[0])
        oks, errs = ins[0]
        affected = set()
        for vals, _t, diff in oks.to_rows():
            k = tuple(vals[: self.nk])
            el = vals[self.nk]
            g = self.groups.setdefault(k, {})
            g[el] = g.get(el, 0) + diff
            if g[el] == 0:
                del g[el]
            if not g:
                del self.groups[k]
            affected.add(k)
        out = []  # (key tuple, code or None, diff)
        for k in affected:
            old = self.current.get(k, _ABSENT)
            if k in self.groups:
                r = self._render(self.groups[k])
                new = None if r is None else self.dct.encode(r)
            else:
                new = _ABSENT
            if old is new or (old is not _ABSENT and new is not _ABSENT and old == new):
                continue
            if old is not _ABSENT:
                out.append((k, old, -1))
            if new is not _ABSENT:
                out.append((k, new, 1))
                self.current[k] = new
            else:
                self.current.pop(k, None)
        if not out:
            return None, errs
        cols = []
        for i in range(self.nk):
            dt = self.in_dtypes[i]
            fill = np.nan if dt.kind == "f" else 0
            cols.append(np.array([fill if row[0][i] is None else row[0][i] for row in out],
                                 dtype=dt))
        cols.append(np.array([NULL_I64 if c is None else c for _k, c, _d in out],
                             dtype=np.int64))
        times = np.full(len(out), int(tick), dtype=np.uint64)
        diffs = np.array([d_ for _k, _c, d_ in out], dtype=np.int64)
        return UpdateBatch.build((), tuple(cols), times, diffs, device=self.device), errs

    def state_info(self):
        n = sum(len(g) for g in self.groups.values())
        rendered_bytes = sum(
            0 if c is None else len(self.dct.decode(c)) for c in self.current.values()
        )
        return [
            ("basic_agg_groups", 1, max(n, 1), len(self.groups)),
            ("basic_agg_rendered_bytes", 1, max(rendered_bytes, 1), rendered_bytes),
        ]


class DistinctNode(Node):
    """ReducePlan::Distinct: project to the key columns, then presence per row."""

    def __init__(self, key_cols: tuple, in_dtypes: tuple, device):
        self.key_cols = key_cols
        self.state = _accum_empty(tuple(in_dtypes[i] for i in key_cols), (), device)

    def step(self, tick, ins):
        if _quiet(ins[0]):
            return _errs_only(ins[0])
        oks, errs = ins[0]
        self.state, out, coll = threshold_step(self.state, _project(oks, self.key_cols),
                                               "distinct", tick)
        return out, _union([errs, coll])

    def state_info(self):
        return [("distinct_accums", 1, self.state.cap, int(self.state.count()))]


class ThresholdNode(Node):
    def __init__(self, in_dtypes: tuple, device):
        self.state = _accum_empty(tuple(in_dtypes), (), device)

    def step(self, tick, ins):
        if _quiet(ins[0]):
            return _errs_only(ins[0])
        oks, errs = ins[0]
        self.state, out, coll = threshold_step(self.state, oks, "threshold", tick)
        return out, _union([errs, coll])

    def state_info(self):
        return [("threshold_accums", 1, self.state.cap, int(self.state.count()))]


class TopKNode(Node):
    def __init__(self, tplan, device):
        self.plan = tplan
        self.arr = Arrangement(key_cols=tplan.group_cols, device=device)

    def step(self, tick, ins):
        if _quiet(ins[0]):
            return _errs_only(ins[0])
        oks, errs = ins[0]
        keyed = arrange_batch(oks, self.plan.group_cols)
        return topk_step(self.arr, keyed, self.plan, tick), errs

    def compact(self, since):
        self.arr.compact(since)

    def state_info(self):
        return [("topk_input", len(self.arr.batches), self.arr.total_cap(), self.arr.count())]


class WindowNode(Node):
    """Window functions by affected-partition recompute (ops/window.py)."""

    def __init__(self, wplan, device):
        self.plan = wplan
        self.arr = Arrangement(key_cols=wplan.partition_cols, device=device)

    def step(self, tick, ins):
        from ..ops.window import window_step

        if _quiet(ins[0]):
            return _errs_only(ins[0])
        oks, errs = ins[0]
        keyed = arrange_batch(oks, self.plan.partition_cols)
        return window_step(self.arr, keyed, self.plan, tick), errs

    def compact(self, since):
        self.arr.compact(since)

    def state_info(self):
        return [("window_input", len(self.arr.batches), self.arr.total_cap(), self.arr.count())]


class MonotonicTopKNode(Node):
    """TopK over an append-only input: the state is only the current winners
    (the top offset + limit rows of each touched group), since a group's new
    top-k is a subset of its stored winners and its new rows."""

    def __init__(self, tplan, device):
        assert tplan.limit is not None
        self.plan = tplan
        self.keep = tplan.offset + tplan.limit
        self.out_arr = Arrangement(key_cols=tplan.group_cols, device=device)

    def step(self, tick, ins):
        from ..ops.topk import distinct_keys, gather_groups, negate, topk_select

        if _quiet(ins[0]):
            return _errs_only(ins[0])
        oks, errs = ins[0]
        if host_int((oks.live & (oks.diffs < 0)).sum()) > 0:
            raise RuntimeError("monotonic top-k saw a retraction; plan must use the general path")
        keyed = arrange_batch(oks, self.plan.group_cols)
        probes = distinct_keys(keyed)
        vdt = tuple(v.dtype for v in keyed.vals)
        old_kept = gather_groups(probes, self.out_arr.batches, tick, vdt)
        cand = consolidate(UpdateBatch.concat(old_kept, keyed))
        p = self.plan
        nl = p.nulls_last
        new_kept = topk_select(cand, p.order_by, self.keep, 0, tick, nl)
        new_window = topk_select(cand, p.order_by, p.limit, p.offset, tick, nl)
        old_window = topk_select(old_kept, p.order_by, p.limit, p.offset, tick, nl)
        out = consolidate(UpdateBatch.concat(new_window, negate(old_window)))
        state_delta = consolidate(UpdateBatch.concat(new_kept, negate(_retime(old_kept, tick))))
        self.out_arr.insert(state_delta)
        return out, errs

    def compact(self, since):
        self.out_arr.compact(since)

    def state_info(self):
        a = self.out_arr
        return [("monotonic_topk_winners", len(a.batches), a.total_cap(), a.count())]


class TemporalFilterNode(Node):
    """Validity windows: emit +row when its window opens, -row when it closes.

    Future events wait in a pending batch whose times are the events' times;
    every tick flushes the events due by then. Runs every tick, with or
    without input: the passage of time alone retracts expired rows. Event
    times come from data, so they clamp into [0, MAX_DEVICE_TIME] (int64
    here, u32 in the reference): a huge bound saturates at "effectively
    forever" and can never reach PAD_TIME, which means "no expiry".
    """

    def __init__(self, expr):
        self.lowers = tuple(expr.lowers)
        self.uppers = tuple(expr.uppers)
        self.pending: Optional[UpdateBatch] = None

    @staticmethod
    def _event_time(v: torch.Tensor) -> torch.Tensor:
        if v.dtype.is_floating_point:
            v = v.clamp(0, MAX_DEVICE_TIME).to(torch.int64)
        return v.to(torch.int64).clamp(0, MAX_DEVICE_TIME)

    def _windows(self, batch: UpdateBatch):
        from ..expr.scalar import eval_expr

        cols = list(batch.vals)
        n = batch.cap
        dev = batch.device
        start = torch.zeros((n,), dtype=torch.int64, device=dev)
        for e in self.lowers:
            v, _err = eval_expr(e, cols, n)
            start = torch.maximum(start, self._event_time(v))
        end = torch.full((n,), PAD_TIME, dtype=torch.int64, device=dev)
        for e in self.uppers:
            v, _err = eval_expr(e, cols, n)
            end = torch.minimum(end, self._event_time(v))
        # a row's events: +d at max(start, row time), -d at end (if finite)
        return torch.maximum(start, batch.times), end

    def step(self, tick, ins):
        errs = None
        d = ins[0] if ins else None
        if d is not None:
            oks, errs = d
            if oks is not None:
                start, end = self._windows(oks)
                live = oks.live & (start < end)
                plus = UpdateBatch(
                    torch.where(live, oks.hashes, PAD_HASH), oks.keys, oks.vals,
                    torch.where(live, start, PAD_TIME), torch.where(live, oks.diffs, 0))
                has_end = live & (end != PAD_TIME)
                minus = UpdateBatch(
                    torch.where(has_end, oks.hashes, PAD_HASH), oks.keys, oks.vals,
                    torch.where(has_end, end, PAD_TIME), torch.where(has_end, -oks.diffs, 0))
                events = UpdateBatch.concat(plus, minus)
                self.pending = (events if self.pending is None
                                else UpdateBatch.concat(self.pending, events))
        if self.pending is None:
            return None if errs is None else (None, errs)
        # flush the events due at or before this tick
        p = self.pending
        due = p.live & (p.times <= device_time_scalar(tick))
        if host_int(due.sum()) == 0:
            out = None
        else:
            out = consolidate(UpdateBatch(
                torch.where(due, p.hashes, PAD_HASH), p.keys, p.vals, p.times,
                torch.where(due, p.diffs, 0)))
            remaining = consolidate(UpdateBatch(
                torch.where(due, PAD_HASH, p.hashes), p.keys, p.vals,
                torch.where(due, PAD_TIME, p.times), torch.where(due, 0, p.diffs)))
            n_rem = host_int(remaining.count())
            self.pending = None if n_rem == 0 else remaining.with_capacity(bucket_cap(n_rem))
        if out is None and errs is None:
            return None
        return out, errs

    def state_info(self):
        n = 0 if self.pending is None else int(self.pending.count())
        cap = 0 if self.pending is None else self.pending.cap
        return [("temporal_pending", 1, cap, n)]


class LetRecNode(Node):
    """Iterate bindings to a fixpoint within each outer tick.

    An inner Dataflow hosts the bindings and the body; its private time is
    the iteration counter, so each iteration's work is proportional to the
    change since the previous one. The outer output is the sum of the
    iterations' body deltas, retimed to the tick. Each iteration reads the
    bindings' delta counts on the host to decide convergence.
    """

    def __init__(self, expr, device):
        self.expr = expr
        self.rec_ids = [b[0] for b in expr.bindings]
        self.external_ids = list(expr.external_ids)
        self.max_iters = expr.max_iters
        src = {gid: dts for gid, dts in expr.ext_dtypes}
        for gid, _plan, dts in expr.bindings:
            src[gid] = dts
        builds = [lir.BuildDesc(gid, plan, dts) for gid, plan, dts in expr.bindings]
        builds.append(lir.BuildDesc("__letrec_body__", expr.body, expr.body_dtypes))
        desc = lir.DataflowDescription(source_imports=src, objects_to_build=builds,
                                       index_exports={})
        self.inner = Dataflow(desc, device=device)
        self.inner_time = 0
        self.started = False

    def step(self, tick, ins):
        ext: dict = {}
        errs_parts = []
        for eid, d in zip(self.external_ids, ins):
            if d is None:
                continue
            if d[0] is not None:
                ext[eid] = d[0]
            if d[1] is not None:
                errs_parts.append(d[1])
        if not ext and self.started:
            return None if not errs_parts else (None, _union(errs_parts))
        self.started = True

        acc_out = []
        deltas = dict(ext)
        for _it in range(self.max_iters):
            self.inner_time += 1
            results = self.inner.step(self.inner_time, deltas)
            deltas = {}
            converged = True
            for rec_id in self.rec_ids:
                d = results.get(rec_id)
                if d is None:
                    continue
                if d[1] is not None and host_int(d[1].count()) > 0:
                    errs_parts.append(_retime(d[1], tick))
                if d[0] is not None and host_int(d[0].count()) > 0:
                    deltas[rec_id] = d[0]
                    converged = False
            body = results.get("__letrec_body__")
            if body is not None:
                if body[0] is not None:
                    acc_out.append(body[0])
                if body[1] is not None and host_int(body[1].count()) > 0:
                    errs_parts.append(_retime(body[1], tick))
            if converged:
                break
        else:
            raise RuntimeError(
                f"WITH MUTUALLY RECURSIVE did not converge in {self.max_iters} iterations"
            )
        out = _union([_retime(b, tick) for b in acc_out]) if acc_out else None
        errs = _union(errs_parts) if errs_parts else None
        if out is None and errs is None:
            return None
        return out, errs

    def state_info(self):
        return [
            (f"letrec:{name}", nb, cap, rec)
            for _obj, _op, name, nb, cap, rec, _b in self.inner.arrangement_info()
        ]


def peek_row_key(row: tuple) -> tuple:
    """The canonical peek output order (NULLs last in each column)."""
    return tuple((v is None, 0 if v is None else v) for v in row)


def row_bytes_estimate(data: tuple) -> int:
    """Rough wire size of one result row, the unit of max_result_size
    budgets: tuple overhead + 8 B a column, plus the payload of string and
    bytes values."""
    n = 16 + 8 * len(data)
    for v in data:
        if isinstance(v, (str, bytes)):
            n += len(v)
    return n


def materialize_counts(acc: dict, label: str, byte_budget: int | None = None) -> list[tuple]:
    """Expand {row: multiplicity} into rows in peek order. A negative
    multiplicity means upstream inconsistency and raises. `byte_budget`
    bounds the expansion itself: past it, ResultSizeExceeded (53400) is
    raised mid-expansion, before the whole result exists."""
    from ..errors import ResultSizeExceeded

    rows: list[tuple] = []
    spent = 0
    for data, cnt in sorted(acc.items(), key=lambda kv: peek_row_key(kv[0])):
        if cnt < 0:
            raise RuntimeError(f"peek {label}: negative multiplicity {cnt} for {data}")
        if byte_budget is not None and cnt:
            spent += row_bytes_estimate(data) * cnt
            if spent > byte_budget:
                raise ResultSizeExceeded(
                    f"result exceeds max_result_size ({byte_budget} bytes); "
                    f"aborted after ~{len(rows)} rows"
                )
        rows.extend([data] * cnt)
    return rows


def peek_error_message(index_id: str, acc: dict) -> str:
    """Message for a non-empty error collection: the EvalErr names of the
    error rows' codes, sorted."""
    from ..expr.scalar import EvalErr

    def _msg(data):
        try:
            return EvalErr(int(data[0])).name.lower().replace("_", " ")
        except (ValueError, TypeError, IndexError):
            return str(data)

    msgs = sorted({_msg(d) for d, v in acc.items() if v > 0})
    return f"peek {index_id}: error: {'; '.join(msgs)}"


def _retime(batch: UpdateBatch, tick: int) -> UpdateBatch:
    """Overwrite live rows' times with the outer tick (iteration times are
    private to the scope)."""
    return UpdateBatch(batch.hashes, batch.keys, batch.vals,
                       torch.where(batch.live, device_time_scalar(tick), batch.times),
                       batch.diffs)


# -- arrangement byte accounting -----------------------------------------------


def batch_nbytes(b) -> int:
    n = 0
    for attr in ("hashes", "times", "diffs"):
        v = getattr(b, attr, None)
        if v is not None:
            n += int(getattr(v, "nbytes", 0))
    for attr in ("keys", "vals"):
        for col in getattr(b, attr, ()) or ():
            n += int(getattr(col, "nbytes", 0))
    return n


def arrangement_nbytes(arr) -> int:
    return sum(batch_nbytes(b) for b in arr.batches)


def accum_state_nbytes(st) -> int:
    n = 0
    for attr in ("hashes", "times"):
        v = getattr(st, attr, None)
        if v is not None:
            n += int(getattr(v, "nbytes", 0))
    for attr in ("keys", "accums", "vals"):
        for col in getattr(st, attr, ()) or ():
            n += int(getattr(col, "nbytes", 0))
    return n


def _shared_handle_nbytes(h) -> int:
    """Bytes to report for a shared trace handle: importers 0 (the exporter
    owns the memory), exporters the trace's arrangement (SharedTrace) or
    accumulator and output arrangement (SharedReduceTrace)."""
    if h.imported:
        return 0
    tr = h.trace
    arr = getattr(tr, "arr", None)
    if arr is not None:
        return arrangement_nbytes(arr)
    return accum_state_nbytes(tr.state) + arrangement_nbytes(tr.out_arr)


def _node_state_bytes(node, rows: list) -> list:
    """Byte counts of one node's state_info rows, aligned with `rows`. The
    port's hashes and times take 8 B a row (4 B in the reference)."""
    if isinstance(node, (SharedArrangeNode, SharedReduceNode)):
        return [_shared_handle_nbytes(node.h)]
    if isinstance(node, ArrangeByNode):
        return [arrangement_nbytes(node.arr)]
    if isinstance(node, LinearJoinNode):
        out = []
        for (left, right), (lh, rh) in zip(node.state, node.shared):
            out.append(arrangement_nbytes(left) if left is not None else _shared_handle_nbytes(lh))
            out.append(arrangement_nbytes(right) if right is not None
                       else _shared_handle_nbytes(rh))
        return out
    if isinstance(node, DeltaJoinNode):
        return [arrangement_nbytes(a) for a in node.arrs.values()] + [
            _shared_handle_nbytes(h) for h in node.shared.values()]
    if isinstance(node, (ReduceNode, FusedMfpReduceNode, DistinctNode, ThresholdNode)):
        return [accum_state_nbytes(node.state)]
    if isinstance(node, BasicAggNode):
        # host dicts are uncharged; the rendered-bytes row's record count is
        # its byte figure
        return [0] + [r[3] for r in rows[1:]]
    if isinstance(node, (WindowNode, TopKNode)):
        return [arrangement_nbytes(node.arr)]
    if isinstance(node, MonotonicTopKNode):
        return [arrangement_nbytes(node.out_arr)]
    if isinstance(node, TemporalFilterNode):
        return [0 if node.pending is None else batch_nbytes(node.pending)]
    if isinstance(node, LetRecNode):
        return [b for *_rest, b in node.inner.arrangement_info()]
    return [0] * len(rows)


# ---------------------------------------------------------------------------
# dataflow
# ---------------------------------------------------------------------------


class Dataflow:
    """A rendered dataflow: drive with `step`, read indexes with `peek`.

    Each tick flows the source deltas through the operator graph in
    dependency order, updates the exported index traces and advances the
    frontier. `device` holds every tensor of the dataflow (the sources'
    batches must lie there too).
    """

    def __init__(self, desc: lir.DataflowDescription, shard=None, traces=None,
                 trace_reader: str | None = None, trace_export: bool = True,
                 operator_logging: bool = False, device="cuda"):
        if shard is not None:
            raise NotImplementedError(
                "Dataflow(shard=...): the sharded replica's exchange (ShardContext, "
                "ExchangeNode over parallel/netexchange.py and cluster/mesh.py) is not "
                "ported yet")
        # `traces`: a TraceManager. Stateful operators over imported
        # collections import a matching shared trace when one exists, else
        # build and export one; every use registers `trace_reader`'s since
        # hold at desc.as_of. `trace_export=False` (one-shot peek dataflows)
        # imports only: a trace exported by a dataflow that dies after one
        # tick would go stale at once.
        self.traces = traces
        self._trace_reader = trace_reader
        self._trace_export = trace_export
        self._trace_handles: dict = {}
        self.device = torch.device(device)
        self.desc = desc
        self.has_temporal = False  # temporal filters need stepping every tick
        self.builds: list = []  # (obj_id, [(node, input_refs)], out_ref)
        self.dtypes: dict[str, tuple] = {}
        for sid, dts in desc.source_imports.items():
            self.dtypes[sid] = tuple(dts)
        for bd in desc.objects_to_build:
            ops: list = []
            self._memo: dict = {}
            out_ref = self._render(bd.plan, ops)
            self.builds.append((bd.id, ops, out_ref))
            self.dtypes[bd.id] = tuple(bd.dtypes)
        self.index_traces: dict[str, Arrangement] = {}
        self.index_errs: dict[str, Arrangement] = {}
        for idx_id, (_obj_id, key_cols) in desc.index_exports.items():
            self.index_traces[idx_id] = Arrangement(key_cols=tuple(key_cols), device=device)
            self.index_errs[idx_id] = Arrangement(key_cols=(), device=device)
        self.sink_outputs: dict[str, list] = {s: [] for s in desc.sink_exports}
        self._frontier = Antichain.of(desc.as_of)
        self._last_complete = desc.as_of - 1
        # `until`: outputs at times >= until are not needed; empty = unbounded
        self.until = Antichain.of(desc.until) if desc.until is not None else EMPTY
        # (obj_id, op_idx) -> {type, elapsed_ns, invocations[, rows_in, rows_out]};
        # row counts need a device read a delta, so only with operator_logging
        self.metrics: dict = {}
        self.operator_logging = operator_logging
        # cooperative cancellation: when set (one-shot peek dataflows), runs
        # between operator dispatches and raises QueryCanceled once the
        # statement's deadline passed or a cancel landed
        self.cancel_check = None

    # -- frontier ----------------------------------------------------------
    @property
    def frontier(self) -> int:
        """Scalar view of the write frontier (u64 max when complete)."""
        return self._frontier.as_scalar((1 << 64) - 1)

    @frontier.setter
    def frontier(self, tick: int) -> None:
        """Advance the frontier; crossing `until` closes the dataflow (the
        frontier becomes the EMPTY antichain)."""
        self._last_complete = max(self._last_complete, int(tick) - 1)
        if self.until and self.until.less_equal(int(tick)):
            self._frontier = EMPTY
        else:
            self._frontier = Antichain.of(int(tick))

    def is_complete(self) -> bool:
        """True once the frontier is empty: no future update can appear."""
        return self._frontier.is_empty()

    # -- introspection -----------------------------------------------------
    def operator_info(self) -> list:
        """[(obj_id, op_idx, type, elapsed_ns, invocations)] per operator."""
        out = []
        for obj_id, ops, _ref in self.builds:
            for op_i, (node, _ins) in enumerate(ops):
                m = self.metrics.get((obj_id, op_i), {})
                out.append((obj_id, op_i, type(node).__name__, m.get("elapsed_ns", 0),
                            m.get("invocations", 0)))
        return out

    def operator_rates(self) -> list:
        """[(obj_id, op_idx, type, rows_in, rows_out, retries)]; row counts
        only while `operator_logging` is on, retries always 0 here."""
        out = []
        for obj_id, ops, _ref in self.builds:
            for op_i, (node, _ins) in enumerate(ops):
                m = self.metrics.get((obj_id, op_i), {})
                out.append((obj_id, op_i, type(node).__name__, m.get("rows_in", 0),
                            m.get("rows_out", 0), m.get("retries", 0)))
        return out

    def arrangement_info(self) -> list:
        """[(obj_id, op_idx, name, batches, capacity, records, bytes)]; index
        traces report as pseudo-operators at op_idx -1."""
        out = []
        for obj_id, ops, _ref in self.builds:
            for op_i, (node, _ins) in enumerate(ops):
                rows = node.state_info()
                nbytes = _node_state_bytes(node, rows)
                for (name, nb, cap, rec), b in zip(rows, nbytes):
                    out.append((obj_id, op_i, name, nb, cap, int(rec), int(b)))
        for kind, spines in (("index_trace", self.index_traces), ("index_errs", self.index_errs)):
            for idx_id, arr in spines.items():
                out.append((idx_id, -1, kind, len(arr.batches), arr.total_cap(),
                            int(arr.count()), arrangement_nbytes(arr)))
        return out

    # -- rendering ---------------------------------------------------------
    def _render(self, expr, ops: list):
        """Append (node, input_refs) entries; return a ref (int = op index,
        str = imported or built id). A plan subtree referenced from several
        places renders once and is shared by ref."""
        hit = self._memo.get(id(expr))
        if hit is not None:
            return hit
        ref = self._render_new(expr, ops)
        self._memo[id(expr)] = ref
        return ref

    def _shareable_gid(self, expr):
        """The collection id of `expr` when it can be shared, else None:
        only imported collection ids are stable across dataflows."""
        if self.traces is None or not isinstance(expr, lir.Get):
            return None
        return expr.id if expr.id in self.desc.source_imports else None

    def _shared_handle(self, key: tuple, getter):
        """Memoized TraceHandle for trace `key` (one a dataflow a key), or
        None when the manager has nothing usable. Peek renders
        (trace_export=False) get trusted handles: only a live coordinator
        may read a trace at the importer's as_of."""
        from ..arrangement.trace_manager import TraceHandle

        hit = self._trace_handles.get(key)
        if hit is not None:
            return hit
        tr, imported = getter()
        if tr is None:
            return None
        h = TraceHandle(tr, imported, self.desc.as_of, trusted=not self._trace_export)
        self._trace_handles[key] = h
        return h

    def _shared_arrangement(self, expr, key_cols: tuple):
        """TraceHandle for an arrangement of `expr` by `key_cols`, or None."""
        from ..arrangement.trace_manager import TraceManager

        gid = self._shareable_gid(expr)
        if gid is None:
            return None
        return self._shared_handle(
            TraceManager.arrangement_key(gid, tuple(key_cols)),
            lambda: self.traces.get_arrangement(
                gid, tuple(key_cols), self._trace_reader, self.desc.as_of,
                export=self._trace_export, device=self.device),
        )

    def _shared_reduce(self, e: lir.Reduce, in_dtypes: tuple):
        """TraceHandle for a shared accumulable reduce over a Get, or None."""
        from ..arrangement.trace_manager import TraceManager

        gid = self._shareable_gid(e.input)
        if gid is None:
            return None
        return self._shared_handle(
            TraceManager.reduce_key(gid, e.key_cols, e.aggs),
            lambda: self.traces.get_reduce(
                gid, e.key_cols, e.aggs, in_dtypes, self._trace_reader, self.desc.as_of,
                export=self._trace_export, device=self.device),
        )

    def _add(self, ops: list, node: Node, refs: list) -> int:
        ops.append((node, refs))
        return len(ops) - 1

    def _render_new(self, e, ops: list):
        dev = self.device
        if isinstance(e, lir.Get):
            return e.id
        if isinstance(e, lir.Constant):
            return self._add(ops, ConstantNode(e, dev), [])
        if isinstance(e, lir.Mfp):
            return self._add(ops, MfpNode(e.mfp), [self._render(e.input, ops)])
        if isinstance(e, lir.Negate):
            return self._add(ops, NegateNode(), [self._render(e.input, ops)])
        if isinstance(e, lir.Union):
            return self._add(ops, UnionNode(), [self._render(i, ops) for i in e.inputs])
        if isinstance(e, lir.ArrangeBy):
            h = self._shared_arrangement(e.input, e.key_cols)
            ref = self._render(e.input, ops)
            if h is not None:
                return self._add(ops, SharedArrangeNode(h, e.key_cols), [ref])
            return self._add(ops, ArrangeByNode(e.key_cols, dev), [ref])
        if isinstance(e, lir.Join):
            refs = [self._render(i, ops) for i in e.inputs]
            if isinstance(e.plan, lir.LinearJoinPlan):
                shared = [
                    (self._shared_arrangement(e.inputs[0], st.stream_key) if si == 0 else None,
                     self._shared_arrangement(e.inputs[si + 1], st.lookup_key))
                    for si, st in enumerate(e.plan.stages)
                ]
                return self._add(ops, LinearJoinNode(e.plan, e.closure, dev, shared), refs)
            shared = {}
            for path in e.plan.paths:
                for st in path:
                    key = (st.other_input, st.lookup_key)
                    if key in shared:
                        continue
                    h = self._shared_arrangement(e.inputs[st.other_input], st.lookup_key)
                    if h is not None:
                        shared[key] = h
            return self._add(ops, DeltaJoinNode(e.plan, e.closure, dev, shared), refs)
        if isinstance(e, lir.Reduce):
            from ..expr.scalar import expr_has_dictfunc

            in_dt = self._infer_dtypes(e.input)
            if (
                not e.distinct
                and isinstance(e.input, lir.Mfp)
                and all(a.func in ("sum", "count") for a in e.aggs)
                # string-function MFPs keep their own node (host tables)
                and not any(expr_has_dictfunc(x) for x in
                            list(e.input.mfp.map_exprs) + list(e.input.mfp.predicates))
            ):
                # fuse the feeding MFP into the reduce step
                ref = self._render(e.input.input, ops)
                return self._add(ops, FusedMfpReduceNode(e.input.mfp, e, in_dt, dev), [ref])
            ref = self._render(e.input, ops)
            if e.distinct:
                return self._add(ops, DistinctNode(e.key_cols, in_dt, dev), [ref])
            h = self._shared_reduce(e, in_dt)
            if h is not None:
                return self._add(ops, SharedReduceNode(h), [ref])
            return self._add(ops, ReduceNode(e, in_dt, dev), [ref])
        if isinstance(e, lir.BasicAgg):
            ref = self._render(e.input, ops)
            return self._add(ops, BasicAggNode(e, self._infer_dtypes(e.input), dev), [ref])
        if isinstance(e, lir.Threshold):
            ref = self._render(e.input, ops)
            return self._add(ops, ThresholdNode(self._infer_dtypes(e.input), dev), [ref])
        if isinstance(e, lir.TopK):
            ref = self._render(e.input, ops)
            if e.monotonic and e.plan.limit is not None:
                return self._add(ops, MonotonicTopKNode(e.plan, dev), [ref])
            return self._add(ops, TopKNode(e.plan, dev), [ref])
        if isinstance(e, lir.Window):
            return self._add(ops, WindowNode(e.plan, dev), [self._render(e.input, ops)])
        if isinstance(e, lir.LetRec):
            return self._add(ops, LetRecNode(e, dev), list(e.external_ids))
        if isinstance(e, lir.TemporalFilter):
            ref = self._render(e.input, ops)
            self.has_temporal = True
            return self._add(ops, TemporalFilterNode(e), [ref])
        if isinstance(e, lir.FlatMap):
            return self._add(ops, FlatMapNode(e), [self._render(e.input, ops)])
        raise NotImplementedError(f"render: {type(e).__name__}")

    def _infer_dtypes(self, e) -> tuple:
        """Column dtypes of a plan expression (for state initialization)."""
        if isinstance(e, lir.Get):
            return self.dtypes[e.id]
        if isinstance(e, lir.Constant):
            return tuple(e.dtypes)
        if isinstance(e, lir.Mfp):
            cols = list(self._infer_dtypes(e.input))
            for m in e.mfp.map_exprs:
                cols.append(_expr_dtype(m, cols))
            if e.mfp.projection is not None:
                cols = [cols[i] for i in e.mfp.projection]
            return tuple(cols)
        if isinstance(e, (lir.Negate, lir.Threshold, lir.ArrangeBy, lir.TopK,
                          lir.TemporalFilter)):
            return self._infer_dtypes(e.input)
        if isinstance(e, lir.Union):
            return self._infer_dtypes(e.inputs[0])
        if isinstance(e, lir.Window):
            return self._infer_dtypes(e.input) + tuple(np.dtype(f.out_dtype)
                                                       for f in e.plan.funcs)
        if isinstance(e, lir.Reduce):
            ins = self._infer_dtypes(e.input)
            keys = tuple(ins[i] for i in e.key_cols)
            if e.distinct:
                return keys
            return keys + tuple(agg_out_dtype(a) for a in e.aggs)
        if isinstance(e, lir.BasicAgg):
            ins = self._infer_dtypes(e.input)
            return tuple(ins[i] for i in e.key_cols) + (np.dtype(np.int64),)
        if isinstance(e, lir.Join):
            cols = []
            for i in e.inputs:
                cols.extend(self._infer_dtypes(i))
            if e.closure is not None and e.closure.projection is not None:
                base = list(cols)
                for m in e.closure.map_exprs:
                    base.append(_expr_dtype(m, base))
                cols = [base[i] for i in e.closure.projection]
            return tuple(cols)
        if isinstance(e, lir.LetRec):
            return tuple(e.body_dtypes)
        if isinstance(e, lir.FlatMap):
            return self._infer_dtypes(e.input) + (np.dtype(np.int64),)
        raise NotImplementedError(f"dtypes: {type(e).__name__}")

    # -- execution ---------------------------------------------------------
    def step(self, tick: int, source_deltas: dict) -> dict:
        """Advance to `tick`, flowing the given source deltas through the
        graph. Returns {object id: (oks delta, errs delta) or None}."""
        env: dict = {sid: (batch, None) for sid, batch in source_deltas.items()}
        results: dict = {}
        for obj_id, ops, out_ref in self.builds:
            slots: list = []
            for op_i, (node, in_refs) in enumerate(ops):
                if self.cancel_check is not None:
                    self.cancel_check()
                ins = [(env.get(r) if isinstance(r, str) else slots[r]) for r in in_refs]
                t0 = _time.perf_counter_ns()
                with _prof.named_scope(f"mzt:{type(node).__name__}"):
                    slots.append(node.step(tick, ins))
                m = self.metrics.setdefault(
                    (obj_id, op_i),
                    {"type": type(node).__name__, "elapsed_ns": 0, "invocations": 0},
                )
                m["elapsed_ns"] += _time.perf_counter_ns() - t0
                m["invocations"] += 1
                if self.operator_logging:
                    rin = sum(host_int(d[0].count()) for d in ins
                              if d is not None and d[0] is not None)
                    out_d = slots[-1]
                    rout = host_int(out_d[0].count()) if out_d is not None \
                        and out_d[0] is not None else 0
                    m["rows_in"] = m.get("rows_in", 0) + rin
                    m["rows_out"] = m.get("rows_out", 0) + rout
            out = env.get(out_ref) if isinstance(out_ref, str) else slots[out_ref]
            if self.until and out is not None:
                u = self.until.elements[0]
                out = (_truncate_until(out[0], u), _truncate_until(out[1], u))
            env[obj_id] = out
            results[obj_id] = out
        for idx_id, (obj_id, _k) in self.desc.index_exports.items():
            d = results.get(obj_id)
            if d is not None:
                oks, errs = d
                if oks is not None:
                    self.index_traces[idx_id].insert(oks)
                if errs is not None:
                    self.index_errs[idx_id].insert(errs)
        for sink_id, obj_id in self.desc.sink_exports.items():
            d = results.get(obj_id)
            if d is not None and d[0] is not None:
                self.sink_outputs[sink_id].append((tick, d[0]))
        self.frontier = tick + 1
        return results

    def peek(self, index_id: str, at: Optional[int] = None,
             byte_budget: int | None = None) -> list[tuple]:
        """Snapshot read of an exported index at time `at` (default: the
        latest complete time). A read below `since` would be silently
        partial and one at or past the write frontier incomplete: both
        raise."""
        if at is None:
            at = self._last_complete if self._frontier.is_empty() else self.frontier - 1
        since = self.index_traces[index_id].since
        if at < since:
            raise RuntimeError(
                f"peek at time {at} is below the since frontier {since}: "
                "that history has been compacted away"
            )
        if self._frontier and at >= self.frontier:
            raise RuntimeError(
                f"peek at time {at} is not beyond the write frontier "
                f"{self.frontier}: the result would be incomplete"
            )
        acc: dict = {}
        for data, _t, d in self.index_errs[index_id].rows_host(at):
            acc[data] = acc.get(data, 0) + d
        if any(v > 0 for v in acc.values()):
            raise RuntimeError(peek_error_message(index_id, acc))
        out: dict = {}
        for data, _t, d in self.index_traces[index_id].rows_host(at):
            out[data] = out.get(data, 0) + d
        return materialize_counts(out, index_id, byte_budget=byte_budget)

    def compact(self, since: int) -> None:
        for _obj, ops, _ref in self.builds:
            for node, _ins in ops:
                node.compact(since)
        for arr in self.index_traces.values():
            arr.compact(since)
        for arr in self.index_errs.values():
            arr.compact(since)
        if self.traces is not None and self._trace_reader is not None:
            # advance this reader's since holds; each shared trace compacts
            # to the minimum over its remaining holds
            self.traces.downgrade(self._trace_reader, since)


def _truncate_until(b: Optional[UpdateBatch], until: int) -> Optional[UpdateBatch]:
    """Suppress updates at times >= until. Rows keep their slots with diff 0
    and the PAD hash."""
    if b is None:
        return None
    # `until` is a u64-domain bound: clamp to PAD_TIME, so an unbounded
    # until keeps every live row
    keep = b.times < min(int(until), PAD_TIME)
    return UpdateBatch(torch.where(keep, b.hashes, PAD_HASH), b.keys, b.vals,
                       torch.where(keep, b.times, PAD_TIME), torch.where(keep, b.diffs, 0))


def _expr_dtype(expr, col_dtypes):
    """Static result dtype of a scalar expr given input column dtypes (numpy
    promotion, as the reference infers it)."""
    from ..expr import scalar as s

    if isinstance(expr, s.Column):
        return np.dtype(col_dtypes[expr.index])
    if isinstance(expr, s.Literal):
        return np.dtype(expr.dtype)
    if isinstance(expr, s.DictFunc):
        return np.dtype(np.int8) if expr.out == "bool" else np.dtype(np.int64)
    if isinstance(expr, s.CallUnary):
        if expr.func in ("cast_int64", "extract_year", "extract_month", "extract_day"):
            return np.dtype(np.int64)
        if expr.func in s._DATE_UNARY:
            return np.dtype(np.int64)
        if expr.func in ("cast_int32",):
            return np.dtype(np.int32)
        if expr.func in ("cast_float", "sqrt", "round_half_away"):
            return np.dtype(np.float32)
        if expr.func in s._FLOAT_UNARY:
            return np.dtype(np.float32)
        if expr.func == "is_true":
            return np.dtype(np.bool_)
        if expr.func in ("not", "is_null", "is_not_null"):
            return np.dtype(np.int8)  # stored truth values (nullable bool)
        return _expr_dtype(expr.expr, col_dtypes)
    if isinstance(expr, s.CallBinary):
        if expr.func in ("eq", "ne", "lt", "lte", "gt", "gte", "and", "or"):
            return np.dtype(np.int8)
        return np.promote_types(_expr_dtype(expr.left, col_dtypes),
                                _expr_dtype(expr.right, col_dtypes))
    if isinstance(expr, s.CallVariadic):
        if expr.func in ("and", "or"):
            return np.dtype(np.int8)
        if expr.func == "if":
            return np.promote_types(_expr_dtype(expr.exprs[1], col_dtypes),
                                    _expr_dtype(expr.exprs[2], col_dtypes))
        dts = [_expr_dtype(e, col_dtypes) for e in expr.exprs]
        out = dts[0]
        for d in dts[1:]:
            out = np.promote_types(out, d)
        return out
    raise TypeError(f"not a ScalarExpr: {expr!r}")


def render_dataflow(desc: lir.DataflowDescription, *, fused: bool = False,
                    exchange_backend: str = "auto", mesh=None, caps=None, traces=None,
                    trace_reader: str | None = None, operator_logging: bool = False,
                    snap_rows: int = 0, device="cuda"):
    """Render a DataflowDescription: the one rendering decision point.

    `exchange_backend` (host, device or auto) picks the exchange plane
    through `devicemesh.resolve_exchange_mesh`: the worker mesh to run over
    (`mesh`, or one over every CUDA device), or none. The fused renderer is
    tried when asked for, or when the plane is `device` (the mesh exists
    only inside the fused tick), and the host-orchestrated `Dataflow` takes
    every plan the fused renderer refuses (FusedUnsupported), as in the
    reference; otherwise the plan renders as a `Dataflow`. Both run on
    `device`. `snap_rows` pre-sizes the fused renderer's delta capacity so
    a hydration tick does not climb the doubling retries.
    """
    from ..parallel.devicemesh import resolve_exchange_mesh

    dmesh = resolve_exchange_mesh(exchange_backend, mesh, device)
    if fused or exchange_backend == "device":
        from .fused import FusedDataflow, FusedUnsupported

        try:
            df = FusedDataflow(desc, caps=caps, mesh=dmesh, traces=traces,
                               operator_logging=operator_logging, device=device)
            if snap_rows:
                df.ensure_delta_capacity(int(snap_rows))
            return df
        except FusedUnsupported:
            pass
    return Dataflow(desc, traces=traces, trace_reader=trace_reader,
                    operator_logging=operator_logging, device=device)
