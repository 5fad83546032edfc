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
`fused_state_leaves` and `load_fused_state` carry a `FusedDataflow`'s state
either way, on a mesh or off it.

`load_dataflow(dst, src)` carries the state of a host-rendered JAX
`runtime.Dataflow` into a port `Dataflow` rendered from the same
description: every node's arrangements, accumulator tables, temporal
pending batch and host state (basic aggregates' multisets, a LetRec's inner
dataflow and iteration clock), the index and error traces, the frontier,
`since` and the operator metrics. It reads the JAX objects by duck typing
(their attributes and class names); their arrays convert through
`np.asarray`.

Dataflows rendered with shared arrangements (`traces=`) carry across in
two steps: render the port dataflows against a port `TraceManager` in the
order the JAX ones were rendered (so the same traces are exported and
imported), then `load_trace_manager(dst_tm, src_tm)` fills every shared
trace with the JAX one's contents, holds, frontier and staged delta, and
`load_dataflow` carries each dataflow's own state and its trace handles'
staged hydration batches.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from .arrangement.lsm import LsmAccums, LsmBatches
from .models.fused_q3 import Q3State
from .ops.reduce import AccumState
from .repr.batch import UpdateBatch

# host-renderer node state, by node class: the attributes `load_dataflow`
# carries (every other attribute is plan, fixed at render time)
_NODE_STATE = {
    "ConstantNode": ("emitted",),
    "ArrangeByNode": ("arr",),
    "LinearJoinNode": ("state",),
    "DeltaJoinNode": ("arrs",),
    "ReduceNode": ("state",),
    "FusedMfpReduceNode": ("state", "state_cap"),
    "BasicAggNode": ("groups", "current"),
    "DistinctNode": ("state",),
    "ThresholdNode": ("state",),
    "TopKNode": ("arr",),
    "WindowNode": ("arr",),
    "MonotonicTopKNode": ("out_arr",),
    "TemporalFilterNode": ("pending",),
    "LetRecNode": ("inner_time", "started"),
}

# shared-trace state, by trace class: the attributes `load_trace_manager`
# carries
_TRACE_STATE = {
    "SharedTrace": ("arr", "delta", "frontier"),
    "SharedReduceTrace": ("state", "out_arr", "err_arr", "frontier", "cached"),
}


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


def fused_state_leaves(df) -> list[np.ndarray]:
    """A port `FusedDataflow`'s state as the JAX package's leaves: on a mesh
    the workers' leaves joined on axis 0 (the JAX global arrays)."""
    if df.mesh is None:
        return to_numpy(df.state)
    return join_leaves([to_numpy(s) for s in df.state])


def load_fused_state(df, leaves) -> None:
    """Set port `FusedDataflow` `df`'s state, at its current scale, from a
    JAX `FusedDataflow`'s state leaves; on a mesh they split on axis 0
    into the workers' states, each on its worker's device."""
    tmpl = df._tiled_template()
    if df.mesh is None:
        df.state = from_numpy(tmpl, leaves, device=df.device)
        return
    parts = split_leaves(leaves, df.n_shards)
    df.state = tuple(from_numpy(t, p, device=d) for t, p, d in zip(tmpl, parts, df.mesh))


def _tensor(a, u32: bool, device) -> torch.Tensor:
    a = np.asarray(a)
    if u32 != (a.dtype == np.uint32):
        raise TypeError(f"leaf dtype {a.dtype} does not match the port's layout")
    return torch.tensor(a.astype(np.int64) if u32 else a, device=device)


def _carry(v, device):
    """A port object holding the value of JAX host-renderer state `v`."""
    from .arrangement.spine import Arrangement
    from .dataflow.antichain import Antichain

    kind = type(v).__name__
    if v is None or isinstance(v, (int, float)):
        return v
    if kind == "UpdateBatch":
        return UpdateBatch(_tensor(v.hashes, True, device),
                           tuple(_tensor(k, False, device) for k in v.keys),
                           tuple(_tensor(c, False, device) for c in v.vals),
                           _tensor(v.times, True, device), _tensor(v.diffs, False, device))
    if kind == "AccumState":
        return AccumState(_tensor(v.hashes, True, device),
                          tuple(_tensor(k, False, device) for k in v.keys),
                          tuple(_tensor(a, False, device) for a in v.accums),
                          _tensor(v.nrows, False, device))
    if kind == "Arrangement":
        return Arrangement(key_cols=tuple(v.key_cols),
                           batches=[_carry(b, device) for b in v.batches],
                           since=int(v.since), holds=dict(v.holds), device=device)
    if kind == "Antichain":
        return Antichain(tuple(int(t) for t in v.elements))
    if isinstance(v, dict):  # keys are host values (group keys, reader names)
        return {k: _carry(x, device) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_carry(x, device) for x in v)
    raise TypeError(f"cannot carry {kind}")


def load_dataflow(dst, src) -> None:
    """Load JAX `runtime.Dataflow` `src`'s state into port Dataflow `dst`
    (rendered from the same description, on its own device)."""
    dev = dst.device
    if len(dst.builds) != len(src.builds):
        raise ValueError("the two dataflows render different descriptions")
    for (d_id, d_ops, _r), (s_id, s_ops, _s) in zip(dst.builds, src.builds):
        if d_id != s_id or len(d_ops) != len(s_ops):
            raise ValueError(f"object {d_id} renders differently")
        for (dn, _di), (sn, _si) in zip(d_ops, s_ops):
            name = type(dn).__name__
            if name != type(sn).__name__:
                raise ValueError(f"node {name} against {type(sn).__name__}")
            for attr in _NODE_STATE.get(name, ()):
                setattr(dn, attr, _carry(getattr(sn, attr), dev))
            if name == "BasicAggNode":
                # the rendered values are codes of the node's dictionary
                dn.dct._strs[:] = list(sn.dct._strs)
                dn.dct._code.clear()
                dn.dct._code.update(sn.dct._code)
            if name == "LetRecNode":
                load_dataflow(dn.inner, sn.inner)
    for key, h in getattr(src, "_trace_handles", {}).items():
        dst._trace_handles[key]._hyd = _carry(h._hyd, dev)
    for spines in ("index_traces", "index_errs"):
        setattr(dst, spines, {k: _carry(a, dev) for k, a in getattr(src, spines).items()})
    dst._frontier = _carry(src._frontier, dev)
    dst._last_complete = int(src._last_complete)
    dst.metrics = {k: dict(m) for k, m in src.metrics.items()}


def load_trace_manager(dst, src, device="cuda") -> None:
    """Load JAX `TraceManager` `src`'s shared traces into port manager
    `dst`, whose traces were exported by port dataflows rendered from the
    same descriptions in the same order. Each trace is filled in place (the
    port dataflows' handles keep pointing at it); the counters are copied."""
    if set(dst.traces) != set(src.traces):
        raise ValueError("the two managers share different traces")
    for key, st in src.traces.items():
        dt = dst.traces[key]
        kind = type(st).__name__
        if kind != type(dt).__name__:
            raise ValueError(f"trace {key}: {kind} against {type(dt).__name__}")
        for attr in _TRACE_STATE[kind]:
            setattr(dt, attr, _carry(getattr(st, attr), device))
        dt.exporter = st.exporter
    dst.stats = dict(src.stats)
    dst.epoch = src.epoch
