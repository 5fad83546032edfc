"""Shared arrangements (arrangement/trace_manager.py) in the port's host
renderer against the JAX package's, tick by tick, byte for byte.

Two dataflows in each package read one seeded pair of sources through one
TraceManager: the first exports a shared accumulable reduce, the shared
stream and lookup sides of a linear join and a shared ArrangeBy; the
second, rendered at a later `as_of`, imports them all (its hydration tick
takes the snapshot through the trace handles) and exports one more. After
every tick both packages must agree on every object's oks and errs, every
peek, `arrangement_info`, the operator tables, `sharing_rows`,
`import_hit_rate` and the export/import counters. The ticks also
`downgrade` (compaction), `release` one reader, and `rollback_install` a
third dataflow, which must leave the manager as it was. Both renderers'
choice under `render_dataflow(fused=True, traces=...)` is compared too.

The carry-over: JAX dataflows that shared traces for three ticks are
carried into port dataflows (`interop.load_trace_manager` and
`load_dataflow`), and both packages step three more ticks identically.
"""

import tracemalloc

import numpy as np
import pytest
import torch

from materialize_tpu.arrangement.trace_manager import TraceManager as JTM
from materialize_tpu.dataflow import runtime as JR
from materialize_tpu.repr import UpdateBatch as JB
from materialize_tpu_torch import interop
from materialize_tpu_torch.arrangement.trace_manager import TraceManager as TTM
from materialize_tpu_torch.dataflow import runtime as TR
from materialize_tpu_torch.models import operators as OPS
from materialize_tpu_torch.repr.batch import UpdateBatch as TB
from test_torch_runtime import assert_results, assert_same, to_jax

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


SRC = OPS.SHARED_SOURCES


class Side:
    """One package's manager, dataflows and input history."""

    def __init__(self, jax: bool):
        self.jax = jax
        self.tm = JTM() if jax else TTM()
        self.dfs: dict = {}
        self.hist: dict = {s: [] for s in SRC}

    def batch(self, cols, times, diffs):
        if self.jax:
            return JB.build((), cols, times, diffs)
        return TB.build((), cols, times, diffs, device="cpu")

    def render(self, name, desc, **kw):
        if self.jax:
            return JR.render_dataflow(to_jax(desc), traces=self.tm, trace_reader=name, **kw)
        return TR.render_dataflow(desc, traces=self.tm, trace_reader=name, device="cpu", **kw)

    def install(self, name, desc):
        df = self.render(name, desc)
        self.dfs[name] = df
        return df

    def deltas(self, tick, inputs):
        out = {}
        for src, (cols, diffs) in inputs.items():
            self.hist[src].append((cols, diffs))
            out[src] = self.batch(cols, np.full(len(diffs), tick, np.uint64), diffs)
        return out

    def snapshot(self, as_of):
        """Every source's whole history, at time `as_of` (not consolidated:
        the dataflows consolidate)."""
        out = {}
        for src, parts in self.hist.items():
            cols = tuple(np.concatenate([p[0][i] for p in parts]) for i in range(len(SRC[src])))
            diffs = np.concatenate([p[1] for p in parts])
            out[src] = self.batch(cols, np.full(len(diffs), as_of, np.uint64), diffs)
        return out


def assert_manager(j: Side, t: Side, what: str) -> None:
    assert t.tm.sharing_rows() == j.tm.sharing_rows(), what
    assert t.tm.import_hit_rate() == j.tm.import_hit_rate(), what
    assert t.tm.stats == j.tm.stats, what
    assert t.tm.trace_count() == j.tm.trace_count(), what


def step_both(j: Side, t: Side, tick: int, inputs: dict, names) -> None:
    jd, td = j.deltas(tick, inputs), t.deltas(tick, inputs)
    for name in names:
        assert_results(j.dfs[name].step(tick, jd), t.dfs[name].step(tick, td),
                       f"{name} tick {tick}")
    for name in names:
        assert_same(j.dfs[name], t.dfs[name], f"{name} tick {tick}")
    assert_manager(j, t, f"tick {tick}")


def test_shared_traces_byte_identical():
    _shared_traces()
    _carried_shared_state()
    # the carry refuses managers that share other traces
    j, t = Side(True), Side(False)
    j.install("mv1", OPS.shared_desc("first"))
    t.install("mv1", OPS.shared_desc("third", 1))
    with pytest.raises(ValueError, match="different traces"):
        interop.load_trace_manager(t.tm, j.tm, device="cpu")


def _shared_traces():
    j, t = Side(True), Side(False)
    for side in (j, t):
        side.install("mv1", OPS.shared_desc("first"))
    kinds = {type(n).__name__ for _o, ops, _r in t.dfs["mv1"].builds for n, _i in ops}
    assert {"SharedReduceNode", "SharedArrangeNode", "LinearJoinNode"} <= kinds
    assert_manager(j, t, "rendered")
    ticks = OPS.shared_ticks(7)
    for tick in (1, 2, 3):
        step_both(j, t, tick, ticks[tick - 1], ["mv1"])
    # late import at as_of 3: the second dataflow hydrates from snapshots
    for side in (j, t):
        side.install("mv2", OPS.shared_desc("second", 3))
    assert_manager(j, t, "late import rendered")
    assert t.tm.stats["imports"] >= 3
    jr = j.dfs["mv2"].step(3, j.snapshot(3))
    tr = t.dfs["mv2"].step(3, t.snapshot(3))
    assert_results(jr, tr, "mv2 hydration")
    assert_same(j.dfs["mv2"], t.dfs["mv2"], "mv2 hydration")
    assert_manager(j, t, "mv2 hydration")
    for tick in (4, 5):
        step_both(j, t, tick, ticks[tick - 1], ["mv1", "mv2"])
        for side in (j, t):
            side.dfs["mv1"].compact(tick - 2)
            side.dfs["mv2"].compact(tick - 1)
        assert_manager(j, t, f"downgraded at {tick}")
    # a failed install rolls back to exactly the state before it
    before = t.tm.sharing_rows(), dict(t.tm.stats)
    for side in (j, t):
        side.render("mv3", OPS.shared_desc("third", 5))
    assert_manager(j, t, "mv3 rendered")
    assert t.tm.sharing_rows() != before[0]
    for side in (j, t):
        side.tm.rollback_install("mv3")
    assert_manager(j, t, "rolled back")
    assert (t.tm.sharing_rows(), t.tm.stats) == before
    # releasing the first reader leaves the second one's traces
    for side in (j, t):
        side.tm.release("mv1")
        side.dfs.pop("mv1")
    assert_manager(j, t, "released mv1")
    step_both(j, t, 6, ticks[5], ["mv2"])
    step_both(j, t, 7, ticks[6], ["mv2"])
    # the fused renderer yields to the host one on a shared-trace import in
    # both packages, and renders a plan with nothing to import itself
    for desc in (OPS.shared_desc("first", 7), OPS.shared_desc("fresh", 7)):
        jdf = JR.render_dataflow(to_jax(desc), fused=True, traces=j.tm, trace_reader="f")
        tdf = TR.render_dataflow(desc, fused=True, traces=t.tm, trace_reader="f", device="cpu")
        assert type(tdf).__name__ == type(jdf).__name__
        assert_manager(j, t, f"fused render as {type(tdf).__name__}")


def _carried_shared_state():
    j = Side(True)
    j.install("mv1", OPS.shared_desc("first"))
    j.install("mv2", OPS.shared_desc("second", 1))
    ticks = OPS.shared_ticks(6)
    for tick in (1, 2, 3):
        d = j.deltas(tick, ticks[tick - 1])
        j.dfs["mv1"].step(tick, d)
        j.dfs["mv2"].step(tick, d)
    t = Side(False)
    t.hist = {s: list(h) for s, h in j.hist.items()}
    t.install("mv1", OPS.shared_desc("first"))
    t.install("mv2", OPS.shared_desc("second", 1))
    interop.load_trace_manager(t.tm, j.tm, device="cpu")
    for name in ("mv1", "mv2"):
        interop.load_dataflow(t.dfs[name], j.dfs[name])
        assert_same(j.dfs[name], t.dfs[name], f"{name} carried")
    assert_manager(j, t, "carried")
    for tick in (4, 5, 6):
        step_both(j, t, tick, ticks[tick - 1], ["mv1", "mv2"])
