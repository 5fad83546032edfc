"""The port's host renderer (`runtime.Dataflow`, through `render_dataflow`)
against the JAX package's, tick by tick, byte for byte.

The plans are the port's node-coverage cases (models/operators.py),
converted to the JAX package's classes by class name (`to_jax`; `to_port`,
the other way, serves the other port tests). Together with Q3 (the
DeltaJoin) they render every node kind of the host renderer: Constant, Mfp
(with variadic, unary and string functions), FlatMap, Negate, Union,
ArrangeBy, LinearJoin, DeltaJoin, Reduce, FusedMfpReduce, BasicAgg,
Distinct, Threshold, TopK, MonotonicTopK, Window, TemporalFilter and
LetRec. Each case runs three to five ticks of seeded inserts and
retractions (NULLs and division by zero among them) through both packages; after every tick each object's oks and errs batches
(u32 columns widened to int64 in the port), every peek, the frontier,
`arrangement_info` without bytes and `operator_info`'s types and
invocations, and `operator_rates` (rows in and out of every operator, with
operator logging on), must be equal. The relational cases compact after tick 3 and
the temporal case has an `until`; the relational and strings cases carry
the JAX dataflow's state into a fresh port dataflow after tick 3
(`interop.load_dataflow`), which then continues identically.
"""

import dataclasses
import importlib
import tracemalloc

import numpy as np
import pytest
import torch

import jax

from materialize_tpu.dataflow import runtime as JR
from materialize_tpu.models import tpch as JT
from materialize_tpu.repr import UpdateBatch as JB
from materialize_tpu.storage.generator import TpchGenerator as JGen
from materialize_tpu_torch import interop
from materialize_tpu_torch.dataflow import fused as TF
from materialize_tpu_torch.dataflow import runtime as TR
from materialize_tpu_torch.models import operators as OPS
from materialize_tpu_torch.models import tpch as TT
from materialize_tpu_torch.parallel.mesh import make_mesh
from materialize_tpu_torch.repr.batch import UpdateBatch as TB
from materialize_tpu_torch.storage import TpchGenerator as TGen

# One intra-op thread: the suite runs in several test processes at once.
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing,
    which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


# -- the JAX LIR -> the port's LIR, by class name ----------------------------------

_MODULES = ("dataflow.plan", "expr.scalar", "expr.linear", "expr.strings", "ops.reduce",
            "ops.topk", "ops.window", "repr.types")
_TO_PORT = {f"materialize_tpu.{m}": f"materialize_tpu_torch.{m}" for m in _MODULES}
_TO_JAX = {v: k for k, v in _TO_PORT.items()}


def _convert(obj, modules: dict, memo: dict):
    hit = memo.get(id(obj))
    if hit is not None:
        return hit[1]
    cls = type(obj)

    def twin():
        return getattr(importlib.import_module(modules[cls.__module__]), cls.__name__)

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = twin()(**{f.name: _convert(getattr(obj, f.name), modules, memo)
                        for f in dataclasses.fields(obj) if f.init})
    elif cls.__name__ == "StringDictionary":
        out = twin()()
        for s in obj._strs:
            out.encode(s)
    elif cls.__name__ == "StringFuncTables":
        out = twin()(_convert(obj.dct, modules, memo))
    elif isinstance(obj, tuple):
        out = tuple(_convert(x, modules, memo) for x in obj)
    elif isinstance(obj, list):
        out = [_convert(x, modules, memo) for x in obj]
    elif isinstance(obj, dict):
        out = {k: _convert(v, modules, memo) for k, v in obj.items()}
    else:
        return obj
    memo[id(obj)] = (obj, out)  # keeps obj alive, so ids stay unique
    return out


def to_port(obj):
    """The port's counterpart of a JAX plan value: dataclasses by class
    name, string dictionaries and function tables copied (one new object
    for each), shared subtrees kept shared."""
    return _convert(obj, _TO_PORT, {})


def to_jax(obj):
    """The JAX package's counterpart of a port plan value (as `to_port`)."""
    return _convert(obj, _TO_JAX, {})


# -- comparison ----------------------------------------------------------------------


def jleaves(obj) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(obj)]


def assert_batch(jb, tb, what: str) -> None:
    if jb is None:
        assert tb is None, what
        return
    assert tb is not None, what
    want, got = jleaves(jb), interop.to_numpy(tb)
    assert len(got) == len(want), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, (what, i, w.dtype, g.dtype, w.shape,
                                                            g.shape)
        assert w.tobytes() == g.tobytes(), (what, i, w, g)


def assert_results(jres: dict, tres: dict, what: str) -> None:
    assert set(jres) == set(tres), what
    for k, jd in jres.items():
        td = tres[k]
        if jd is None:
            assert td is None, (what, k)
            continue
        assert td is not None, (what, k)
        assert_batch(jd[0], td[0], f"{what} {k} oks")
        assert_batch(jd[1], td[1], f"{what} {k} errs")


def _peeks(df) -> dict:
    out = {}
    for idx in df.index_traces:
        try:
            out[idx] = df.peek(idx)
        except RuntimeError as e:  # an error collection: compare the message
            out[idx] = str(e)
    return out


def assert_same(jdf, tdf, what: str) -> None:
    assert tdf.frontier == jdf.frontier, what
    assert _peeks(tdf) == _peeks(jdf), what
    assert [r[:-1] for r in tdf.arrangement_info()] == \
        [r[:-1] for r in jdf.arrangement_info()], what
    assert [(o, i, t, n) for o, i, t, _ns, n in tdf.operator_info()] == \
        [(o, i, t, n) for o, i, t, _ns, n in jdf.operator_info()], what
    assert tdf.operator_rates() == jdf.operator_rates(), what


def run_both(jdesc, ticks: list, compact=None, carry_after=None, logging=False) -> tuple:
    """Step a JAX and a port host-rendered dataflow of `jdesc` through
    `ticks` ({source: (cols, diffs)} each, at times 1, 2, ...) and compare
    them after every tick. With `logging`, both count rows in and out of
    every operator (`operator_rates`). Returns both dataflows."""
    tdesc = to_port(jdesc)
    jdf = JR.render_dataflow(jdesc, operator_logging=logging)
    tdf = TR.render_dataflow(tdesc, operator_logging=logging, device="cpu")
    assert isinstance(jdf, JR.Dataflow) and isinstance(tdf, TR.Dataflow)
    for tick, inputs in enumerate(ticks, start=1):
        jin, tin = {}, {}
        for src, (cols, diffs) in inputs.items():
            times = np.full(len(diffs), tick, dtype=np.uint64)
            jin[src] = JB.build((), cols, times, diffs)
            tin[src] = TB.build((), cols, times, diffs, device="cpu")
        jres = jdf.step(tick, jin)
        tres = tdf.step(tick, tin)
        assert_results(jres, tres, f"tick {tick}")
        if compact is not None and tick == compact[0]:
            jdf.compact(compact[1])
            tdf.compact(compact[1])
        assert_same(jdf, tdf, f"tick {tick}")
        if tick == carry_after:
            tdf = TR.render_dataflow(tdesc, operator_logging=logging, device="cpu")
            interop.load_dataflow(tdf, jdf)
            assert_same(jdf, tdf, f"carried after tick {tick}")
    return jdf, tdf


# -- the cases of models/operators.py ----------------------------------------------------


@pytest.mark.parametrize("case", sorted(OPS.CASES))
def test_node_case_byte_identical(case):
    desc_fn, ticks_fn, compact = OPS.CASES[case]
    carry = 3 if case in ("relational_joins", "relational_sets", "strings") else None
    jdf, tdf = run_both(to_jax(desc_fn()), ticks_fn(), compact=compact, carry_after=carry,
                        logging=True)
    assert any(r[3] for r in tdf.operator_rates()), "operator logging counted no rows"
    if case == "temporal":  # `until` closed both
        assert tdf.is_complete() and jdf.is_complete()


def test_every_node_kind_is_covered():
    from materialize_tpu_torch.arrangement.trace_manager import TraceManager

    kinds = set()
    for desc_fn, _t, _c in OPS.CASES.values():
        for traces in (None, TraceManager()):  # private and shared arrangements
            df = TR.render_dataflow(desc_fn(), traces=traces, trace_reader="r", device="cpu")
            kinds |= {type(n).__name__ for _o, ops, _r in df.builds for n, _i in ops}
    kinds.add("DeltaJoinNode")  # Q3, below
    kinds.add("SharedReduceNode")  # tests/test_torch_trace_manager.py
    assert kinds == {c.__name__ for c in TR.Node.__subclasses__()}


def test_letrec_nonconvergent_raises_reference_message():
    """grow = s UNION (grow + 1) never converges; the port raises the
    reference's message (tests/test_recursion.py::test_nonconvergent_raises
    matches "converge" in it)."""
    df = TR.render_dataflow(OPS.nonconvergent_desc(12), device="cpu")
    batch = TB.build((), (np.array([1], np.int64),), np.array([1], np.uint64),
                     np.array([1], np.int64), device="cpu")
    with pytest.raises(RuntimeError,
                       match="WITH MUTUALLY RECURSIVE did not converge in 12 iterations"):
        df.step(1, {"s": batch})


# -- Q3 through the default renderer ----------------------------------------------------


def test_q3_default_renderer_byte_identical_and_oracle():
    """tpch.q3() at sf 0.001: hydration and five refresh ticks through
    render_dataflow in both packages (the DeltaJoinNode path), against each
    other and against q3_oracle."""
    jgen, tgen = JGen(sf=0.001, seed=7), TGen(sf=0.001, seed=7, device="cpu")
    jdf, tdf = JR.render_dataflow(JT.q3()), TR.render_dataflow(TT.q3(), device="cpu")
    srcs = ("customer", "orders", "lineitem")
    ji, ti = jgen.initial_batches(0), tgen.initial_batches(0)
    assert_results(jdf.step(0, {k: ji[k] for k in srcs}), tdf.step(0, {k: ti[k] for k in srcs}),
                   "hydration")
    for tick in range(1, 6):
        assert_results(jdf.step(tick, jgen.refresh(tick, frac=0.01)),
                       tdf.step(tick, tgen.refresh(tick, frac=0.01)), f"tick {tick}")
        assert_same(jdf, tdf, f"tick {tick}")
    want = TT.q3_oracle(tuple(tgen._customer_cols()), tuple(tgen._orders_store),
                        tuple(tgen._lineitem_store))
    want = {k: v for k, v in want.items() if v != 0}
    assert {(r[0], r[1], r[2]): r[3] for r in tdf.peek("idx_q3")} == want


def test_render_dataflow_refuses_what_is_not_ported():
    desc = OPS.relational_desc()
    # the device exchange plane is served: a mesh given renders the fused
    # dataflow over its workers, under auto with fused asked for, and under
    # device by itself; without a mesh on the CPU, device forms none (it
    # never falls back to the CPU)
    mesh = make_mesh(2, "cpu")
    for kw in ({"fused": True}, {"exchange_backend": "device"}):
        df = TR.render_dataflow(desc, mesh=mesh, device="cpu", **kw)
        assert isinstance(df, TF.FusedDataflow) and df.n_shards == 2 and df.mesh == mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.render_dataflow(desc, exchange_backend="device", device="cpu")
    # what stays unported: the host-staged exchange plane between processes
    with pytest.raises(NotImplementedError, match="netexchange"):
        TR.Dataflow(desc, shard=object(), device="cpu")
    # the fused renderer refuses the basic aggregates: the host renderer takes it
    assert isinstance(TR.render_dataflow(OPS.strings_desc(), fused=True, device="cpu"),
                      TR.Dataflow)
