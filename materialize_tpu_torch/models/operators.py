"""Small dataflows that together render every node kind of the host renderer.

Each case is a description and its seeded input ticks ({source: (host
columns, diffs)} per tick, rows at time = tick): inserts (some twice over),
and from the third tick on retractions of rows of two ticks before, with
NULLs, zero divisors and out-of-dictionary string codes among the values.

- `relational_joins`: Mfp, ArrangeBy, LinearJoin, Reduce, FusedMfpReduce;
- `relational_sets`: Constant, Mfp, Negate, Union, Distinct, Threshold,
  TopK and MonotonicTopK;
- `window`: Window, every function, with and without ORDER BY;
- `temporal`: TemporalFilter and a reduce over it, with an `until`;
- `letrec`: a convergent LetRec (reachability over edges);
- `strings`: string functions in an MFP (tables and multi-argument host
  evaluation), a host-rendered generate_series FlatMap and the basic
  aggregates (string_agg, array_agg, jsonb_agg, min over strings).

`shared_desc` adds the shared-arrangement nodes (SharedArrangeNode,
SharedReduceNode, shared join sides): dataflows that read sources s and t
through one TraceManager (rendered with `traces=`, so not in `CASES`).

Q3 (models/tpch.py) adds the DeltaJoin. The port's tests run these cases
against the JAX package on the CPU; chip_smoke.py runs them on the card
against the port's own CPU run.
"""

from __future__ import annotations

import numpy as np

from ..dataflow import plan as lir
from ..expr import scalar as S
from ..expr.linear import MapFilterProject
from ..expr.strings import StringFuncTables
from ..ops.reduce import AggregateExpr
from ..ops.topk import TopKPlan
from ..ops.window import WindowFuncSpec, WindowPlan
from ..repr.types import StringDictionary

I64 = np.dtype(np.int64)
NULL = int(np.iinfo(np.int64).min)
C, L = S.Column, S.Literal


def _mfp(arity, maps=(), preds=(), proj=None):
    return MapFilterProject(arity, tuple(maps), tuple(preds),
                            None if proj is None else tuple(proj))


def churn(seed: int, n_ticks: int, n: int, gens: dict, retract=True, dup=True) -> list:
    """Per tick {source: (cols, diffs)}: `n` new rows a source from
    `gens[source](rng, n)` (with `dup`, some twice over: diff 2), and from
    the third tick on the retraction of a third of the rows of two ticks
    before."""
    rng = np.random.default_rng(seed)
    hist: dict = {s: [] for s in gens}
    ticks = []
    for t in range(n_ticks):
        inp = {}
        for src, make in gens.items():
            cols = make(rng, n)
            diffs = (rng.integers(1, 3, n) if dup else np.ones(n)).astype(np.int64)
            hist[src].append((cols, diffs))
            if retract and t >= 2:
                old_cols, old_d = hist[src][t - 2]
                k = n // 3
                cols = tuple(np.concatenate([c, o[:k]]) for c, o in zip(cols, old_cols))
                diffs = np.concatenate([diffs, -old_d[:k]])
            inp[src] = (cols, diffs)
        ticks.append(inp)
    return ticks


def _ints(rng, n, lo, hi, null_frac=0.0):
    v = rng.integers(lo, hi, n).astype(np.int64)
    if null_frac:
        v[rng.random(n) < null_frac] = NULL
    return v


def relational_desc(objects=("lj", "red", "fred", "dist", "thr", "top", "mtop")):
    """The relational operators over sources r, s and the append-only m;
    `objects` picks which of the views to build."""
    r_src = {"r": (I64,) * 3, "s": (I64,) * 2, "m": (I64,) * 2}
    r_pos = lir.Mfp(lir.Get("r"), _mfp(3, preds=[S.CallBinary("gte", C(0), L(0))]))
    lj = lir.Join(
        inputs=(r_pos, lir.ArrangeBy(lir.Get("s"), (0,))),
        plan=lir.LinearJoinPlan(stages=(lir.JoinStage((1,), (0,)),)),
        closure=_mfp(5, maps=[S.CallBinary("add", C(2), C(4))], proj=(0, 1, 5)),
    )
    A = AggregateExpr
    red = lir.Reduce(lir.Get("lj"), key_cols=(0,),
                     aggs=(A("sum", C(2)), A("count", L(1)), A("count", C(2))))
    quot = lir.Mfp(lir.Get("r"), _mfp(
        3,
        maps=[S.CallBinary("div", C(1), C(2)),
              S.CallVariadic("coalesce", (C(0), L(-1))),
              S.CallBinary("mod", C(1), C(2))],
        preds=[S.CallUnary("is_not_null", C(1))],
        proj=(4, 3, 5)))
    fred = lir.Reduce(quot, key_cols=(0,), aggs=(A("sum", C(1)), A("count", C(2))))
    const = lir.Constant(rows=(((1,), 0, 1), ((2,), 0, 2), ((9,), 3, 1)), dtypes=(I64,))
    dist = lir.Reduce(lir.Union((lir.Mfp(lir.Get("r"), _mfp(3, proj=(1,))),
                                 lir.Negate(const))), key_cols=(0,), distinct=True)
    thr = lir.Threshold(lir.Union((lir.Mfp(lir.Get("r"), _mfp(3, proj=(1,))),
                                   lir.Negate(lir.Mfp(lir.Get("s"), _mfp(2, proj=(0,)))))))
    top = lir.TopK(lir.Get("r"), TopKPlan((0,), ((1, True), (2, False)), 2, 1))
    mtop = lir.TopK(lir.Get("m"), TopKPlan((0,), ((1, False),), 1), monotonic=True)
    builds = [("lj", lj, (I64,) * 3), ("red", red, (I64,) * 4), ("fred", fred, (I64,) * 3),
              ("dist", dist, (I64,)), ("thr", thr, (I64,)), ("top", top, (I64,) * 3),
              ("mtop", mtop, (I64,) * 2)]
    builds = [b for b in builds if b[0] in objects]
    return lir.DataflowDescription(
        source_imports=r_src,
        objects_to_build=[lir.BuildDesc(i, p, d) for i, p, d in builds],
        index_exports={f"idx_{i}": (i, (0,)) for i, _p, _d in builds},
    )


def relational_ticks(n_ticks=4):
    ticks = churn(1, n_ticks, 6, {
        "r": lambda rng, n: (_ints(rng, n, 0, 4, 0.1), _ints(rng, n, 0, 6, 0.1),
                             _ints(rng, n, -2, 3)),
        "s": lambda rng, n: (_ints(rng, n, 0, 6), _ints(rng, n, 0, 100)),
    })
    rng = np.random.default_rng(2)
    for t in ticks:  # an append-only source for the monotonic top-k
        t["m"] = ((_ints(rng, 4, 0, 3), _ints(rng, 4, 0, 50)), np.ones(4, np.int64))
    return ticks


def window_desc():
    F = WindowFuncSpec
    wf = (F("row_number"), F("rank"), F("dense_rank"), F("ntile", offset=3), F("lag", arg=2),
          F("lead", arg=2, offset=2), F("first_value", arg=2), F("last_value", arg=2),
          F("sum", arg=2), F("count"), F("count", arg=2), F("min", arg=2), F("max", arg=2))
    w1 = lir.Window(lir.Get("r"), WindowPlan((0,), ((1, False),), wf))
    w2 = lir.Window(lir.Get("r"), WindowPlan((0,), (), (F("sum", arg=1), F("max", arg=2),
                                                        F("row_number"))))
    builds = [("w1", w1, (I64,) * 16), ("w2", w2, (I64,) * 6)]
    return lir.DataflowDescription(
        source_imports={"r": (I64,) * 3},
        objects_to_build=[lir.BuildDesc(i, p, d) for i, p, d in builds],
        index_exports={f"idx_{i}": (i, (0,)) for i, _p, _d in builds},
    )


def window_ticks(n_ticks=3, n=10):
    return churn(3, n_ticks, n, {"r": lambda rng, n: (
        _ints(rng, n, 0, 4), _ints(rng, n, 0, 5, 0.1), _ints(rng, n, -3, 4, 0.1))})


def temporal_desc():
    tf = lir.TemporalFilter(lir.Get("e"), lowers=(C(1),), uppers=(C(2),))
    cnt = lir.Reduce(lir.Mfp(tf, _mfp(3, proj=(0,))), key_cols=(0,),
                     aggs=(AggregateExpr("count", L(1)),))
    return lir.DataflowDescription(
        source_imports={"e": (I64,) * 3},
        objects_to_build=[lir.BuildDesc("live", tf, (I64,) * 3),
                          lir.BuildDesc("cnt", cnt, (I64,) * 2)],
        index_exports={"idx_live": ("live", (0,)), "idx_cnt": ("cnt", (0,))},
        until=4,
    )


def temporal_ticks(n_ticks=4, n=10):
    def events(rng, n):
        lo = _ints(rng, n, 0, 6, 0.1)
        hi = lo + _ints(rng, n, -1, 4)
        hi[rng.random(n) < 0.1] = 1 << 40  # saturates: never expires
        return _ints(rng, n, 0, 5), lo, hi

    return churn(4, n_ticks, n, {"e": events})


def letrec_desc(max_iters=100):
    """reach = distinct(edges UNION reach JOIN edges ON reach.dst = edges.src)."""
    join = lir.Join(inputs=(lir.Get("reach"), lir.Get("edges")),
                    plan=lir.LinearJoinPlan(stages=(lir.JoinStage((1,), (0,)),)),
                    closure=_mfp(4, proj=(0, 3)))
    reach = lir.Reduce(lir.Union((lir.Get("edges"), join)), key_cols=(0, 1), distinct=True)
    rec = lir.LetRec(bindings=(("reach", reach, (I64, I64)),), body=lir.Get("reach"),
                     body_dtypes=(I64, I64), external_ids=("edges",),
                     ext_dtypes=(("edges", (I64, I64)),), max_iters=max_iters)
    return lir.DataflowDescription(
        source_imports={"edges": (I64, I64)},
        objects_to_build=[lir.BuildDesc("mv_reach", rec, (I64, I64))],
        index_exports={"idx_reach": ("mv_reach", (0, 1))},
    )


def letrec_ticks(n_ticks=3, n=4):
    return churn(5, n_ticks, n, {"edges": lambda rng, n: (_ints(rng, n, 0, 6),
                                                          _ints(rng, n, 0, 6))}, dup=False)


def nonconvergent_desc(max_iters=12):
    """grow = distinct(s UNION grow + 1): never converges."""
    grow = lir.Reduce(lir.Union((
        lir.Get("s"),
        lir.Mfp(lir.Get("grow"), _mfp(1, maps=[S.CallBinary("add", C(0), L(1))], proj=(1,))),
    )), key_cols=(0,), distinct=True)
    rec = lir.LetRec(bindings=(("grow", grow, (I64,)),), body=lir.Get("grow"),
                     body_dtypes=(I64,), external_ids=("s",), ext_dtypes=(("s", (I64,)),),
                     max_iters=max_iters)
    return lir.DataflowDescription(source_imports={"s": (I64,)},
                                   objects_to_build=[lir.BuildDesc("g", rec, (I64,))],
                                   index_exports={})


WORDS = ["apple", "Banana", "cherry", "date", "", "a b", "NULL", 'x"y', "kiwi",
         '{"k": 1, "a": [1, 2]}', '{"k": "v"}']


def strings_desc():
    dct = StringDictionary()
    for w in WORDS:
        dct.encode(w)
    tables = StringFuncTables(dct)

    def sf(spec, args, out):
        return S.DictFunc(spec, tuple(args), ("str",) * len(args), out, tables)

    m = lir.Mfp(lir.Get("t"), _mfp(4, maps=[
        sf(("upper",), [C(1)], "string"),
        sf(("length",), [C(1)], "int64"),
        sf(("like", "%a%", True), [C(1)], "bool"),
        sf(("concat",), [C(1), C(2)], "string"),
        sf(("concat_ws",), [C(2), C(1), C(2)], "string"),
        sf(("str_lt",), [C(1), C(2)], "bool"),
        sf(("json_get_text", "k"), [C(1)], "string"),
    ], preds=[S.CallVariadic("or", (S.CallUnary("is_null", C(3)),
                                    S.CallBinary("lt", C(3), L(3))))]))
    fm = lir.FlatMap(lir.Mfp(lir.Get("t"), _mfp(4, proj=(0, 3))), "generate_series",
                     (C(1), S.CallBinary("add", C(1), C(0)), L(1)))
    grouped = lir.Mfp(lir.Get("t"), _mfp(4, proj=(0, 1)))
    numbers = lir.Mfp(lir.Get("t"), _mfp(4, proj=(0, 3)))
    sagg = lir.BasicAgg(grouped, (0,), "string_agg", (",", "str", dct))
    aagg = lir.BasicAgg(numbers, (0,), "array_agg", (None, "int", dct))
    jagg = lir.BasicAgg(numbers, (0,), "jsonb_agg", (None, "int", dct))
    mn = lir.BasicAgg(grouped, (0,), "min_str", (None, "str", dct))
    i8 = np.dtype(np.int8)
    builds = [("m", m, (I64,) * 6 + (i8, I64, I64, i8, I64)), ("fm", fm, (I64,) * 3),
              ("sagg", sagg, (I64, I64)), ("aagg", aagg, (I64, I64)),
              ("jagg", jagg, (I64, I64)), ("mn", mn, (I64, I64))]
    return lir.DataflowDescription(
        source_imports={"t": (I64,) * 4},
        objects_to_build=[lir.BuildDesc(i, p, d) for i, p, d in builds],
        index_exports={f"idx_{i}": (i, (0,)) for i, _p, _d in builds},
    )


def strings_ticks(n_ticks=5, n=12):
    def rows(rng, n):
        s = _ints(rng, n, 0, len(WORDS), 0.1)
        s[rng.random(n) < 0.05] = 99  # outside the dictionary
        return (_ints(rng, n, 0, 3), s, _ints(rng, n, 0, len(WORDS), 0.1),
                _ints(rng, n, -2, 5, 0.1))

    return churn(6, n_ticks, n, {"t": rows})


def series_desc():
    """generate_series(lo, hi, step) over rows of s, and a count and sum of
    the series by the rows' tag: the one FlatMap the fused renderer takes."""
    fm = lir.FlatMap(lir.Get("s"), "generate_series", (C(0), C(1), C(2)))
    cnt = lir.Reduce(fm, key_cols=(3,), aggs=(AggregateExpr("count", L(1)),
                                              AggregateExpr("sum", C(4))))
    return lir.DataflowDescription(
        source_imports={"s": (I64,) * 4},
        objects_to_build=[lir.BuildDesc("fm", fm, (I64,) * 5),
                          lir.BuildDesc("cnt", cnt, (I64,) * 3)],
        index_exports={"idx_fm": ("fm", (0,)), "idx_cnt": ("cnt", (0,))},
    )


def series_rows(seed: int, n: int = 20):
    """(lo, hi, step, tag) columns and diffs: NULL bounds and steps, zero
    steps (STEP_ZERO errors), descending series, retractions."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(-3, 4, n).astype(np.int64)
    hi = lo + rng.integers(-4, 6, n)
    st = rng.choice(np.array([1, 2, -1, -2, 0, 3], np.int64), n)
    lo[::7] = NULL
    st[::9] = NULL
    tag = rng.integers(0, 100, n).astype(np.int64)
    diffs = rng.choice(np.array([1, 2, -1], np.int64), n)
    return (lo, hi, st, tag), diffs


def series_ticks(n_ticks=3):
    """The first tick's fan-out passes a join_out of 16 (one overflow retry)."""
    return [{"s": series_rows(10 + t, n=12 if t > 1 else 30)} for t in range(1, n_ticks + 1)]


# name -> (description, input ticks, compact (after tick, since) or None)
SHARED_SOURCES = {"s": (I64,) * 3, "t": (I64,) * 2}


def shared_desc(which: str, as_of: int = 1) -> lir.DataflowDescription:
    """A dataflow over sources s and t for rendering with a TraceManager:
    "first" an accumulable reduce over s (SharedReduceNode), a linear join
    s ⋈ t (both sides shared) and an ArrangeBy of t (SharedArrangeNode);
    "second" the same reduce and join and an ArrangeBy of s, which import
    what "first" exported; "third" a join and a new ArrangeBy of t;
    "fresh" a count over t by its second column, which none exports."""
    A = AggregateExpr
    agg = lir.Reduce(lir.Get("s"), key_cols=(0,), aggs=(A("sum", C(1)), A("count", L(1))))
    join = lir.Join(inputs=(lir.Get("s"), lir.Get("t")),
                    plan=lir.LinearJoinPlan(stages=(lir.JoinStage((0,), (0,)),)), closure=None)
    objects = {
        "first": {"agg": (agg, 3), "j": (join, 5), "arr": (lir.ArrangeBy(lir.Get("t"), (1,)), 2)},
        "second": {"agg2": (agg, 3), "j2": (join, 5),
                   "arr2": (lir.ArrangeBy(lir.Get("s"), (2,)), 3)},
        "third": {"arr3": (lir.ArrangeBy(lir.Get("t"), (0, 1)), 2), "j3": (join, 5)},
        "fresh": {"u": (lir.Reduce(lir.Get("t"), key_cols=(1,), aggs=(A("count", L(1)),)), 2)},
    }[which]
    return lir.DataflowDescription(
        source_imports=dict(SHARED_SOURCES),
        objects_to_build=[lir.BuildDesc(i, p, (I64,) * n) for i, (p, n) in objects.items()],
        index_exports={f"idx_{i}": (i, (0,)) for i in objects}, as_of=as_of)


def shared_ticks(n_ticks=7):
    return churn(5, n_ticks, 4, {
        "s": lambda rng, n: (_ints(rng, n, 0, 5), _ints(rng, n, -50, 50), _ints(rng, n, 0, 3)),
        "t": lambda rng, n: (_ints(rng, n, 0, 5), _ints(rng, n, 0, 9)),
    })


CASES = {
    "relational_joins": (lambda: relational_desc(("lj", "red", "fred")), relational_ticks, (3, 3)),
    "relational_sets": (lambda: relational_desc(("dist", "thr", "top", "mtop")), relational_ticks,
                        (3, 3)),
    "window": (window_desc, window_ticks, None),
    "temporal": (temporal_desc, temporal_ticks, None),
    "letrec": (letrec_desc, letrec_ticks, None),
    "strings": (strings_desc, strings_ticks, None),
}
