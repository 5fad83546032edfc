"""The port's top-k, fixed-point reduce and hand-built fused plans against JAX.

Every output must be byte-identical to the JAX package's on the same seeded
numpy input (u32 hashes and times widened to int64 in the port):
`distinct_keys`, `_gather_materialize` and `topk_select` (descending and
ascending, NULLs first and last, limit and offset, a multiplicity of 3
straddling the window); `_emit_output` of a fixed-point float SUM and
`accum_overflow_errs`; and, through `FusedDataflow`, hand-built Distinct
over an Mfp, Threshold (an EXCEPT ALL over an ArrangeBy and a Constant, so
multiplicities go negative) and a three-input delta join with a closure,
tick by tick, state leaves and peeks included.
The small tests also run the NumPy host consolidation against the JAX
package's (its native kernel where built, else its NumPy path).
"""

import importlib
import tracemalloc

import numpy as np
import pytest
import torch

import jax

from materialize_tpu.arrangement.spine import arrange_batch as j_arrange
from materialize_tpu.dataflow import fused as JF
from materialize_tpu.dataflow import plan as jlir
from materialize_tpu.expr import CallBinary as JCall
from materialize_tpu.expr import Column as JColumn
from materialize_tpu.expr import Literal as JLiteral
from materialize_tpu.expr import MapFilterProject as JMfp
from materialize_tpu.repr.batch import UpdateBatch as JB
from materialize_tpu_torch import interop
from materialize_tpu_torch.arrangement.spine import arrange_batch as t_arrange
from materialize_tpu_torch.dataflow import fused as TF
from materialize_tpu_torch.dataflow import plan as tlir
from materialize_tpu_torch.expr import CallBinary as TCall
from materialize_tpu_torch.expr import Column as TColumn
from materialize_tpu_torch.expr import Literal as TLiteral
from materialize_tpu_torch.expr import MapFilterProject as TMfp
from materialize_tpu_torch.expr.scalar import NULL_I64
from materialize_tpu_torch.ops import reduce as tred
from materialize_tpu_torch.ops import topk as ttopk
from materialize_tpu_torch.repr.batch import UpdateBatch as TB
from materialize_tpu_torch.utils.native import consolidate_host

# One intra-op thread: the suite runs in several test processes at once, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


# the JAX package's ops/__init__ re-exports functions under these module names
jred = importlib.import_module("materialize_tpu.ops.reduce")
jtopk = importlib.import_module("materialize_tpu.ops.topk")
jnative = importlib.import_module("materialize_tpu.utils.native")

I64 = np.dtype(np.int64)


def _same(jobj, tobj, what=""):
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jobj)]
    got = interop.to_numpy(tobj)
    assert len(want) == len(got), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, (what, i, w.dtype, g.dtype)
        assert w.tobytes() == g.tobytes(), (what, i)


def _grouped_rows(rng, n: int, n_groups: int, diffs=None):
    """Host columns (group, amount with NULLs, float score with NaN, id)."""
    group = rng.integers(0, n_groups, n)
    amount = rng.integers(-5, 6, n)
    amount[rng.random(n) < 0.15] = NULL_I64
    score = rng.integers(0, 4, n).astype(np.float32)
    score[rng.random(n) < 0.15] = np.nan
    ids = rng.permutation(n).astype(np.int64)
    if diffs is None:
        diffs = rng.integers(-1, 4, n)
    times = rng.integers(1, 4, n)
    return (group, amount, score, ids), times, diffs


def _both(cols, times, diffs, cap, key_cols):
    jb = j_arrange(JB.build((), cols, times, diffs, cap=cap), key_cols)
    tb = t_arrange(TB.build((), cols, times, diffs, cap=cap, device="cpu"), key_cols)
    return jb, tb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distinct_keys_and_gather_match_jax(seed):
    rng = np.random.default_rng(seed)
    cols, times, diffs = _grouped_rows(rng, 120, 9)
    diffs[::7] = 0  # dead rows inside runs
    j_delta, t_delta = _both(tuple(c[:40] for c in cols), times[:40], diffs[:40], 64, (0,))
    j_probes, t_probes = jtopk.distinct_keys(j_delta), ttopk.distinct_keys(t_delta)
    _same(j_probes, t_probes, "distinct_keys")
    j_arr, t_arr = _both(cols, times, np.abs(diffs), 128, (0,))
    for cap in (16, 256):  # 16 drops matches past the cap
        _same(jtopk._gather_materialize(j_probes, j_arr, cap),
              ttopk._gather_materialize(t_probes, t_arr, cap), f"gather {cap}")
        total, got = ttopk.gather_with_total(t_probes, t_arr, cap)
        _same(jtopk._gather_materialize(j_probes, j_arr, cap), got, f"gather_with_total {cap}")
        assert int(total) == int(jtopk._gather_total(j_probes, j_arr))


TOPK_CASES = {
    "max amount, nulls first": (((1, True),), 1, 0, None),
    "min amount, nulls last": (((1, False),), 1, 0, None),
    "desc, nulls last, limit 2 offset 1": (((1, True),), 2, 1, (True,)),
    "asc, nulls first, offset only": (((1, False),), None, 2, (False,)),
    "float score desc then amount asc": (((2, True), (1, False)), 3, 0, None),
    "float score asc, nulls last": (((2, False),), 2, 1, (True,)),
}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_topk_select_matches_jax(case):
    order_by, limit, offset, nulls_last = TOPK_CASES[case]
    rng = np.random.default_rng(len(case))
    cols, times, diffs = _grouped_rows(rng, 90, 6, diffs=rng.integers(-1, 4, 90))
    # a multiplicity of 3 that straddles every window boundary
    diffs[:6] = 3
    j_rows, t_rows = _both(cols, times, diffs, 128, (0,))
    _same(jtopk.topk_select(j_rows, order_by, limit, offset, np.uint32(5), nulls_last),
          ttopk.topk_select(t_rows, order_by, limit, offset, 5, nulls_last), case)


def test_negate_matches_jax():
    rng = np.random.default_rng(4)
    cols, times, diffs = _grouped_rows(rng, 30, 4)
    j, t = _both(cols, times, diffs, 32, (0,))
    _same(jtopk.negate(j), ttopk.negate(t))


def _float_sum_inputs(rng, n):
    key = rng.integers(0, 5, n)
    val = (rng.standard_normal(n) * 1000).astype(np.float32)
    val[rng.random(n) < 0.1] = np.nan  # NULLs contribute nothing
    val[:3] = np.float32(0.5), np.float32(1.5), np.float32(2.5)  # ties round to even
    val[3] = np.float32(2.0 ** 37)  # past the 2^60 bound once scaled by 2^24
    return (key, val), rng.integers(1, 3, n), rng.integers(-2, 3, n)


def test_fixed_point_float_sum_matches_jax():
    rng = np.random.default_rng(9)
    cols, times, diffs = _float_sum_inputs(rng, 60)
    jaggs = (jred.AggregateExpr("sum", JColumn(1), fixed_scale=jred.FLOAT_FIXED_SCALE),
             jred.AggregateExpr("count", JLiteral(1)))
    taggs = (tred.AggregateExpr("sum", TColumn(1), fixed_scale=tred.FLOAT_FIXED_SCALE),
             tred.AggregateExpr("count", TLiteral(1)))
    assert [jred.agg_out_dtype(a) for a in jaggs] == [tred.agg_out_dtype(a) for a in taggs]
    jraw, jerr = jred._contributions(JB.build((), cols, times, diffs, cap=64), (0,), jaggs)
    traw, terr = tred._contributions(TB.build((), cols, times, diffs, cap=64, device="cpu"),
                                     (0,), taggs)
    _same(jraw, traw, "contributions")
    _same(jerr, terr, "contribution errors")
    jc, tc = jred.consolidate_accums(jraw), tred.consolidate_accums(traw)
    _same(jc, tc, "consolidated")
    old = (rng.integers(-(1 << 40), 1 << 40, 64), rng.integers(0, 4, 64))
    old_nrows = rng.integers(0, 3, 64)
    _same(jred._emit_output(jc, tuple(old), old_nrows, np.uint32(3), jaggs),
          tred._emit_output(tc, tuple(torch.tensor(o) for o in old), torch.tensor(old_nrows),
                            3, taggs), "emit_output")
    jov = jred.accum_overflow_errs(jc, tuple(old), jaggs, np.uint32(3))
    tov = tred.accum_overflow_errs(tc, tuple(torch.tensor(o) for o in old), taggs, 3)
    _same(jov, tov, "accum_overflow_errs")
    assert int(tov.count()) >= 1  # the 2^37 input
    assert tred.accum_overflow_errs(tc, (), taggs[1:], 3) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_consolidate_host_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    cols = {"c0": rng.integers(-3, 3, n), "c1": rng.integers(0, 2, n).astype(np.int32),
            "c2": rng.choice([0.0, -0.0, np.nan, 1.5], n).astype(np.float32),
            "times": rng.integers(0, 4, n).astype(np.uint64), "diffs": rng.integers(-2, 3, n)}
    want, got = jnative.consolidate_host(dict(cols)), consolidate_host(dict(cols))
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].tobytes() == got[k].tobytes(), k


# -- hand-built plans through the fused renderer ---------------------------------


def _plans(lir, Mfp, Column, Literal, Call):
    """Distinct over an Mfp, Threshold (t plus constant rows EXCEPT ALL u)
    and a three-input delta join c(ck, seg) ⋈ o(ok, ck, od) ⋈ l(lk, price)
    with a closure, as one description (one build of three objects)."""
    t, u = lir.Get("t"), lir.Get("u")
    doubled = lir.Mfp(t, Mfp(2, map_exprs=(Call("mul", Column(1), Literal(2)),),
                             predicates=(Call("gt", Column(0), Literal(0)),),
                             projection=(2,)))
    # rows at times 1 and 3: the second arrives with tick 3
    const = lir.Constant(rows=(((1, 2), 1, 1), ((0, 3), 3, 2)), dtypes=(I64, I64))
    c, o, li = lir.Get("c"), lir.Get("o"), lir.Get("l")
    S = lir.DeltaPathStage
    delta = lir.DeltaJoinPlan(
        paths=(
            (S(1, (0,), (1,)), S(2, (2,), (0,))),  # c -> o by ck -> l by ok
            (S(0, (1,), (0,)), S(2, (0,), (0,))),  # o -> c by ck -> l by ok
            (S(1, (0,), (0,)), S(0, (3,), (0,))),  # l -> o by ok -> c by ck
        ),
        permutations=((0, 1, 2, 3, 4, 5, 6), (3, 4, 0, 1, 2, 5, 6), (5, 6, 2, 3, 4, 0, 1)),
    )
    closure = Mfp(7, map_exprs=(Call("mul", Column(6), Literal(2)),),
                  predicates=(Call("gt", Column(6), Literal(20)),),
                  projection=(0, 1, 2, 4, 7))
    return lir.DataflowDescription(
        source_imports={"t": (I64, I64), "u": (I64, I64), "c": (I64, I64),
                        "o": (I64, I64, I64), "l": (I64, I64)},
        objects_to_build=[
            lir.BuildDesc("d", lir.Reduce(doubled, key_cols=(0,), distinct=True), (I64,)),
            lir.BuildDesc("th", lir.Threshold(lir.Union((lir.ArrangeBy(t, (0,)), const,
                                                         lir.Negate(u)))), (I64, I64)),
            lir.BuildDesc("dj", lir.Join((c, o, li), delta, closure), (I64,) * 5),
        ],
        index_exports={"idx_d": ("d", (0,)), "idx_th": ("th", (0,)), "idx_dj": ("dj", (0,))},
    )


def _plan_inputs(n_ticks: int) -> list:
    """Per tick {source: (cols, times, diffs)}: inserts and retractions of
    earlier rows, over small key ranges so groups and join keys repeat."""
    rng = np.random.default_rng(11)
    shapes = {"t": (2, 4), "u": (2, 4), "c": (2, 3), "o": (3, 4), "l": (2, 40)}
    hist: dict = {s: [] for s in shapes}
    ticks = []
    for tick in range(1, n_ticks + 1):
        inp = {}
        for src, (arity, hi) in shapes.items():
            n = int(rng.integers(3, 9))
            rows = [tuple(int(x) for x in rng.integers(0, hi, arity)) for _ in range(n)]
            diffs = [1] * n
            if hist[src] and tick > 2:  # retract some earlier rows
                for r in rng.choice(len(hist[src]), size=2, replace=False):
                    rows.append(hist[src][r])
                    diffs.append(-1)
            hist[src].extend(rows[:n])
            cols = tuple(np.array(c, dtype=np.int64) for c in zip(*rows))
            inp[src] = (cols, np.full(len(rows), tick), np.array(diffs, dtype=np.int64))
        ticks.append(inp)
    return ticks


def test_hand_built_distinct_threshold_delta_join_match_jax():
    caps = dict(delta=32, arrangement=256, groups=128, join_out=128, gather=64, ratio=2)
    jdesc = _plans(jlir, JMfp, JColumn, JLiteral, JCall)
    tdesc = _plans(tlir, TMfp, TColumn, TLiteral, TCall)
    jdf = JF.FusedDataflow(jdesc, JF.FusedCaps(**caps))
    tdf = TF.FusedDataflow(tdesc, TF.FusedCaps(**caps), device="cpu")
    assert list(jdf.state) == list(tdf.state)  # the same state paths
    for tick, inp in enumerate(_plan_inputs(5), start=1):
        jres = jdf.step(tick, {s: JB.build((), *v) for s, v in inp.items()})
        tres = tdf.step(tick, {s: TB.build((), *v, device="cpu") for s, v in inp.items()})
        assert set(jres) == set(tres)
        for obj, jv in jres.items():
            tv = tres[obj]
            assert (jv is None) == (tv is None), (tick, obj)
            for jb, tb in zip(jv or (), tv or ()):
                assert (jb is None) == (tb is None), (tick, obj)
                if jb is not None:
                    _same(jb, tb, f"tick {tick} {obj}")
        assert (jdf.retries, jdf._scale) == (tdf.retries, tdf._scale)
        _same(jdf.state, tdf.state, f"tick {tick} state")
        for idx in jdf.index_traces:
            assert jdf.peek(idx) == tdf.peek(idx), (tick, idx)
    # the views hold rows (the plans did not collapse to nothing)
    assert all(tdf.peek(idx) for idx in tdf.index_traces)
