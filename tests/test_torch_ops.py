"""The port's operators against the JAX package's, on seeded batches.

The same numpy inputs go through both packages; every output array must be
byte-identical after widening the JAX u32 columns (hashes, times) to int64
and i32 positions to int64.
"""

import importlib
import tracemalloc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from materialize_tpu.arrangement.spine import arrange_batch as j_arrange
from materialize_tpu.models import fused_q3 as jq3
from materialize_tpu.ops.search import sort_perm as j_sort_perm
from materialize_tpu.repr.batch import UpdateBatch as JB
from materialize_tpu.repr.batch import bucket_cap
from materialize_tpu_torch import interop
from materialize_tpu_torch.arrangement.spine import arrange_batch as t_arrange
from materialize_tpu_torch.expr.scalar import NULL_I32, NULL_I64
from materialize_tpu_torch.models import fused_q3 as tq3
from materialize_tpu_torch.ops import consolidate as tcons
from materialize_tpu_torch.ops import join as tjoin
from materialize_tpu_torch.ops import reduce as tred
from materialize_tpu_torch.ops.search import sort_perm as t_sort_perm
from materialize_tpu_torch.repr.batch import UpdateBatch as TB

# One intra-op thread: the suite runs in several test processes at once, and
# torch's default of one thread per core oversubscribes the CPU, which slows
# the many small operators of a tick by orders of magnitude.
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()

# the JAX package's ops/__init__ re-exports functions under these module names
jcons = importlib.import_module("materialize_tpu.ops.consolidate")
jjoin = importlib.import_module("materialize_tpu.ops.join")
jred = importlib.import_module("materialize_tpu.ops.reduce")


def _leaves_equal(jobj, tobj):
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jobj)]
    tl = [np.asarray(x) for x in interop.to_numpy(tobj)]
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), (i, a, b)


def _same(port, ref):
    ref = np.asarray(ref)
    got = port.numpy()
    want = ref.astype(np.int64) if ref.dtype in (np.uint32, np.int32) and got.dtype == np.int64 \
        else ref
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (got, want)


def _raw(seed, n, cap, ncols=3, dtype=np.int64, spread=4):
    """The same raw batch in both packages: small value ranges give
    duplicate rows and keys; diffs include retractions that cancel."""
    rng = np.random.default_rng(seed)
    vals = tuple(rng.integers(-spread, spread, n).astype(dtype) for _ in range(ncols))
    times = rng.integers(0, 4, n)
    diffs = rng.choice([-1, 1, 2], n)
    return (JB.build((), vals, times, diffs, cap),
            TB.build((), vals, times, diffs, cap, device="cpu"))


def test_sort_perm_matches_jax():
    rng = np.random.default_rng(1)
    hi = rng.integers(0, 4, 200).astype(np.uint32)
    hi[-20:] = 0xFFFFFFFF
    lo = rng.integers(0, 3, 200).astype(np.uint32)
    t = rng.integers(0, 2, 200).astype(np.uint32)
    flag = rng.random(200) < 0.5
    want = j_sort_perm([jnp.asarray(x) for x in (flag, t, lo, hi)])
    got = t_sort_perm([torch.from_numpy(flag)] +
                      [torch.from_numpy(x.astype(np.int64)) for x in (t, lo, hi)])
    _same(got, want)


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("compact", [True, False])
def test_consolidate_and_arrange_match_jax(compact, dtype):
    jb, tb = _raw(2, 90, 128, dtype=dtype)
    _leaves_equal(jcons.consolidate(jb, compact=compact), tcons.consolidate(tb, compact=compact))
    _leaves_equal(j_arrange(jb, (1, 0), compact=compact), t_arrange(tb, (1, 0), compact=compact))


@pytest.mark.parametrize("since", [None, 3])
def test_merge_consolidate_matches_jax(since):
    ja, ta = _raw(3, 50, 64)
    jb, tb = _raw(4, 20, 32)
    ja, ta = j_arrange(ja, (0,)), t_arrange(ta, (0,))
    jb, tb = j_arrange(jb, (0,)), t_arrange(tb, (0,))
    jsince = None if since is None else np.uint64(since)
    _leaves_equal(jcons.merge_consolidate(ja, jb, jsince), tcons.merge_consolidate(ta, tb, since))


@pytest.mark.parametrize("cap", [64, 16])  # 16 overflows
def test_compact_to_matches_jax(cap):
    jb, tb = _raw(5, 40, 64)
    (jo, jf), (to, tf) = jcons.compact_to(jb, cap), tcons.compact_to(tb, cap)
    _leaves_equal(jo, to)
    assert bool(jf) == bool(tf) == (int(tb.count()) > cap)


def _with_nulls(cols, null, rows):
    out = []
    for c in cols:
        c = c.copy()
        c[rows] = null
        out.append(c)
    return tuple(out)


@pytest.mark.parametrize("dtype,null", [(np.int64, NULL_I64), (np.int32, NULL_I32)])
def test_q3_mfps_match_jax_with_null_rows(dtype, null):
    rng = np.random.default_rng(6)
    n = 40
    for jm, tm, ncols, hi in (
        (jq3._CUST_MFP, tq3._CUST_MFP, 3, 3),
        (jq3._ORD_MFP, tq3._ORD_MFP, 4, 2 * tq3.Q3_DATE),
        (jq3._LI_MFP, tq3._LI_MFP, 6, 2 * tq3.Q3_DATE),
        (jq3._CLOSURE, tq3._CLOSURE, 8, 1000),
    ):
        cols = tuple(rng.integers(0, hi, n).astype(dtype) for _ in range(ncols))
        cols = _with_nulls(cols, null, [3, 11])  # NULL keys, NULL predicate inputs
        times, diffs = rng.integers(0, 3, n), rng.choice([-1, 1], n)
        jb = JB.build((), cols, times, diffs, 64)
        tb = TB.build((), cols, times, diffs, 64, device="cpu")
        (jo, je), (to, te) = jm.apply(jb), tm.apply(tb)
        _leaves_equal(jo, to)
        _leaves_equal(je, te)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("out_cap", [None, 8])  # 8 truncates
def test_join_matches_jax(swap, out_cap):
    jp, tp = _raw(7, 30, 32, ncols=2)
    ja, ta = _raw(8, 50, 64, ncols=3)
    jp, tp = j_arrange(jp, (0,), compact=False), t_arrange(tp, (0,), compact=False)
    ja, ta = j_arrange(ja, (1,)), t_arrange(ta, (1,))
    total = int(tjoin.join_total(tp, ta))
    assert total == int(jjoin.join_total(jp, ja)) > 8
    cap = bucket_cap(total) if out_cap is None else out_cap
    _leaves_equal(jjoin.join_materialize(jp, ja, cap, swap),
                  tjoin.join_materialize(tp, ta, cap, swap))


def test_accumulable_reduce_matches_jax():
    # a grouped delta, its contributions, consolidation, a merge into a
    # table, the lookup, and the self-correcting output
    jb, tb = _raw(9, 100, 128, ncols=4, spread=3)
    jg, tg = j_arrange(jb, (0, 1, 2), compact=False), t_arrange(tb, (0, 1, 2), compact=False)
    (jc, je), (tc, te) = jred._contributions(jg, (0, 1, 2), jq3._AGGS), \
        tred._contributions(tg, (0, 1, 2), tq3._AGGS)
    _leaves_equal(jc, tc)
    _leaves_equal(je, te)
    jc, tc = jred.consolidate_accums(jc), tred.consolidate_accums(tc)
    _leaves_equal(jc, tc)
    jb2, tb2 = _raw(10, 60, 64, ncols=4, spread=3)
    js = jred.consolidate_accums(jred._contributions(j_arrange(jb2, (0, 1, 2)), (0, 1, 2),
                                                     jq3._AGGS)[0])
    ts = tred.consolidate_accums(tred._contributions(t_arrange(tb2, (0, 1, 2)), (0, 1, 2),
                                                     tq3._AGGS)[0])
    (jm, jdup), (tm, tdup) = jred.merge_consolidate_accums(js, jc), \
        tred.merge_consolidate_accums(ts, tc)
    _leaves_equal(jm, tm)
    assert bool(jdup) == bool(tdup) is False
    jl, tl = jred.lookup_accums(js, jc), tred.lookup_accums(ts, tc)
    for a, b in zip(jax.tree_util.tree_leaves(jl), jax.tree_util.tree_leaves(list(tl))):
        _same(b, a)
    _leaves_equal(jred._emit_output(jc, jl[1], jl[2], np.uint64(5)),
                  tred._emit_output(tc, tl[1], tl[2], 5))
    _leaves_equal(jred.collision_errs(jc, jl[3], np.uint64(5)),
                  tred.collision_errs(tc, tl[3], 5))


@pytest.mark.parametrize("agg", ["count_star", "count_col", "sum_i32"])
def test_count_and_sum_contributions_match_jax(agg):
    from materialize_tpu.expr import Column as JCol, Literal as JLit
    from materialize_tpu_torch.expr import Column as TCol, Literal as TLit

    j_expr, t_expr, acc = {
        "count_star": (JLit(1), TLit(1), "int64"),
        "count_col": (JCol(2), TCol(2), "int64"),
        "sum_i32": (JCol(3), TCol(3), "int32"),
    }[agg]
    func = "sum" if agg.startswith("sum") else "count"
    rng = np.random.default_rng(11)
    cols = tuple(rng.integers(-3, 3, 50) for _ in range(4))
    cols = (cols[0], cols[1], np.where(rng.random(50) < 0.2, NULL_I64, cols[2]), cols[3])
    times, diffs = rng.integers(0, 3, 50), rng.choice([-1, 1, 2], 50)
    jb, tb = JB.build((), cols, times, diffs, 64), TB.build((), cols, times, diffs, 64,
                                                            device="cpu")
    jaggs = (jred.AggregateExpr(func, j_expr, accum_dtype=acc),)
    taggs = (tred.AggregateExpr(func, t_expr, accum_dtype=acc),)
    (jc, je), (tc, te) = jred._contributions(jb, (0, 1), jaggs), \
        tred._contributions(tb, (0, 1), taggs)
    _leaves_equal(jc, tc)
    _leaves_equal(je, te)
    _leaves_equal(jred.consolidate_accums(jc), tred.consolidate_accums(tc))


def _bucket_tables(depth):
    """A state whose hash bucket 7 holds `depth` distinct keys, and probes
    that hit its far end (found only by the widened scan, or not at all)."""
    h = np.sort(np.concatenate([np.full(depth, 7), np.arange(20, 26)])).astype(np.uint32)
    h = np.concatenate([h, np.full(128 - len(h), 0xFFFFFFFF, dtype=np.uint32)])
    keys = np.arange(128, dtype=np.int64)
    acc = np.arange(128, dtype=np.int64) * 10
    nrows = (h != 0xFFFFFFFF).astype(np.int64)
    ph = np.array([7, 7, 21, 7, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF], dtype=np.uint32)
    pk = np.array([depth - 1, 1, 7 + depth - 6, 999, 0, 0, 0, 0], dtype=np.int64)
    pa = np.zeros(8, dtype=np.int64)
    state = (h, (keys,), (acc,), nrows)
    probe = (ph, (pk,), (pa,), pa)
    return state, probe


def _both_accums(spec):
    h, keys, accs, nrows = spec
    j = jred.AccumState(jnp.asarray(h), tuple(jnp.asarray(k) for k in keys),
                        tuple(jnp.asarray(a) for a in accs), jnp.asarray(nrows))
    t = tred.AccumState(torch.from_numpy(h.astype(np.int64)),
                        tuple(torch.from_numpy(k) for k in keys),
                        tuple(torch.from_numpy(a) for a in accs), torch.from_numpy(nrows))
    return j, t


@pytest.mark.parametrize("depth", [10, 70])  # widened scan resolves / still misses
def test_lookup_accums_widening_matches_jax(depth):
    s_spec, p_spec = _bucket_tables(depth)
    js, ts = _both_accums(s_spec)
    jp, tp = _both_accums(p_spec)
    syncs = tred.HOST_SYNCS["lookup_widen"]
    jl, tl = jred.lookup_accums(js, jp), tred.lookup_accums(ts, tp)
    assert tred.HOST_SYNCS["lookup_widen"] == syncs + 1
    for a, b in zip(jax.tree_util.tree_leaves(jl), jax.tree_util.tree_leaves(list(tl))):
        _same(b, a)
    found, missed = tl[0].numpy(), tl[3].numpy()
    assert found[0] == (depth <= 64) and missed[0] == (depth > 64)
