"""A CPU rehearsal of the tile kernel of `probe` and `probe2` (csrc/probe.cu).

The CUDA kernel runs only on the card. This file keeps a numpy model of its
design, templated over the key as the kernel is (one int64 column for
`probe`, the (hi, lo) pair for `probe2`), with the tile, the staged window
and the warp width as parameters, at tiny sizes (tiles of 4 or 8 queries,
windows of 8 or 16 rows, 4-lane warps), so that every branch is taken at
n, m <= 200 on both sides:

- the tile boundaries: tiles of `tile` consecutive queries, a ragged last one;
- the warp-wide search for lb and ub of a tile's first and last query, one
  probe a lane a level (32 lanes; here 4);
- the all-equal tile, answered from those alone;
- the staged window [ub(first), lb(last)) and the in-window search, which
  must read only rows inside the staged window;
- the wide window, split into sub-windows by a staged sample of every
  stride-th row; each query searches the sample, then only the rows inside
  its own sub-window by a 3-way search (checked: no other row is read);
- the per-thread full-depth search of an unsorted tile.

Each case holds the model against the port's `plain_searchsorted` or
`plain_searchsorted2` and JAX's `_xla_searchsorted` or `_xla_searchsorted2`
on the same seeded numpy inputs, and checks that the branch it was built for
was taken.
"""

import tracemalloc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from materialize_tpu.ops.kernels.probe import _xla_searchsorted, _xla_searchsorted2
from materialize_tpu_torch.ops.kernels import probe

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


PAD = 0xFFFFFFFF
LANES = 4  # a warp's lanes
WAYS = 3  # probes a level of the search between two samples


def _pred(row, q, right):
    """Row `row` lies before the insertion point of `q` (keys are tuples,
    compared lexicographically)."""
    return row <= q if right else row < q


class _Rows:
    """Rows [lo, hi) of the key columns `cols`; reading any other row fails,
    as a read outside the staged window or sub-window would be a fault of the
    kernel."""

    def __init__(self, cols, lo=0, hi=None):
        self.cols, self.lo = cols, lo
        self.hi = len(cols[0]) if hi is None else hi

    def __getitem__(self, i):
        assert self.lo <= i < self.hi, f"row {i} outside [{self.lo}, {self.hi})"
        return tuple(int(c[i]) for c in self.cols)


class _Staged:
    """The sample staged in shared memory: entry i is row lo + i * stride."""

    def __init__(self, a, lo, stride, count):
        self.rows = [a[lo + i * stride] for i in range(count)]

    def __getitem__(self, i):
        return self.rows[i]


def _warp_search(a, lo, hi, q, right):
    """The kernel's warp_search over rows [lo, hi): per level, LANES evenly
    spaced probes and a count of those that satisfy the predicate."""
    while hi - lo > LANES:
        step = (hi - lo + LANES - 1) // LANES
        k = 0
        for lane in range(LANES):
            i = lo + (lane + 1) * step - 1
            k += i < hi and _pred(a[i], q, right)
        lo, hi = lo + k * step, min(hi, lo + (k + 1) * step - 1)
    return lo + sum(lo + lane < hi and _pred(a[lo + lane], q, right) for lane in range(LANES))


def _search_rows(a, lo, hi, qs, right):
    """The kernel's search_rows: the reference's unrolled loop over [lo, hi)."""
    pos = [lo] * len(qs)
    if hi <= lo:
        return pos
    cur = hi - lo
    while cur > 1:
        half = cur >> 1
        pos = [p + half if _pred(a[p + half - 1], q, right) else p for p, q in zip(pos, qs)]
        cur -= half
    return [p + _pred(a[p], q, right) for p, q in zip(pos, qs)]


def _search_between(a_cols, los, his, qs, right):
    """The kernel's search_between: for each query a WAYS-way search of its
    own rows [lo, hi), the rows past them taken as larger than any query.
    Each query reads only its own rows."""
    out = []
    for lo, hi, q in zip(los, his, qs):
        rows, pos, top = _Rows(a_cols, lo, hi), lo, hi
        while top - pos > WAYS:
            step = (top - pos + WAYS - 1) // WAYS
            t = sum(pos + u * step - 1 < top and _pred(rows[pos + u * step - 1], q, right)
                    for u in range(1, WAYS + 1))
            pos, top = pos + t * step, min(top, pos + (t + 1) * step - 1)
        out.append(pos + sum(pos + u < top and _pred(rows[pos + u], q, right)
                             for u in range(WAYS)))
    return out


def tile_search(a_cols, q_cols, side, tile, window):
    """The kernel's output, the branches its tiles took and the largest
    stride it sampled with, for tiles of `tile` queries and `window` rows
    staged."""
    right = side == "right"
    n, m = len(a_cols[0]), len(q_cols[0])
    a = _Rows(a_cols)
    out = np.empty(m, dtype=np.int64)
    branches, largest_stride = set(), 0
    for base in range(0, m, tile):
        qs = [tuple(int(c[j]) for c in q_cols) for j in range(base, min(base + tile, m))]
        first, last = qs[0], qs[-1]
        lb_f, ub_f = (_warp_search(a, 0, n, first, r) for r in (False, True))
        lb_l, ub_l = (_warp_search(a, 0, n, last, r) for r in (False, True))
        if any(qs[i] < qs[i - 1] for i in range(1, len(qs))):
            branches.add("unsorted")
            pos = _search_rows(a, 0, n, qs, right)
        else:
            wlo, whi = ub_f, lb_l
            w = whi - wlo
            stride = 1 if w <= window else -(-w // window)
            if first == last:
                branches.add("all_equal")
                pos = [0] * len(qs)
            else:
                count = -(-w // stride)
                sample = _Staged(_Rows(a_cols, wlo, whi), wlo, stride, count)
                c = _search_rows(sample, 0, count, qs, right)
                los = [wlo if ci == 0 else wlo + (ci - 1) * stride + 1 for ci in c]
                his = [whi if ci == count else wlo + ci * stride for ci in c]
                if stride == 1:
                    branches.add("staged")
                    pos = los
                else:
                    branches.add("sampled")
                    largest_stride = max(largest_stride, stride)
                    pos = _search_between(a_cols, los, his, qs, right)
            r_first, r_last = (ub_f, ub_l) if right else (lb_f, lb_l)
            pos = [r_first if q == first else r_last if q == last else p
                   for p, q in zip(pos, qs)]
        out[base:base + len(qs)] = pos
    return out, branches, largest_stride


def _sorted_pairs(rng, n, hi_range, lo_range, n_pad=0):
    hi = rng.integers(0, hi_range, n)
    lo = rng.integers(0, lo_range, n)
    hi[n - n_pad:] = PAD
    lo[n - n_pad:] = 0
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


def _sorted(rng, n, lo, hi, n_pad=0):
    x = np.sort(rng.integers(lo, hi, n))
    x[n - n_pad:] = PAD
    return x


def _case2(name, rng, tile):
    """(a_hi, a_lo, q_hi, q_lo, the branch the case is built to reach)."""
    if name == "window_fits":  # dense runs of one distribution
        ah, al = _sorted_pairs(rng, 120, 64, 4)
        qh, ql = _sorted_pairs(rng, 110, 64, 4)
        return ah, al, qh, ql, "staged"
    if name == "window_too_large":  # few queries spread over a large `a`
        ah, al = _sorted_pairs(rng, 200, 1 << 20, 1 << 20)
        qh, ql = _sorted_pairs(rng, 3 * tile, 1 << 20, 1 << 20)
        return ah, al, qh, ql, "sampled"
    if name == "wide_dense":  # windows of two to three staged windows
        ah, al = _sorted_pairs(rng, 200, 1 << 20, 4)
        qh, ql = _sorted_pairs(rng, 60, 1 << 20, 4)
        return ah, al, qh, ql, "sampled"
    if name == "padding_tiles":  # a merge of two padded runs: PAD_HASH tails
        ah, al = _sorted_pairs(rng, 150, 1 << 16, 8, n_pad=70)
        qh, ql = _sorted_pairs(rng, 100, 1 << 16, 8, n_pad=45)
        return ah, al, qh, ql, "all_equal"
    if name == "unsorted":
        ah, al = _sorted_pairs(rng, 90, 40, 5)
        return ah, al, rng.integers(-2, 45, 70), rng.integers(-1, 6, 70), "unsorted"
    if name == "hi_ties_broken_on_lo":  # few q_hi values, sorted on q_lo within
        ah, al = _sorted_pairs(rng, 100, 3, 1 << 10)
        qh, ql = _sorted_pairs(rng, 100, 3, 1 << 10)
        return ah, al, qh, ql, "staged"
    if name == "ragged_last_tile":
        ah, al = _sorted_pairs(rng, 60, 50, 3)
        qh, ql = _sorted_pairs(rng, 5 * tile + 3, 50, 3)
        return ah, al, qh, ql, "staged"
    if name == "n_is_1":
        qh, ql = _sorted_pairs(rng, 2 * tile + 1, 4, 3)
        return np.array([2]), np.array([1]), qh, ql, "staged"
    if name == "m_is_1":
        ah, al = _sorted_pairs(rng, 50, 10, 3)
        return ah, al, np.array([5]), np.array([1]), "all_equal"
    if name == "m_below_tile_below_n":  # one tile of queries close together
        ah, al = _sorted_pairs(rng, 150, 8, 64)
        ql = np.sort(rng.integers(10, 14, tile - 1))
        return ah, al, np.full(tile - 1, 3), ql, "staged"
    if name == "negative_queries":  # q_hi and q_lo below every row of `a`
        ah, al = _sorted_pairs(rng, 80, 20, 4)
        qh, ql = _sorted_pairs(rng, 40, 20, 4)
        qh[:tile + 1] = -3 + np.arange(tile + 1) // 3
        ql[:tile + 1] = -np.arange(tile + 1)[::-1]
        order = np.lexsort((ql, qh))
        return ah, al, qh[order], ql[order], "staged"
    raise KeyError(name)


def _case1(name, rng, tile):
    """(a, q, the branch the case is built to reach, the least stride of a
    sampled case)."""
    if name == "window_fits":
        return _sorted(rng, 120, 0, 64), _sorted(rng, 110, 0, 64), "staged", 0
    if name == "wide_dense":  # windows of two to three staged windows
        return _sorted(rng, 200, 0, 1 << 20), _sorted(rng, 60, 0, 1 << 20), "sampled", 2
    if name == "wide_sparse":  # few queries over a large `a`: strides of several rows
        a, q = _sorted(rng, 200, 0, 1 << 20), _sorted(rng, 3 * tile, 0, 1 << 20)
        return a, q, "sampled", WAYS + 1
    if name == "one_sparse_warp":  # a tile with spread and packed queries
        a = np.arange(150) * 4
        q = np.concatenate([np.linspace(0, 400, tile // 2).astype(np.int64),
                            500 + np.arange(tile - tile // 2)])
        return a, q, "sampled", 2
    if name == "padding_tiles":
        return (_sorted(rng, 150, 0, 1 << 16, n_pad=70), _sorted(rng, 100, 0, 1 << 16, n_pad=45),
                "all_equal", 0)
    if name == "unsorted":
        return _sorted(rng, 90, 0, 40), rng.integers(-2, 45, 70), "unsorted", 0
    if name == "duplicate_runs":  # runs of equal keys in `a` and across the queries
        return _sorted(rng, 160, 0, 12), _sorted(rng, 90, -1, 14), "staged", 0
    if name == "prefix_sum_arange":  # the join's search of `arange` in a prefix sum
        cum = np.cumsum(np.where(rng.random(120) < 0.3, rng.integers(0, 4, 120), 0))
        return cum, np.arange(int(cum[-1]) + 2 * tile), "staged", 0
    if name == "ragged_last_tile":
        return _sorted(rng, 60, 0, 50), _sorted(rng, 5 * tile + 3, 0, 50), "staged", 0
    if name == "n_is_1":
        return np.array([2]), _sorted(rng, 2 * tile + 1, 0, 4), "staged", 0
    if name == "m_is_1":
        return _sorted(rng, 50, 0, 10), np.array([5]), "all_equal", 0
    if name == "negative_queries":
        return _sorted(rng, 80, 0, 20), _sorted(rng, 3 * tile, -(1 << 40), 20), "staged", 0
    raise KeyError(name)


CASES2 = ["window_fits", "window_too_large", "padding_tiles", "unsorted",
          "hi_ties_broken_on_lo", "ragged_last_tile", "n_is_1", "m_is_1",
          "m_below_tile_below_n", "negative_queries", "wide_dense"]
CASES1 = ["window_fits", "wide_dense", "wide_sparse", "one_sparse_warp", "padding_tiles",
          "unsorted", "duplicate_runs", "prefix_sum_arange", "ragged_last_tile", "n_is_1",
          "m_is_1", "negative_queries"]


@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("case", CASES2)
def test_staged_probe2_model_equals_plain_and_jax(case, side, tile):
    rng = np.random.default_rng(CASES2.index(case) * 10 + tile + (side == "right"))
    ah, al, qh, ql, branch = _case2(case, rng, tile)
    cols = [np.asarray(x, dtype=np.int64) for x in (ah, al, qh, ql)]
    got, branches, _stride = tile_search(cols[:2], cols[2:], side, tile=tile, window=2 * tile)
    assert branch in branches, (branch, branches)
    want = probe.plain_searchsorted2(*(torch.from_numpy(c) for c in cols), side)
    np.testing.assert_array_equal(got, want.numpy())
    ref = _xla_searchsorted2(*(jnp.asarray(c) for c in cols), side)
    np.testing.assert_array_equal(got, np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("case", CASES1)
def test_staged_probe_model_equals_plain_and_jax(case, side, tile):
    """The same tile kernel over one int64 key, as `probe` instantiates it."""
    rng = np.random.default_rng(100 + CASES1.index(case) * 10 + tile + (side == "right"))
    a, q, branch, least_stride = _case1(case, rng, tile)
    a, q = np.asarray(a, dtype=np.int64), np.asarray(q, dtype=np.int64)
    got, branches, stride = tile_search([a], [q], side, tile=tile, window=2 * tile)
    assert branch in branches, (branch, branches)
    assert stride >= least_stride, stride
    want = probe.plain_searchsorted(torch.from_numpy(a), torch.from_numpy(q), side)
    np.testing.assert_array_equal(got, want.numpy())
    ref = _xla_searchsorted(jnp.asarray(a), jnp.asarray(q), side)
    np.testing.assert_array_equal(got, np.asarray(ref).astype(np.int64))
