"""A CPU rehearsal of the staged `probe2` kernel (csrc/probe.cu).

The CUDA kernel runs only on the card. This file keeps a numpy model of its
design, with the tile, the window and the warp width as parameters, at tiny
sizes (tiles of 4 or 8 queries, windows of 8 or 16 rows, 4-lane warps), so
that every branch is taken at n, m <= 200 on both sides:

- the tile boundaries: tiles of `tile` consecutive queries, a ragged last one;
- the 32-way (here 4-way) warp search for lb and ub of a tile's first and
  last query;
- the window [ub(first), lb(last)) of `a` and the in-window search, which
  must read only rows inside the staged window;
- the wide-window search in global memory within the window's bounds, the
  all-equal tile, and the per-thread full-depth search of an unsorted tile.

Each case holds the model against the port's `plain_searchsorted2` and JAX's
`_xla_searchsorted2` on the same seeded numpy inputs, and checks that the
branch it was built for was taken.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from materialize_tpu.ops.kernels.probe import _xla_searchsorted2
from materialize_tpu_torch.ops.kernels import probe

torch.set_num_threads(1)

PAD = 0xFFFFFFFF
LANES = 4


def _pred2(ah, al, qh, ql, right):
    return ah < qh or (ah == qh and (al <= ql if right else al < ql))


def _pair_le(ah, al, bh, bl):
    return ah < bh or (ah == bh and al <= bl)


class _Rows:
    """Rows [base, base + len) of `a`; reading any other row fails, as a
    read outside the staged window would be a fault of the kernel."""

    def __init__(self, ah, al, base=0):
        self.ah, self.al, self.base = ah, al, base

    def __getitem__(self, i):
        j = i - self.base
        assert 0 <= j < len(self.ah), f"row {i} outside [{self.base}, {self.base + len(self.ah)})"
        return int(self.ah[j]), int(self.al[j])


def _warp_search(a, n, qh, ql, right):
    """The kernel's warp_search: per level, LANES evenly spaced probes and a
    count of those that satisfy the predicate."""
    lo, hi = 0, n
    while hi - lo > LANES:
        step = (hi - lo + LANES - 1) // LANES
        k = 0
        for lane in range(LANES):
            i = lo + (lane + 1) * step - 1
            k += i < hi and _pred2(*a[i], qh, ql, right)
        lo, hi = lo + k * step, min(hi, lo + (k + 1) * step - 1)
    return lo + sum(lo + lane < hi and _pred2(*a[lo + lane], qh, ql, right)
                    for lane in range(LANES))


def _search_rows(a, lo, hi, qh, ql, right):
    """The kernel's search_rows: the reference's unrolled loop over [lo, hi)."""
    pos = [lo] * len(qh)
    if hi <= lo:
        return pos
    cur = hi - lo
    while cur > 1:
        half = cur >> 1
        pos = [p + half if _pred2(*a[p + half - 1], h, l, right) else p
               for p, h, l in zip(pos, qh, ql)]
        cur -= half
    return [p + _pred2(*a[p], h, l, right) for p, h, l in zip(pos, qh, ql)]


def staged_probe2(ah, al, qh, ql, side, tile, window):
    """The kernel's output and the set of branches its tiles took."""
    right = side == "right"
    n, m = len(ah), len(qh)
    a = _Rows(ah, al)
    out = np.empty(m, dtype=np.int64)
    branches = set()
    for base in range(0, m, tile):
        th, tl = [int(x) for x in qh[base:base + tile]], [int(x) for x in ql[base:base + tile]]
        fh, fl, lh, ll = th[0], tl[0], th[-1], tl[-1]
        lb_f, ub_f = _warp_search(a, n, fh, fl, False), _warp_search(a, n, fh, fl, True)
        lb_l, ub_l = _warp_search(a, n, lh, ll, False), _warp_search(a, n, lh, ll, True)
        ordered = all(_pair_le(th[i - 1], tl[i - 1], th[i], tl[i]) for i in range(1, len(th)))
        if not ordered:
            branches.add("unsorted")
            pos = _search_rows(a, 0, n, th, tl, right)
        else:
            wlo, whi = ub_f, lb_l
            if fh == lh and fl == ll:
                branches.add("all_equal")
                pos = [0] * len(th)
            elif whi - wlo <= window:
                branches.add("staged")
                win = _Rows(ah[wlo:whi].copy(), al[wlo:whi].copy(), wlo)
                pos = _search_rows(win, wlo, whi, th, tl, right)
            else:
                branches.add("wide")
                pos = _search_rows(a, wlo, whi, th, tl, right)
            r_first, r_last = (ub_f, ub_l) if right else (lb_f, lb_l)
            pos = [r_first if (h, l) == (fh, fl) else r_last if (h, l) == (lh, ll) else p
                   for p, h, l in zip(pos, th, tl)]
        out[base:base + len(th)] = pos
    return out, branches


def _sorted_pairs(rng, n, hi_range, lo_range, n_pad=0):
    hi = rng.integers(0, hi_range, n)
    lo = rng.integers(0, lo_range, n)
    hi[n - n_pad:] = PAD
    lo[n - n_pad:] = 0
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


def _case(name, rng, tile):
    """(a_hi, a_lo, q_hi, q_lo, the branch the case is built to reach)."""
    if name == "window_fits":  # dense runs of one distribution
        ah, al = _sorted_pairs(rng, 120, 64, 4)
        qh, ql = _sorted_pairs(rng, 110, 64, 4)
        return ah, al, qh, ql, "staged"
    if name == "window_too_large":  # few queries spread over a large `a`
        ah, al = _sorted_pairs(rng, 200, 1 << 20, 1 << 20)
        qh, ql = _sorted_pairs(rng, 3 * tile, 1 << 20, 1 << 20)
        return ah, al, qh, ql, "wide"
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


CASES = ["window_fits", "window_too_large", "padding_tiles", "unsorted",
         "hi_ties_broken_on_lo", "ragged_last_tile", "n_is_1", "m_is_1",
         "m_below_tile_below_n", "negative_queries"]


@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("case", CASES)
def test_staged_probe2_model_equals_plain_and_jax(case, side, tile):
    rng = np.random.default_rng(CASES.index(case) * 10 + tile + (side == "right"))
    ah, al, qh, ql, branch = _case(case, rng, tile)
    cols = [np.asarray(x, dtype=np.int64) for x in (ah, al, qh, ql)]
    got, branches = staged_probe2(*cols, side, tile=tile, window=2 * tile)
    assert branch in branches, (branch, branches)
    want = probe.plain_searchsorted2(*(torch.from_numpy(c) for c in cols), side)
    np.testing.assert_array_equal(got, want.numpy())
    ref = _xla_searchsorted2(*(jnp.asarray(c) for c in cols), side)
    np.testing.assert_array_equal(got, np.asarray(ref).astype(np.int64))
