"""A CPU rehearsal of the one-pass run_sum kernel (csrc/run_sum.cu).

The CUDA kernel runs only on the card. This file keeps a numpy model of its
design with the tile, the rows a thread, the look-back step and the
columns a launch as parameters, at tiny sizes (tiles of 8 rows, look-back
steps of 2 to 4 tiles, 2 columns a launch):

- tickets: blocks take tiles right to left, tile nt - 1 - ticket; a wave of
  `in_flight` tiles is resident at once, and within a wave the tile that
  started last looks back first, so it finds every other tile of its wave
  with only its aggregate published (the longest look-back);
- the tile scan: each thread's chunk of rows, cub's exclusive scan over the
  threads in rank order (chunks right to left) under SegCombine, out[]
  written for every row with nothing coming in from the right;
- the status words: a tile that holds a run end publishes its inclusive
  value at once, any other its aggregate;
- the look-back: `lanes` * `look` tiles a step (`look` consecutive tiles a
  lane; the kernel checks 32 tiles a step, one a lane), summing aggregates
  up to the first inclusive tile; a tile whose last row ends a run skips it;
- the one row after the tile's last run end, rewritten with the sum coming
  in from the right;
- every column in uint64 arithmetic, stored at its own width (int32 and
  int64 mixed), more columns than a launch takes split into launches.

Each case holds the model against the port's `plain_run_sum` and JAX's
`_xla_run_sum` on the same seeded numpy inputs, and checks that what the
case was built to reach happened.
"""

import tracemalloc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from materialize_tpu.ops.kernels.segsum import _xla_run_sum
from materialize_tpu_torch.ops.kernels import segsum

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


M64 = (1 << 64) - 1


def _combine(right, left):
    """SegCombine: `left` is the new segment to the left of `right`."""
    return ((left[0] if left[1] else left[0] + right[0]) & M64, left[1] | right[1])


def _to_width(x, dtype):
    bits = np.dtype(dtype).itemsize * 8
    x &= (1 << bits) - 1
    return x - (1 << bits) if x >> (bits - 1) else x


def scan_model(rs, cols, threads, items, lanes, look, in_flight, max_cols):
    """The kernel's outputs and what happened (a set of event names)."""
    n, tile = len(rs), threads * items
    nt = -(-n // tile)
    events = set()
    outs = [np.zeros(n, dtype=c.dtype) for c in cols]
    if -(-len(cols) // max_cols) > 1:
        events.add("several_launches")
    for c0 in range(0, len(cols), max_cols):
        group = list(range(c0, min(c0 + max_cols, len(cols))))
        vals = [[int(x) & ((1 << (8 * cols[c].dtype.itemsize)) - 1) for x in cols[c]]
                for c in group]
        status = [0] * nt
        aggr, incl, tiles = {}, {}, {}
        order = []

        def end(i):
            return i + 1 >= n or bool(rs[i + 1])

        def scan_tile(p):
            t0 = p * tile
            last_row = min(t0 + tile, n) - 1
            ends = [t0 + r for r in range(tile) if t0 + r < n and end(t0 + r)]
            open_ = (ends[-1] - t0 if ends else -1) + 1
            agg, open_s = [], []
            for ci, v in enumerate(vals):
                # thread rank t owns chunk threads - 1 - t; cub scans in rank order
                mine = []
                for t in range(threads):
                    seg = (0, 0)
                    for k in reversed(range(items)):
                        i = t0 + (threads - 1 - t) * items + k
                        x, e = (v[i], end(i)) if i < n else (0, True)
                        seg = _combine(seg, (x, int(e)))
                    mine.append(seg)
                carry, acc = [], (0, 0)
                for seg in mine:
                    carry.append(acc)
                    acc = _combine(acc, seg)
                agg.append(acc)
                s_open = None
                for t in range(threads):
                    right = carry[t][0]
                    for k in reversed(range(items)):
                        r = (threads - 1 - t) * items + k
                        i = t0 + r
                        x, e = (v[i], end(i)) if i < n else (0, True)
                        right = x if e else (x + right) & M64
                        if r == open_:
                            s_open = right
                        if i < n:
                            outs[group[ci]][i] = _to_width(right, cols[group[ci]].dtype) \
                                if rs[i] else 0
                open_s.append(s_open)
            holds_end = agg[0][1] == 1
            if holds_end:
                incl[p], status[p] = [a[0] for a in agg], 2
            else:
                aggr[p], status[p] = [a[0] for a in agg], 1
            tiles[p] = (t0, last_row, open_, open_s, holds_end)

        def look_back(p):
            t0, last_row, open_, open_s, holds_end = tiles[p]
            if t0 + open_ - 1 == last_row:
                events.add("last_row_ends_a_run")
                return
            inc, j0, windows, summed = [0] * len(vals), p + 1, 0, 0
            while True:
                windows += 1
                # lane l checks tiles j0 + l * look + u, u < look
                js = [j0 + lane * look + u for lane in range(lanes) for u in range(look)]
                st = [status[j] if j < nt else 2 for j in js]
                # every tile to the right took an earlier ticket: it has published
                assert 0 not in st, "a look-back reached a tile that has not started"
                upto = st.index(2) if 2 in st else len(js) - 1
                for at in range(upto + 1):
                    j = js[at]
                    if j < nt:
                        src = incl[j] if st[at] == 2 else aggr[j]
                        summed += st[at] == 1
                        inc = [(a + b) & M64 for a, b in zip(inc, src)]
                if 2 in st:
                    break
                j0 += lanes * look
            if summed >= 3:
                events.add("look_back_over_3_aggregates")
            if windows > 1:
                events.add("look_back_over_several_windows")
            if not holds_end:
                incl[p] = [(a + b) & M64 for a, b in zip(aggr[p], inc)]
                status[p] = 2
            r = t0 + open_
            if r <= last_row and rs[r]:
                events.add("open_row_rewritten")
                for ci, c in enumerate(group):
                    outs[c][r] = _to_width(open_s[ci] + inc[ci], cols[c].dtype)

        for w0 in range(0, nt, in_flight):
            wave = [nt - 1 - t for t in range(w0, min(w0 + in_flight, nt))]
            for p in wave:
                order.append(p)
                scan_tile(p)
            for p in reversed(wave):
                look_back(p)
        assert order == list(range(nt - 1, -1, -1))
        events.add("ticket_order")
    if not rs[0] and n > 1:
        events.add("rows_before_the_first_run_start")
    return outs, events


def _cols(rng, n, widths):
    return [rng.integers(-(1 << 62), 1 << 62, n) if w == 8
            else rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32) for w in widths]


def _case(name, rng, tile, k):
    """(run starts, columns, the event the case is built to reach)."""
    widths = [8, 4, 8][:k]
    n = 5 * tile + 3
    if name == "tickets_right_to_left":
        rs = rng.random(n) < 0.3
        rs[0] = True
        return rs, _cols(rng, n, widths), "ticket_order"
    if name == "one_run_over_5_tiles":
        return np.arange(n) == 0, _cols(rng, n, widths), "look_back_over_3_aggregates"
    if name == "run_ends_at_a_tile_edge":
        return np.arange(n) % tile == 0, _cols(rng, n, widths), "last_row_ends_a_run"
    if name == "rows_before_the_first_run_start":
        rs = (rng.random(n) < 0.2) & (np.arange(n) > tile + 2)
        return rs, _cols(rng, n, widths), "rows_before_the_first_run_start"
    if name == "open_row_needs_the_right":
        rs = np.arange(n) % (tile + 3) == 0
        return rs, _cols(rng, n, widths), "open_row_rewritten"
    if name == "wrapping_sums":
        cols = [np.full(n, np.iinfo(np.int64).max - 3), np.full(n, (1 << 31) - 5, np.int32),
                np.full(n, np.iinfo(np.int64).min + 2)][:k]
        return np.arange(n) == 0, cols, "look_back_over_3_aggregates"
    if name == "trailing_padding_run":  # live rows, then one run over many tiles
        m = 12 * tile + 5
        rs = rng.random(m) < 0.4
        rs[0], rs[2 * tile + 1:] = True, False
        rs[2 * tile + 1] = True
        return rs, _cols(rng, m, widths), "look_back_over_several_windows"
    if name == "n_is_tile_plus_1":
        rs = rng.random(tile + 1) < 0.3
        rs[0] = True
        return rs, _cols(rng, tile + 1, widths), "ticket_order"
    if name == "n_is_1":
        return np.array([True]), _cols(rng, 1, widths), "last_row_ends_a_run"
    raise KeyError(name)


CASES = ["tickets_right_to_left", "one_run_over_5_tiles", "run_ends_at_a_tile_edge",
         "rows_before_the_first_run_start", "open_row_needs_the_right", "wrapping_sums",
         "trailing_padding_run", "n_is_tile_plus_1", "n_is_1"]
# (threads, rows a thread, look-back lanes, tiles a lane, tiles in flight):
# tiles of 8 rows
SHAPES = [(4, 2, 2, 1, 6), (2, 4, 2, 2, 6)]


def _check(rs, cols, shape, want_event, max_cols=2):
    got, events = scan_model(rs, cols, *shape, max_cols=max_cols)
    assert want_event in events, (want_event, events)
    want = segsum.plain_run_sum(torch.from_numpy(rs), tuple(torch.from_numpy(c) for c in cols))
    ref = _xla_run_sum(jnp.asarray(rs), tuple(jnp.asarray(c) for c in cols))
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(g, np.asarray(r))
    return events


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_run_sum_scan_model_equals_plain_and_jax(case, k, shape):
    rng = np.random.default_rng(CASES.index(case) * 10 + k)
    rs, cols, event = _case(case, rng, shape[0] * shape[1], k)
    _check(rs, cols, shape, event)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_run_sum_scan_model_splits_columns_into_launches(shape):
    """Five mixed-width columns at two a launch: three launches, each with
    its own tickets and status words."""
    rng = np.random.default_rng(7)
    n = 4 * shape[0] * shape[1] + 5
    rs = rng.random(n) < 0.25
    rs[0] = True
    events = _check(rs, _cols(rng, n, [4, 8, 8, 4, 8]), shape, "several_launches")
    assert "ticket_order" in events
