"""A CPU rehearsal of the one-pass bucket_rank kernel (csrc/route.cu).

The CUDA kernel runs only on the card. This file keeps a numpy model of its
design with the threads, the rows a thread, the warp, the rows a group and
the look-back step as parameters, at tiny sizes (tiles of 8 rows, look-back
steps of 2 to 4 tiles):

- tickets: blocks take tiles left to right, tile = ticket; at most
  `in_flight` tiles are resident, and a finished tile frees its slot for
  the next ticket;
- the schedule: each resident tile runs as a coroutine that pauses before it
  publishes, and the scheduler resumes the last-started tile first, so a
  tile reaches its look-back while the tiles to its left have not yet
  published (it must wait) or have published only "no run start"; a
  seeded random schedule is the other policy. A look-back that waits on a
  tile that has not started would stall every resident tile: the scheduler
  fails then;
- the tile scan: a warp's rows as groups of consecutive rows striped over
  its lanes (the kernel: one 16-byte vector a group), the key before each
  group (the previous lane's last, lane 31's of the previous group, or for
  the warp's first row from memory), the values run_start ? i : -1, their
  max-scan in row order within each warp, and the warps' maxima combined;
- the status word, one 32-bit word: 0 not published, 1 no run start,
  2 + p the inclusive prefix maximum p; a tile publishes at once (2 + its
  largest run start, or 1);
- the look-back, only if the tile's first row starts no run: `lanes` lanes
  of `look` tiles a step (the kernel: 32 lanes), skipping 1s, waiting only
  while the nearest word that is not 1 reads 0, stopping at the nearest
  2 + p; a tile without a run start then republishes 2 + carry;
- every row written once: at once in a tile that does not look back, else
  after the look-back.

Each case holds the model against the port's `plain_bucket_rank` and JAX's
`_xla_bucket_rank` on the same seeded numpy keys, and checks that what the
case was built to reach happened.
"""

import tracemalloc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from materialize_tpu.ops.kernels.route import _xla_bucket_rank
from materialize_tpu_torch.ops.kernels import route

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


NONE, INCLUSIVE = 1, 2


def scan_model(key, threads, items, warp, group, lanes, look, in_flight, policy, seed=0):
    """The kernel's output and what happened (a dict of counters)."""
    n, tile = len(key), threads * items
    nt = -(-n // tile)
    status = [0] * nt
    out = np.zeros(n, dtype=np.int64)
    writes = np.zeros(n, dtype=np.int64)
    ev = {"looked_back": 0, "longest_look_back": 0, "steps": 0, "waits": 0, "skipped": 0,
          "republished": 0, "stopped_at_republished": 0}
    republished = set()

    def rows_of(t0, t):
        """Thread t's rows: groups of `group` consecutive rows, the warp's
        lanes taking consecutive groups (group == items: kItems rows a thread)."""
        w0, lane = t0 + (t // warp) * warp * items, t % warp
        return [w0 + ((k // group) * warp + lane) * group + k % group for k in range(items)]

    def write(rows, r, carry):
        for i, s in zip(rows, r):
            if i < n:
                out[i] = i - (carry if s < 0 else s)
                writes[i] += 1

    def look_back(p):
        """Warp 0's look-back: yields while it waits; returns the carry."""
        j0, steps = p - 1, 0
        while True:
            steps += 1
            # lane l reads tiles j0 - l * look - u, u < look, once; only the
            # words that read 0 are read again
            js = [j0 - lane * look - u for lane in range(lanes) for u in range(look)]
            words = [status[j] if j >= 0 else NONE for j in js]
            while True:
                near = next((at for at, w in enumerate(words) if w != NONE), None)
                if near is None:
                    break  # no tile of this step holds a run start: further left
                j, w = js[near], words[near]
                if w >= INCLUSIVE:
                    ev["skipped"] += p - 1 - j
                    ev["steps"] = max(ev["steps"], steps)
                    ev["longest_look_back"] = max(ev["longest_look_back"], p - j)
                    ev["stopped_at_republished"] += j in republished
                    return w - INCLUSIVE
                ev["waits"] += 1
                yield "wait"  # the nearest such tile has not published
                words = [status[j] if w == 0 else w for j, w in zip(js, words)]
            j0 -= lanes * look

    def tile_proc(p):
        t0 = p * tile
        rows = [rows_of(t0, t) for t in range(threads)]
        xs = [[int(key[i]) if i < n else 0 for i in rs_] for rs_ in rows]
        rs = []
        for t in range(threads):
            lane, r = t % warp, []
            for k, i in enumerate(rows[t]):
                g, c = divmod(k, group)
                if c:  # the thread's previous row
                    prev = xs[t][k - 1]
                elif lane:  # the previous lane's last row of the group (a shuffle)
                    prev = xs[t - 1][k + group - 1]
                elif g:  # lane 31's last row of the previous group
                    prev = xs[t + warp - 1][k - 1]
                else:  # the warp's first row: the key before it, from memory
                    prev = int(key[i - 1]) if 0 < i < n else 0
                r.append(i if i < n and (i == 0 or xs[t][k] != prev) else -1)
            rs.append(r)
        # the inclusive max-scan in row order: per warp over (group, lane,
        # row), then each warp's maximum combined in shared memory
        agg = -1
        for w0 in range(0, threads, warp):
            run = -1
            for g in range(items // group):
                for t in range(w0, w0 + warp):
                    for k in range(g * group, (g + 1) * group):
                        run = max(run, rs[t][k])
                        rs[t][k] = run
            for t in range(w0, w0 + warp):
                rs[t] = [max(s, agg) for s in rs[t]]
            agg = max(agg, run)
        yield "scanned"  # resident and scanned, not yet published
        status[p] = INCLUSIVE + agg if agg >= 0 else NONE
        if p == 0 or key[t0] != key[t0 - 1]:  # no row needs the carry
            for t in range(threads):
                write(rows[t], rs[t], 0)
            return
        ev["looked_back"] += 1
        carry = yield from look_back(p)
        if agg < 0:
            status[p] = INCLUSIVE + carry
            republished.add(p)
            ev["republished"] += 1
        for t in range(threads):
            write(rows[t], rs[t], carry)

    rng = np.random.default_rng(seed)
    ticket, resident = 0, []  # resident: [tile, coroutine], in start order
    while ticket < nt or resident:
        while ticket < nt and len(resident) < in_flight:
            resident.append([ticket, tile_proc(ticket)])
            ticket += 1
        order = (list(reversed(range(len(resident)))) if policy == "last_first"
                 else list(rng.permutation(len(resident))))
        progressed = False  # a tile scanned, published, or finished
        for at in order:
            try:
                progressed = next(resident[at][1]) != "wait"
            except StopIteration:
                resident[at], progressed = None, True
            if progressed:
                break
        resident = [x for x in resident if x is not None]
        assert progressed or not resident, "every resident tile waits: no forward progress"
    assert (writes == 1).all(), "a row was written more or less than once"
    return out, ev


def _dests(rng, n, live=0.5):
    """The exchange's keys: sorted destinations 0..3, then the dead rows' 4."""
    k = np.sort(rng.integers(0, 4, n))
    k[int(n * live):] = 4
    return k


def _case(name, rng, tile):
    """(keys, a check of the counters: what the case was built to reach)."""
    n = 5 * tile + 3
    if name == "one_run_over_every_tile":
        return np.zeros(12 * tile + 1), lambda e: (e["looked_back"] == 12
                                                    and e["stopped_at_republished"] > 0)
    if name == "run_start_at_every_row":
        return np.arange(n), lambda e: e["looked_back"] == 0
    if name == "starts_on_a_tiles_first_row":
        return np.arange(n) // tile, lambda e: e["looked_back"] == 0
    if name == "starts_on_a_tiles_last_row":  # each tile looks back one tile
        return (np.arange(n) + 1) // tile, lambda e: (e["looked_back"] == 5
                                                      and e["longest_look_back"] == 1)
    if name == "dead_tail_after_short_runs":
        return _dests(rng, 9 * tile + 5, live=0.15), lambda e: e["republished"] >= 3
    if name == "unsorted":
        k = rng.integers(0, 3, n)
        k[tile] = k[tile - 1]  # tile 1 continues tile 0's last run
        return k, lambda e: e["looked_back"] > 0
    if name == "n_is_1":
        return np.array([7]), lambda e: e["looked_back"] == 0
    if name == "n_is_tile_minus_1":
        return _dests(rng, tile - 1), lambda e: e["looked_back"] == 0
    if name == "n_is_tile":
        return _dests(rng, tile), lambda e: e["looked_back"] == 0
    if name == "n_is_tile_plus_1":  # the second tile's one row continues the dead run
        return _dests(rng, tile + 1), lambda e: e["looked_back"] == 1
    raise KeyError(name)


CASES = ["one_run_over_every_tile", "run_start_at_every_row", "starts_on_a_tiles_first_row",
         "starts_on_a_tiles_last_row", "dead_tail_after_short_runs", "unsorted", "n_is_1",
         "n_is_tile_minus_1", "n_is_tile", "n_is_tile_plus_1"]
# (threads, rows a thread, warp, rows a group, look-back lanes, tiles a
# lane, tiles in flight): tiles of 8 rows, look-back steps of 2 to 4 tiles;
# groups of 1 or 2 rows striped over the lanes (the kernel: 4, one 16-byte
# vector), or a thread's rows all consecutive
SHAPES = [(4, 2, 2, 1, 2, 1, 4), (2, 4, 2, 2, 2, 2, 6), (4, 2, 4, 2, 4, 1, 3), (2, 4, 2, 4, 2, 1, 4)]


@pytest.mark.parametrize("policy", ["last_first", "random"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", CASES)
def test_bucket_rank_scan_model_equals_plain_and_jax(case, shape, policy):
    rng = np.random.default_rng(CASES.index(case))
    key, reached = _case(case, rng, shape[0] * shape[1])
    key = key.astype(np.int32)
    got, ev = scan_model(key, *shape, policy=policy, seed=CASES.index(case))
    assert reached(ev), ev
    want = route.plain_bucket_rank(torch.from_numpy(key)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(_xla_bucket_rank(jnp.asarray(key))))
    if policy == "last_first" and case == "one_run_over_every_tile":
        # a tile found its left neighbour unpublished, and one looked back
        # past two tiles that had published "no run start"
        assert ev["waits"] > 0 and ev["skipped"] >= 2 and ev["longest_look_back"] >= 3, ev
