#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

These paths run: the single-GPU Q3 maintenance tick at TPC-H scale factor 1
(materialize_tpu_torch/models/fused_q3.py); the same tick sharded over an
in-process mesh of 4 workers on the card's devices (all 4 on `cuda:0` on a
machine with one card), whose exchange runs the `route_dest` and
`bucket_rank` kernels; the auction views of models/auction.py through the
fused renderer (dataflow/fused.py); and, through `render_dataflow`'s
default, the host-orchestrated renderer (dataflow/runtime.py `Dataflow`):
Q3 at SF1, the auction views with a sliding window and a window function,
and every node kind of that renderer; SQL through the port's Coordinator;
and the fused renderer's mesh mode, the auction views and a SQL view on 4
workers. Phases, each of which fails the run on any error:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the kernels from materialize_tpu_torch/csrc/;
3. kernel edge cases: every kernel against its plain PyTorch version,
   `probe` and `probe2` at cases that reach every branch of their tile
   kernel, `run_sum` at tile edges, mixed widths and more columns than one
   launch takes, `bucket_rank` at tile edges, run starts on a tile's first
   and last rows, a dead tail, unsorted keys and one run over 2,048 tiles,
   and both look-back scans from four threads at once, each on its own
   stream;
4. Q3: generate the tables, hydrate, one warm-up tick that also retracts
   some customers (so the customer delta path runs), then the churn ticks
   at frac = 0.02, timed; on a capacity overflow everything reruns with
   doubled capacities. The launch counters are zeroed just before and read
   just after; every kernel must have launched. The branch mix of the
   largest `probe` call (its tiles by the kernel branch they take) is
   printed;
5. kernels at the main path's shapes: each kernel's largest call of phase 4
   is replayed on the same inputs against its plain version (exact
   equality), and timed with CUDA events beside the plain version and, where
   one PyTorch call computes the same function, that call (`library_ms`),
   the two in turns; beside them each wrapper's host cost per call at
   one-element inputs and that of a one-op PyTorch call (`host_us`);
6. sharded Q3: hydrate on one device, partition the state over the 4
   workers by `route_dest`, one warm-up tick with the customer retraction,
   then the churn ticks, timed, on the mesh; the same overflow ladder; the
   launch counters are zeroed just before the timed ticks and read just
   after, and all six kernels must have launched. Every kernel is then
   replayed against its plain version at its largest call of this phase,
   and `route_dest` and `bucket_rank` are timed there as in phase 5;
7. the auction views: configs 1 (SUM/COUNT of bids by auction), 2
   (auctions ⋈ bids) and 4 (max bid per auction), one after another, each
   through `FusedDataflow` at caps printed beside it: 64 hydration ticks
   of 65,536 bids and 4,096 auctions (2^22 bids over 2^18 auctions), one
   warm-up tick, five timed ticks; the launch counters are zeroed just
   before the timed ticks and read just after, `probe`, `probe2`,
   `multi_take` and `run_sum` must each have launched, each is replayed
   at its largest call of the timed ticks against its plain version
   (exact) and timed there, and no timed or profiled tick may take an
   overflow retry; config 4's index spine is rebucketed after every tick
   (`fit_index`), its share of the timed wall printed apart;
9. Q3 at SF1 through `render_dataflow(tpch.q3())`, a `runtime.Dataflow`,
   on phase 4's generator, scale, seed and frac: hydration in one tick,
   the warm-up tick with the customer retraction, five timed ticks with
   the launch counters zeroed just before and read just after; the four
   path kernels must launch, and each is replayed at its largest call
   there against its plain version (exact) and timed;
10. the auction views through `render_dataflow`, one description at
   phase 7's size: configs 1, 2 and 4, bids live for 16 ticks
   (`TemporalFilter`) summed and counted by auction, and row_number() by
   amount in each auction (`Window`); 64 hydration ticks, a warm-up and
   five timed ticks, compacted after every tick and every index and error
   spine rebucketed (`fit_index`, timed apart: updates/s with and without
   it); the launch checks and replays of phase 9;
11. every node kind of the host renderer (models/operators.py, Q3 at sf
   0.001, `generate_series` through `FusedDataflow`, and two dataflows
   sharing arrangements through a TraceManager, the shared nodes among
   them) on the card against the port's own CPU run, byte for byte after
   every tick;
12. SQL through the port's `Coordinator` (adapter/coordinator.py), which
   plans, optimizes and lowers the SQL text and renders each materialized
   view with `render_dataflow` and the shared arrangements of
   arrangement/trace_manager.py: (a) TPC-H Q3 as SQL text at SF1 (the
   source, the view hydrated from the storage snapshots, one warm-up and
   five timed `advance()` ticks of the coordinator's RF1/RF2 refresh at
   frac 0.001); (b) the README's auction source with 64
   `advance(n_rows=65536)` ticks before any view (2^22 bids), then three
   views over `bids` (the README's `totals`, the max bid per auction and
   auctions ⋈ bids; the last two share the auctions and bids arrangements,
   and at least one import must hit), one warm-up and five timed ticks.
   In both the launch counters are zeroed just before the timed ticks and
   read just after: `probe`, `multi_take` and `run_sum` must launch
   (`probe2` where the plan merges spines), and each launched kernel is
   replayed at its largest call against its plain version (exact);
13. the fused renderer's mesh mode on 4 workers (all on `cuda:0` on a
   machine with one card): (a) configs 1, 2 and 4 through
   `FusedDataflow(mesh=make_mesh(4))` at phase 7's data and ticks, at
   `mesh_auction_caps()` (per-worker capacities), with phase 7's checks,
   and all six kernels must launch in the timed ticks (`route_dest` and
   `bucket_rank` in the exchanges) and equal their plain versions at their
   largest calls; the exchange metrics (`mzt_device_exchange_*`) printed;
   (b) `Coordinator(mesh=make_mesh(4))` with the fused renderer over the
   auction source (64 `advance(n_rows=65536)` ticks, 2^22 bids), the
   README's `totals` view on 4 workers, then `exchange_backend = 'host'`
   and the same view again on one; one warm-up and five timed ticks with
   the launch counters zeroed just before and read just after, all six
   kernels launched and replayed at their largest calls. Phase 13 runs
   last, in a child process of its own (`chip_smoke.py --mesh-phase`),
   after phase 8's checks have released the earlier phases' dataflows:
   its views need the card's memory as phase 7's do. It does its timings
   first, then two profiled ticks of each 13a config and of 13b (device
   time by kernel, idle share) and its checks: each 13a view against its
   NumPy oracle and equal to phase 7's view of the same config, both 13b
   views against a NumPy oracle;
8. the profiler, after every CUDA-event timing (a profiler session can
   slow the process's later launches): each kernel's and library call's
   device time at its largest call (`kernel_device_ms`,
   `library_device_ms`) and the device events of one wrapper call
   (`device_events_per_call`, memsets included), then two more churn ticks
   of each path, for the device time by kernel and the idle share. Then the
   union of the workers' views and the single path's view must each equal
   the brute-force `q3_oracle` over the generator's host mirrors, with no
   error rows and no overflow. Then two profiled ticks of each auction
   config (device time by kernel, idle share, each plan node's host time
   and device span), and each auction view against a NumPy oracle over
   every generated bid and auction; then two profiled ticks of phases 9
   and 10 each, phase 9's view against `q3_oracle` and phase 10's views
   against NumPy oracles over the generator's host rows; then two
   profiled ticks of phase 12a and 12b each, `SELECT * FROM q3` against
   `q3_oracle` over the generator's host rows, and the auction views and
   `SELECT * FROM totals ORDER BY total DESC LIMIT 5` against NumPy
   oracles over every generated bid and auction.

Phase 8 runs after phases 9 to 12, so that every CUDA-event timing
precedes the first profiler session of the process; phase 13 follows.

It prints one JSON line a path (`q3`, `q3_sharded`, one `auction` line a
config, `q3_host`, `auction_host`, `node_cases`, `sql_q3`,
`sql_auction`, one `auction_mesh` line a config, `sql_mesh`), the card's
name and power limit, the kernel table as one JSON line (each kernel's
launches and largest calls per phase, phase 13's under `fused_mesh` and
`sql_mesh`), then the device line as the last line. It exits non-zero, printing
no result, without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PROFILED_TICKS = 2  # churn ticks run under torch.profiler after the timed ones

REPLACES = {
    "run_sum": "materialize_tpu/ops/kernels/segsum.py:52",
    "multi_take": "materialize_tpu/ops/kernels/permute.py:61",
    "probe": "materialize_tpu/ops/kernels/probe.py:69",
    "probe2": "materialize_tpu/ops/kernels/probe.py:97",
    "route_dest": "materialize_tpu/ops/kernels/route.py:45",
    "bucket_rank": "materialize_tpu/ops/kernels/route.py:77",
}
SOURCES = {
    "run_sum": "materialize_tpu_torch/csrc/run_sum.cu",
    "multi_take": "materialize_tpu_torch/csrc/multi_take.cu",
    "probe": "materialize_tpu_torch/csrc/probe.cu",
    "probe2": "materialize_tpu_torch/csrc/probe.cu",
    "route_dest": "materialize_tpu_torch/csrc/route.cu",
    "bucket_rank": "materialize_tpu_torch/csrc/route.cu",
}
N_WORKERS = 4
# the kernels of the single-GPU tick; the sharded tick adds route_dest and bucket_rank
SINGLE_PATH = ("run_sum", "multi_take", "probe", "probe2")


def phase(msg: str) -> None:
    print(f"# [{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


T0 = time.perf_counter()


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max((_max_abs_err(x, y) for x, y in zip(a, b)), default=0)
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() on the card, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host cost of one call, in µs: CUDA events around `iters` back-to-back
    calls on one-element inputs. The device idles between such launches, so
    the events measure how fast the host issues the calls."""
    return time_ms(fn, iters=iters, warmup=20) * 1e3


def in_turns(measure, fa, fb, rounds: int = 2) -> tuple:
    """Medians of measure(fa) and measure(fb), taken in turns a, b, b, a."""
    xa, xb = [], []
    for _ in range(rounds):
        xa.append(measure(fa))
        xb.append(measure(fb))
        xb.append(measure(fb))
        xa.append(measure(fa))
    return float(np.median(xa)), float(np.median(xb))


def kernel_ms(fn, iters: int = 20) -> tuple:
    """(mean device time, device events, mean device time by event name) of
    one fn() call, by the profiler: the kernels' and memsets' own time,
    without the gaps in which the host issues the next call (which `time_ms`
    includes when a call is short). Nones (not measured) when the profiler
    caught no device event, or a count that is no multiple of `iters` (it
    lost some)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events or len(events) % iters:
        return None, None, None
    names: dict = {}
    for e in events:
        names[e.name[:60]] = names.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return sum(names.values()), len(events) // iters, names


# -- phase 3: edge cases ------------------------------------------------------


def edge_cases(device) -> int:
    """Every kernel against its plain version at the CPU tests' edge cases."""
    from materialize_tpu_torch.ops.kernels import permute, probe, route, segsum

    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    n_checks = 0

    def check(name, got, want):
        nonlocal n_checks
        torch.cuda.synchronize()
        if not _equal(got, want):
            raise AssertionError(f"kernel {name} differs from its plain version")
        n_checks += 1

    pad = 0xFFFFFFFF
    for n, m in ((1, 1), (1, 9), (8, 64), (1000, 3), (5000, 20000)):
        arrays = {
            "dups": np.sort(rng.integers(0, 6, n)),
            "all_pad": np.full(n, pad),
            "spread": np.sort(rng.integers(0, 1 << 32, n)),
        }
        for kind, a in arrays.items():
            q = rng.integers(-2, 8, m) if kind == "dups" else rng.integers(0, 1 << 32, m)
            q[: m // 4] = pad
            for side in ("left", "right"):
                check("probe", probe.probe(t(a), t(q), side),
                      probe.plain_searchsorted(t(a), t(q), side))
                lo = rng.integers(0, 3, n)
                order = np.lexsort((lo, a))
                ah, al = t(a[order]), t(lo[order])
                ql = t(rng.integers(-1, 4, m))
                check("probe2", probe.probe2(ah, al, t(q), ql, side),
                      probe.plain_searchsorted2(ah, al, t(q), ql, side))
        cols = (
            t(rng.integers(-(1 << 62), 1 << 62, n)),
            t(rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)),
            t(rng.random(n) < 0.5),
            t(rng.integers(-128, 128, n).astype(np.int8)),
            t(rng.random(n).astype(np.float32)),
        )
        idx = t(rng.integers(-3, n + 3, m))
        check("multi_take", permute.multi_take(cols, idx), permute.plain_multi_take(cols, idx))
        for p in (0.0, 0.01, 0.5, 1.0):
            rs = rng.random(n) < p
            rs[0] = p > 0.0  # p = 0: rows before any run start
            ints = (t(rng.integers(-(1 << 62), 1 << 62, n)),
                    t(rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)))
            check("run_sum", segsum.run_sum(t(rs), ints), segsum.plain_run_sum(t(rs), ints))
    shapes = kernel_shapes()
    for name, (rs, cols) in run_sum_cases(rng, *shapes["run_sum"]).items():
        cols = tuple(t(c) for c in cols)
        check(f"run_sum ({name})", segsum.run_sum(t(rs), cols),
              segsum.plain_run_sum(t(rs), cols))
    for name, ok in run_sum_concurrent(device).items():
        if not ok:
            raise AssertionError(f"kernel run_sum differs from its plain version ({name})")
        n_checks += 1
    for name, k in bucket_rank_cases(rng, *shapes["bucket_rank"]).items():
        k = t(k)
        check(f"bucket_rank ({name})", route.bucket_rank(k), route.plain_bucket_rank(k))
    for name, ok in bucket_rank_concurrent(device).items():
        if not ok:
            raise AssertionError(f"kernel bucket_rank differs from its plain version ({name})")
        n_checks += 1
    cols, idx = wide_take_case(rng)
    cols, idx = tuple(t(c) for c in cols), t(idx)
    check("multi_take", permute.multi_take(cols, idx), permute.plain_multi_take(cols, idx))
    # a run spanning the whole array across many tiles
    n = 3_000_000
    rs = np.zeros(n, dtype=bool)
    rs[0] = True
    col = t(rng.integers(-(1 << 62), 1 << 62, n))
    check("run_sum", segsum.run_sum(t(rs), (col,)), segsum.plain_run_sum(t(rs), (col,)))

    probe2_branches(t, check, rng)
    for name, (a, q) in probe_cases(rng, *shapes["probe"]).items():
        for side in ("left", "right"):
            check(f"probe ({name})", probe.probe(t(a), t(q), side),
                  probe.plain_searchsorted(t(a), t(q), side))

    # route_dest over u32 hashes with 0, 2^31 and PAD_HASH; bucket_rank over
    # sorted, all-dead, one-run and unsorted keys
    for n in (1, 2, 7, 5000, 3_000_000):
        h = rng.integers(0, 1 << 32, n)
        h[: min(n, 3)] = np.array([0, 1 << 31, pad])[: min(n, 3)]
        for n_dest in (1, 3, 4, 8):
            check("route_dest", route.route_dest(t(h), n_dest),
                  route.plain_route_dest(t(h), n_dest))
            keys = {
                "sorted": np.sort(rng.integers(0, n_dest + 1, n)),
                "all_dead": np.full(n, n_dest),
                "one_run": np.zeros(n),
                "unsorted": rng.integers(0, n_dest + 1, n),
            }
            for k in keys.values():
                k = t(k.astype(np.int32))
                check("bucket_rank", route.bucket_rank(k), route.plain_bucket_rank(k))
    return n_checks


def wide_take_case(rng):
    """multi_take's columns and index (numpy) with more columns of one width
    than one launch takes (16), and a column of another width."""
    cols = tuple(rng.integers(-(1 << 62), 1 << 62, 5000) for _ in range(18))
    return cols + (rng.random(5000) < 0.5,), rng.integers(-3, 5003, 7000)


def kernel_shapes() -> dict:
    """The tile kernels' shapes as built: `probe` and `probe2` (queries a
    thread, rows of `a` a block stages), `run_sum` (rows a tile, columns a
    launch), `bucket_rank` (rows a tile)."""
    from materialize_tpu_torch.ops.kernels import registry, route

    f, g = registry.c_fn("mz_probe_shape"), registry.c_fn("mz_run_sum_shape")
    return {"probe": (f(0, 0), f(0, 1)), "probe2": (f(1, 0), f(1, 1)),
            "run_sum": (g(0), g(1)), "bucket_rank": route.bucket_rank_shape()[:1]}


def probe_cases(rng, items: int, window: int) -> dict:
    """probe's inputs (numpy `a`, `q`; `a` sorted) that reach every branch of
    its tile kernel (csrc/probe.cu) with `items` queries a thread (tiles of
    256 * items, 32 * items a warp) and `window` rows of `a` staged by a
    block."""
    pad = 0xFFFFFFFF
    tile, sub = 256 * items, 32 * items

    def spread(n, lo=0, hi=1 << 32, n_pad=0):
        x = np.sort(rng.integers(lo, hi, n))
        x[n - n_pad:] = pad
        return x

    # one tile whose first warp spans 8 windows of `a` and whose other warps
    # sit close together: a wide window, sparse queries and dense ones
    a_mixed = np.arange(16 * window, dtype=np.int64) * 4
    q_mixed = np.concatenate([np.linspace(0, 4 * 8 * window, sub).astype(np.int64),
                              4 * 9 * window + np.arange(tile - sub)])
    counts = np.where(rng.random(1 << 16) < 0.1, rng.integers(0, 4, 1 << 16), 0)
    cum = np.cumsum(counts)
    dup_a = np.sort(rng.integers(0, 300, 40 * tile))
    neg_q = np.sort(rng.integers(-(1 << 40), 1 << 10, 3 * tile))
    return {
        "padding tiles": (spread(1 << 18, n_pad=1 << 17), spread(5 * tile, n_pad=4 * tile)),
        "window fits": (spread(8 * window), spread(16 * tile)),
        "wide, dense (stride 2 or 3)": (spread(8 * window), spread(4 * tile)),
        "wide, one sparse warp": (a_mixed, q_mixed),
        "wide, sparse": (spread(1 << 20), spread(3000)),
        "unsorted": (spread(50_000, hi=1 << 16), rng.integers(-2, 1 << 16, 9000)),
        "duplicate runs across warps": (dup_a, np.sort(rng.integers(-1, 302, 4 * tile))),
        "prefix sum, arange queries": (cum, np.arange(int(cum[-1]) + 2 * tile)),
        "ragged last tile": (spread(6000, hi=1 << 20), spread(5 * tile + 7, hi=1 << 20)),
        "n = 1": (np.array([7]), spread(3 * tile, hi=16)),
        "m = 1": (spread(10_000, hi=1 << 10), np.array([500])),
        "m < tile < n": (spread(10_000, hi=64), np.sort(rng.integers(0, 64, 100))),
        "negative queries": (spread(20_000, hi=1 << 10), neg_q),
    }


def run_sum_cases(rng, tile: int, max_cols: int) -> dict:
    """run_sum's inputs (numpy run starts and columns) at the edges of its
    one-pass scan (csrc/run_sum.cu) with tiles of `tile` rows and `max_cols`
    columns a launch."""

    def cols(n, widths="86"):
        out = []
        for w in widths:
            if w == "8":
                out.append(rng.integers(-(1 << 62), 1 << 62, n))
            else:
                out.append(rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32))
        return tuple(out)

    def starts(n, p):
        rs = rng.random(n) < p
        rs[0] = True
        return rs

    n = 5 * tile + 3
    one_run = np.arange(n) == 0
    at_edges = np.arange(n) % tile == 0
    late = starts(n, 0.01)
    late[: tile + 5] = False
    tail = starts(1 << 21, 0.2)
    tail[1 << 19:] = False
    tail[1 << 19] = True  # trailing padding: one run of 1.5 M rows
    big = np.full(n, np.iinfo(np.int64).max - 3)
    cases = {
        "one run over 5 tiles": (one_run, cols(n)),
        "runs end at tile edges": (at_edges, cols(n)),
        "rows before the first run start": (late, cols(n)),
        "n = tile - 1": (starts(tile - 1, 0.05), cols(tile - 1)),
        "n = tile": (starts(tile, 0.05), cols(tile)),
        "n = tile + 1": (starts(tile + 1, 0.05), cols(tile + 1)),
        "n = 1": (np.array([True]), cols(1)),
        "mixed widths, k = 3": (starts(n, 0.001), cols(n, "484")),
        "more columns than one launch": (starts(n, 0.01), cols(n, "84" * (max_cols // 2 + 2))),
        "wrapping sums": (one_run, (big, np.full(n, (1 << 31) - 5, dtype=np.int32))),
        "trailing padding run": (tail, cols(1 << 21, "8")),
    }
    return cases


def bucket_rank_cases(rng, tile: int) -> dict:
    """bucket_rank's keys (numpy int32) at the edges of its one-pass scan
    (csrc/route.cu) with tiles of `tile` rows: the exchange's layout (sorted
    destinations 0..3, then the dead rows' key 4) around one tile, run starts
    on a tile's first or last row, short runs before a long dead tail,
    unsorted keys, a run start at every row, and one run over 2,048 tiles
    (the longest chain of look-backs)."""

    def dests(n, live=0.5):
        k = np.sort(rng.integers(0, 4, n))
        k[int(n * live):] = 4
        return k

    n = 5 * tile + 3
    cases = {
        "n = 1": np.array([3]),
        "n = tile - 1": dests(tile - 1),
        "n = tile": dests(tile),
        "n = tile + 1": dests(tile + 1),
        "starts on a tile's first row": np.arange(n) // tile,
        "starts on a tile's last row": (np.arange(n) + 1) // tile,
        "dead tail after short runs": dests(1 << 19, live=0.002),
        "long runs, starts mid-tile": np.sort(rng.integers(0, 7, 20 * tile + 5)),
        "unsorted": rng.integers(0, 5, n),
        "a run start at every row": np.arange(n),
        "one run over 2,048 tiles": np.zeros(2048 * tile),
    }
    return {name: k.astype(np.int32) for name, k in cases.items()}


def concurrent(name: str, kernel, plain, inputs: list, reps: int = 5) -> dict:
    """kernel(*inputs[i]) called from one thread for each input, all at once,
    each on its own stream of the inputs' device, `reps` times each; every
    result must equal plain(*inputs[i]) (a look-back's scratch belongs to its
    call). Returns {thread name: all equal}."""
    import threading

    wants = [plain(*args) for args in inputs]
    torch.cuda.synchronize()
    barrier = threading.Barrier(len(inputs))
    results: dict = {}

    def body(i):
        args = inputs[i]
        stream = torch.cuda.Stream(device=args[0].device)
        ok = True
        try:
            with torch.cuda.stream(stream):
                barrier.wait()
                outs = [kernel(*args) for _ in range(reps)]
            stream.synchronize()
            ok = all(_equal(out, wants[i]) for out in outs)
        except Exception as e:  # noqa: BLE001 - reported as a failure
            ok = False
            print(f"# {name} thread {i}: {e!r}", file=sys.stderr)
        results[f"thread {i}"] = ok

    threads = [threading.Thread(target=body, args=(i,)) for i in range(len(inputs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if len(results) != len(inputs):
        raise AssertionError(f"{name}: a concurrent caller did not finish")
    return results


def run_sum_concurrent(device, n_threads: int = 4) -> dict:
    """`concurrent` run_sum calls, a mix of int32 and int64 columns of about
    2^20 rows."""
    from materialize_tpu_torch.ops.kernels import segsum

    rng = np.random.default_rng(7)
    inputs = []
    for i in range(n_threads):
        n = (1 << 20) + 1000 * i
        rs = rng.random(n) < 0.001 * (i + 1)
        rs[0] = i % 2 == 0  # two threads also have rows before the first run start
        vals = (rng.integers(-(1 << 62), 1 << 62, n), rng.integers(-9, 9, n).astype(np.int32))
        inputs.append((torch.as_tensor(rs, device=device),
                       tuple(torch.as_tensor(v, device=device) for v in vals)))
    return concurrent("run_sum", segsum.run_sum, segsum.plain_run_sum, inputs)


def bucket_rank_concurrent(device, n_threads: int = 4) -> dict:
    """`concurrent` bucket_rank calls of about 2^19 rows: the exchange's
    sorted destinations with a dead tail, and (odd threads) one long run."""
    from materialize_tpu_torch.ops.kernels import route

    rng = np.random.default_rng(8)
    inputs = []
    for i in range(n_threads):
        n = (1 << 19) + 1000 * i
        k = np.sort(rng.integers(0, 4, n))
        k[n // (2 + i):] = 4
        if i % 2:
            k[:] = i
        inputs.append((torch.as_tensor(k.astype(np.int32), device=device),))
    return concurrent("bucket_rank", route.bucket_rank, route.plain_bucket_rank, inputs)


def probe_branch_mix(a: torch.Tensor, q: torch.Tensor, items: int, window: int) -> dict:
    """How the tiles of one `probe` call split between the branches of its
    tile kernel (csrc/probe.cu), computed with torch from the call's inputs:
    unsorted; all-equal (first == last, e.g. PAD_HASH padding); staged (the
    window between first and last fits `window` rows); sampled (it does not:
    the block stages every stride-th row, and each query then searches the
    stride - 1 rows between two samples). `between` counts the queries of
    staged and sampled tiles that differ from the tile's first and last."""
    m = q.numel()
    tile = 256 * items
    starts = torch.arange(0, m, tile, device=q.device)
    ends = (starts + tile).clamp(max=m)
    first, last = q[starts], q[ends - 1]
    down = torch.nonzero(q[1:] < q[:-1]).flatten() + 1
    unsorted = torch.zeros(starts.numel(), dtype=torch.bool, device=q.device)
    unsorted[down[down % tile != 0] // tile] = True
    width = torch.searchsorted(a, last) - torch.searchsorted(a, first, right=True)
    equal = ~unsorted & (first == last)
    staged = ~unsorted & ~equal & (width <= window)
    sampled = ~unsorted & ~equal & (width > window)
    stride = (width + window - 1) // window
    owner = torch.arange(m, device=q.device) // tile
    inner = (q != first[owner]) & (q != last[owner])
    return {
        "tiles": int(starts.numel()), "tile": tile, "window_rows": window,
        "all_equal": int(equal.sum()), "staged": int(staged.sum()),
        "sampled": int(sampled.sum()),
        "unsorted": int(unsorted.sum()),
        "between_staged": int((inner & staged[owner]).sum()),
        "between_sampled": int((inner & sampled[owner]).sum()),
        "staged_rows": int(width[staged].sum()), "sampled_rows": int(width[sampled].sum()),
        "widest_window": int(width[staged | sampled].max()) if bool((staged | sampled).any())
        else 0,
        "largest_stride": int(stride[sampled].max()) if bool(sampled.any()) else 0,
    }


def probe2_cases(rng, items: int, window: int) -> dict:
    """probe2's inputs (numpy `ah, al, qh, ql`; `a` pair-sorted) that reach
    every branch of its tile kernel (csrc/probe.cu) with `items` queries a
    thread (tiles of 256 * items) and `window` rows of `a` staged by a
    block."""
    pad = 0xFFFFFFFF

    def pairs(n, hi_range, lo_range, n_pad=0):
        hi, lo = rng.integers(0, hi_range, n), rng.integers(0, lo_range, n)
        hi[n - n_pad:], lo[n - n_pad:] = pad, 0
        order = np.lexsort((lo, hi))
        return hi[order], lo[order]

    tile = 256 * items
    neg_h = rng.integers(-5, 1 << 10, 3 * tile)
    neg_l = rng.integers(-(1 << 40), 8, 3 * tile)
    neg = np.lexsort((neg_l, neg_h))
    cases = {
        "window fits": (pairs(32 * window, 1 << 32, 4), pairs(64 * tile, 1 << 32, 4)),
        "window too large": (pairs(1 << 20, 1 << 32, 1 << 32), pairs(3000, 1 << 32, 1 << 32)),
        "wide, dense": (pairs(8 * window, 1 << 32, 4), pairs(4 * tile, 1 << 32, 4)),
        "padding tiles": (pairs(1 << 18, 1 << 32, 8, n_pad=1 << 17),
                          pairs(5 * tile, 1 << 32, 8, n_pad=4 * tile)),
        "unsorted": (pairs(50_000, 1 << 16, 4),
                     (rng.integers(-2, 1 << 16, 9000), rng.integers(-1, 5, 9000))),
        "hi ties broken on lo": (pairs(50_000, 4, 1 << 32), pairs(50_000, 4, 1 << 32)),
        "ragged last tile": (pairs(6000, 1 << 20, 4), pairs(5 * tile + 7, 1 << 20, 4)),
        "n = 1": ((np.array([7]), np.array([3])), pairs(3 * tile, 16, 8)),
        "m = 1": (pairs(10_000, 1 << 10, 8), (np.array([500]), np.array([2]))),
        "m < tile < n": (pairs(10_000, 64, 1 << 20), (np.full(100, 5),
                                                       np.sort(rng.integers(0, 1 << 14, 100)))),
        "negative queries": (pairs(20_000, 1 << 10, 8), (neg_h[neg], neg_l[neg])),
    }
    return {name: (ah, al, qh, ql) for name, ((ah, al), (qh, ql)) in cases.items()}


def probe2_branches(t, check, rng) -> None:
    """probe2 at every case of `probe2_cases`, both sides."""
    from materialize_tpu_torch.ops.kernels import probe

    for name, arrays in probe2_cases(rng, *kernel_shapes()["probe2"]).items():
        ah, al, qh, ql = (t(x) for x in arrays)
        for side in ("left", "right"):
            check(f"probe2 ({name})", probe.probe2(ah, al, qh, ql, side),
                  probe.plain_searchsorted2(ah, al, qh, ql, side))


# -- phase 4: Q3 ----------------------------------------------------------------


def _per_tick(gen, frac: float, scale: int) -> int:
    return (int(gen.n_orders * frac * 2 * 5.5) + 64) * scale


def q3_caps(gen, frac: float, scale: int):
    """bench.py's capacity formulas, int32 value columns."""
    from materialize_tpu_torch.models.fused_q3 import Q3Caps
    from materialize_tpu_torch.repr.batch import bucket_cap

    n_orders = gen.n_orders
    n_li = len(gen._lineitem_store[0])
    per_tick = _per_tick(gen, frac, scale)
    return Q3Caps(
        cust=bucket_cap(max(gen.n_customer // 4, 64) * scale),
        orders=bucket_cap(max(int(n_orders * 0.55), 64) * scale),
        lineitem=bucket_cap(max(int(n_li * 0.65), 64) * scale),
        delta=bucket_cap(per_tick),
        join_out=bucket_cap(per_tick * 2),
        groups=bucket_cap(max(int(n_orders * 0.35), 64) * scale),
        val_dtype="int32",
    )


def run_q3(device, sf: float, ticks: int, frac: float, n_cust_retract: int,
           seed: int = 0, scale: int = 1, max_rescale: int = 3) -> dict:
    """Hydrate, one warm-up tick with a customer retraction, `ticks` timed
    churn ticks. Reruns with doubled capacities on any overflow."""
    from materialize_tpu_torch.models.fused_q3 import Q3State, hydrate, q3_tick
    from materialize_tpu_torch.ops.kernels import registry
    from materialize_tpu_torch.ops.reduce import HOST_SYNCS
    from materialize_tpu_torch.repr.batch import UpdateBatch
    from materialize_tpu_torch.storage import TpchGenerator

    def retry(why):
        if max_rescale <= 0:
            raise RuntimeError(f"{why} persists at the largest capacities")
        phase(f"{why} at scale {scale}; rerunning with doubled capacities")
        return run_q3(device, sf, ticks, frac, n_cust_retract, seed, scale * 2, max_rescale - 1)

    phase(f"generating TPC-H sf={sf} (scale {scale})")
    gen = TpchGenerator(sf=sf, seed=seed, val_dtype=np.int32, device=device)
    init = gen.initial_batches(1)
    caps = q3_caps(gen, frac, scale)
    phase(f"caps {caps}")
    registry.reset_launches()
    t0 = time.perf_counter()
    try:
        state = hydrate(Q3State.empty(caps, device=device), init["customer"], init["orders"],
                        init["lineitem"], 1)
    except OverflowError:
        return retry("hydration overflow")
    torch.cuda.synchronize()
    hydrate_s = time.perf_counter() - t0
    hydrate_launches = dict(registry.LAUNCHES)
    del init
    phase(f"hydrated in {hydrate_s:.2f}s")

    # warm-up delta: retract some customers (drives the customer path)
    cc = tuple(c[:n_cust_retract].astype(np.int32) for c in gen._customer)
    d_cust = UpdateBatch.build((), cc, np.full(n_cust_retract, 2),
                               -np.ones(n_cust_retract, dtype=np.int64), device=device)
    gen._customer = tuple(c[n_cust_retract:] for c in gen._customer)
    empty_c = UpdateBatch.empty(8, (), (torch.int32,) * 3, device=device)
    refreshes, n_updates = [], []
    for tk in range(2, 3 + ticks + PROFILED_TICKS):
        r = gen.refresh(tk, frac=frac)
        refreshes.append((tk, r))
        n_updates.append(int(r["orders"].count()) + int(r["lineitem"].count()))
    torch.cuda.synchronize()
    phase(f"{len(refreshes)} refresh ticks generated")

    flags, errs_live = [], []
    tk, r = refreshes[0]
    state, out, errs, over = q3_tick(state, d_cust, r["orders"], r["lineitem"], tk,
                                     caps=caps, with_cust=True)
    flags.append(over)
    errs_live.append(errs.count())
    torch.cuda.synchronize()
    phase("warm-up tick done")

    registry.reset_launches()
    registry.SAMPLES = {}
    syncs0 = HOST_SYNCS["lookup_widen"]
    torch.cuda.synchronize()
    start = time.perf_counter()
    for tk, r in refreshes[1 : 1 + ticks]:
        state, out, errs, over = q3_tick(state, empty_c, r["orders"], r["lineitem"], tk,
                                         caps=caps, with_cust=False)
        flags.append(over)
        errs_live.append(errs.count())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = dict(registry.LAUNCHES)
    samples, registry.SAMPLES = registry.SAMPLES, None
    syncs = HOST_SYNCS["lookup_widen"] - syncs0
    if bool(torch.cat(flags).any()):
        return retry("tick overflow")

    def profiled_ticks() -> dict:
        """Where the time goes: the last churn ticks under the profiler. Run
        after every CUDA-event timing of the script: a profiler session
        can slow the process's later launches."""
        nonlocal state
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_prof = time.perf_counter()
            for tk, r in refreshes[1 + ticks :]:
                state, _out, errs, over = q3_tick(state, empty_c, r["orders"], r["lineitem"],
                                                  tk, caps=caps, with_cust=False)
                flags.append(over)
                errs_live.append(errs.count())
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t_prof
        if bool(torch.cat(flags).any()):
            raise AssertionError("overflow in the profiled ticks")
        n_errs = int(torch.stack(errs_live).sum())
        if n_errs:
            raise AssertionError(f"{n_errs} error rows in the ticks")
        return {"profile": device_breakdown(prof, prof_wall), "state": state}

    timed = sum(n_updates[1 : 1 + ticks])
    return {
        "gen": gen, "caps": caps, "scale": scale,
        "hydrate_s": hydrate_s, "hydrate_launches": hydrate_launches,
        "timed_updates": timed, "elapsed_s": elapsed, "ticks": ticks,
        "updates_per_s": timed / elapsed, "launches": launches, "samples": samples,
        "host_syncs_per_tick": syncs / ticks,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profiled_ticks": profiled_ticks,
    }


def run_sharded(sf: float, ticks: int, frac: float, n_cust_retract: int, seed: int = 0,
                scale: int = 1, max_rescale: int = 3) -> dict:
    """Q3 on a mesh of N_WORKERS workers: hydrate on one device, partition
    the state by route_dest, one warm-up tick with a customer retraction,
    `ticks` timed churn ticks, then profiled ones. Reruns with doubled
    capacities (buckets too) on any overflow."""
    from materialize_tpu_torch.models import fused_q3 as Q
    from materialize_tpu_torch.ops.kernels import registry
    from materialize_tpu_torch.ops.reduce import HOST_SYNCS
    from materialize_tpu_torch.parallel.devicemesh import note_overflow_retry
    from materialize_tpu_torch.parallel.mesh import make_mesh
    from materialize_tpu_torch.repr.batch import UpdateBatch, bucket_cap
    from materialize_tpu_torch.storage import TpchGenerator

    def retry(why):
        if max_rescale <= 0:
            raise RuntimeError(f"sharded: {why} persists at the largest capacities")
        note_overflow_retry()
        phase(f"sharded: {why} at scale {scale}; rerunning with doubled capacities")
        return run_sharded(sf, ticks, frac, n_cust_retract, seed, scale * 2, max_rescale - 1)

    mesh = make_mesh(N_WORKERS)
    n = len(mesh)
    phase(f"sharded: mesh {[str(d) for d in mesh]}; generating TPC-H sf={sf} (scale {scale})")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # what the single path still holds
    gen = TpchGenerator(sf=sf, seed=seed, val_dtype=np.int32, device=mesh[0])
    init = gen.initial_batches(1)
    one = q3_caps(gen, frac, scale)
    caps = dataclasses.replace(
        one, cust=one.cust // n, orders=one.orders // n, lineitem=one.lineitem // n,
        delta=one.delta // n, join_out=one.join_out // n, groups=one.groups // n,
        bucket=bucket_cap(2 * _per_tick(gen, frac, scale) // (n * n)),
    )
    phase(f"sharded: per-worker caps {caps}")
    t0 = time.perf_counter()
    try:
        single = Q.hydrate(Q.Q3State.empty(one, device=mesh[0]), init["customer"],
                           init["orders"], init["lineitem"], 1)
        states = Q.shard_state(single, caps, mesh)
    except OverflowError:
        return retry("hydration overflow")
    del single, init
    torch.cuda.synchronize()
    hydrate_s = time.perf_counter() - t0
    phase(f"sharded: hydrated and partitioned in {hydrate_s:.2f}s")

    cc = tuple(c[:n_cust_retract].astype(np.int32) for c in gen._customer)
    d_cust = UpdateBatch.build((), cc, np.full(n_cust_retract, 2),
                               -np.ones(n_cust_retract, dtype=np.int64), device=mesh[0])
    gen._customer = tuple(c[n_cust_retract:] for c in gen._customer)
    empty_c = Q.split_batch(UpdateBatch.empty(8 * n, (), (torch.int32,) * 3, device=mesh[0]),
                            mesh)
    refreshes, n_updates = [], []
    for tk in range(2, 3 + ticks + PROFILED_TICKS):
        r = gen.refresh(tk, frac=frac)
        refreshes.append((tk, Q.split_batch(r["orders"], mesh),
                          Q.split_batch(r["lineitem"], mesh)))
        n_updates.append(int(r["orders"].count()) + int(r["lineitem"].count()))
    torch.cuda.synchronize()
    phase(f"sharded: {len(refreshes)} refresh ticks generated and split")

    flags, errs_live = [], []

    def tick(step, d_custs, tk, d_ords, d_lis):
        nonlocal states
        res = step(states, d_custs, d_ords, d_lis, tk)
        states = [r[0] for r in res]
        flags.extend(r[3] for r in res)
        errs_live.extend(r[2].count().to(mesh[0]) for r in res)

    with_cust = Q.q3_tick_sharded(mesh, caps, with_cust=True)
    churn = Q.q3_tick_sharded(mesh, caps, with_cust=False)
    tick(with_cust, Q.split_batch(d_cust, mesh), *refreshes[0])
    torch.cuda.synchronize()
    phase("sharded: warm-up tick done")

    registry.reset_launches()
    registry.SAMPLES = {}
    syncs0 = HOST_SYNCS["lookup_widen"]
    torch.cuda.synchronize()
    start = time.perf_counter()
    for tk, d_ords, d_lis in refreshes[1 : 1 + ticks]:
        tick(churn, empty_c, tk, d_ords, d_lis)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = dict(registry.LAUNCHES)
    samples, registry.SAMPLES = registry.SAMPLES, None
    syncs = HOST_SYNCS["lookup_widen"] - syncs0
    if bool(torch.cat([f.to(mesh[0]) for f in flags]).any()):
        return retry("tick overflow")
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**30

    def profiled_ticks() -> dict:
        """The last churn ticks under the profiler, after every CUDA-event
        timing of the script (see run_q3)."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_prof = time.perf_counter()
            for tk, d_ords, d_lis in refreshes[1 + ticks :]:
                tick(churn, empty_c, tk, d_ords, d_lis)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t_prof
        if bool(torch.cat([f.to(mesh[0]) for f in flags]).any()):
            raise AssertionError("sharded: overflow in the profiled ticks")
        n_errs = int(torch.stack(errs_live).sum())
        if n_errs:
            raise AssertionError(f"sharded: {n_errs} error rows in the ticks")
        return {"profile": device_breakdown(prof, prof_wall), "states": states}

    timed = sum(n_updates[1 : 1 + ticks])
    return {
        "gen": gen, "caps": caps, "scale": scale,
        "mesh": [str(d) for d in mesh],
        "hydrate_s": hydrate_s, "timed_updates": timed, "elapsed_s": elapsed, "ticks": ticks,
        "updates_per_s": timed / elapsed, "launches": launches, "samples": samples,
        "host_syncs_per_tick": syncs / ticks, "peak_mem_gib": peak,
        "profiled_ticks": profiled_ticks,
    }


# device kernel names (substrings) of the port's kernels; probe and probe2
# share one tile kernel template, told apart by its key type
_OURS = {"run_sum_kernel": "run_sum", "take_kernel": "multi_take", "::Key2": "probe2",
         "::Key1": "probe", "route_kernel": "route_dest", "bucket_rank_kernel": "bucket_rank"}


def device_breakdown(prof, wall_s: float) -> dict:
    """Device time by kernel name over the profiled ticks, and the idle share.
    `port_kernels_ms` holds kernels only; the memsets, among them those
    that zero the scratch of `run_sum` and `bucket_rank`, are counted apart
    (`memsets`: count, ms)."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    n_events = 0
    memsets = [0, 0.0]
    spans: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name.startswith("mzt"):
            # a plan node's range as the device saw it (first to last kernel
            # of its launches), not a device event of its own
            spans[e.name] = spans.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        elif e.device_type == DeviceType.CUDA:
            n_events += 1
            ms = e.time_range.elapsed_us() / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
            if "Memset" in e.name:
                memsets[0] += 1
                memsets[1] += ms
    busy = sum(by_name.values())
    if busy == 0.0:
        return {"device_ms": "not measured", "wall_ms": wall_s * 1e3}
    ours: dict = {}
    for name, ms in by_name.items():
        for key, kernel in _OURS.items():
            if key in name:
                ours[kernel] = ours.get(kernel, 0.0) + ms
                break
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "ticks": PROFILED_TICKS, "wall_ms": wall_s * 1e3, "device_busy_ms": busy,
        "device_events": n_events,
        "idle_share": 1.0 - busy / (wall_s * 1e3), "port_kernels_ms": ours, "memsets": memsets,
        "top": [[name[:90], ms] for name, ms in top],
        **({"node_device_span_ms": spans} if spans else {}),
    }


# -- phase 5: kernels at the main path's shapes ----------------------------------


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def host_op(name: str, args: tuple):
    """(name, fn) of the one PyTorch call whose host cost stands beside the
    wrapper's: the library call where there is one, else a scan of the same
    input (a single op, not the same function)."""
    if name in ("run_sum", "bucket_rank"):
        col = args[1][0] if name == "run_sum" else args[0]
        return "torch.cumsum", lambda: torch.cumsum(col, 0)
    if name == "multi_take":
        col, idx = args[0][0], torch.zeros_like(args[1])
        return "index_select", lambda: col.index_select(0, idx)
    return {"probe": "torch.searchsorted", "probe2": "torch.searchsorted",
            "route_dest": "torch.remainder"}[name], replay(name, args)[2]


def _runs(*keys: torch.Tensor) -> int:
    """Runs of equal rows in sorted key columns: a search needs to read one
    row of each run (its first), not the rest, e.g. a tail of padding."""
    n = keys[0].numel()
    if n == 0:
        return 0
    differs = torch.zeros(n - 1, dtype=torch.bool, device=keys[0].device)
    for k in keys:
        differs |= k[1:] != k[:-1]
    return 1 + int(differs.sum())


def one_element(args):
    """`args` with every tensor cut to its first element (a copy)."""
    if isinstance(args, torch.Tensor):
        return args[:1].clone()
    if isinstance(args, tuple):
        return tuple(one_element(a) for a in args)
    return args


def replay(name: str, args: tuple):
    """(kernel fn, plain fn, library fn or None, bytes the function must move
    on these inputs: each input row it needs read once, each output written
    once)."""
    from materialize_tpu_torch.ops.kernels import permute, probe, route, segsum

    if name == "route_dest":
        h, n_dest = args
        return (lambda: route.route_dest(h, n_dest), lambda: route.plain_route_dest(h, n_dest),
                lambda: torch.remainder(h, n_dest), _bytes(h) + h.numel() * 4)
    if name == "bucket_rank":
        (k,) = args
        # no single PyTorch call ranks rows within runs
        return (lambda: route.bucket_rank(k), lambda: route.plain_bucket_rank(k), None,
                2 * _bytes(k))
    if name == "probe":
        a, q, side = args
        return (lambda: probe.probe(a, q, side), lambda: probe.plain_searchsorted(a, q, side),
                lambda: torch.searchsorted(a, q, right=side == "right"),
                _runs(a) * a.element_size() + _bytes(q) + q.numel() * 8)
    if name == "probe2":
        ah, al, qh, ql, side = args
        # one int64 key that orders like the (hi, lo) pair of u32 values
        ka = ((ah - (1 << 31)) << 32) + al
        kq = ((qh - (1 << 31)) << 32) + ql
        return (lambda: probe.probe2(ah, al, qh, ql, side),
                lambda: probe.plain_searchsorted2(ah, al, qh, ql, side),
                lambda: torch.searchsorted(ka, kq, right=side == "right"),
                _runs(ah, al) * (ah.element_size() + al.element_size())
                + _bytes(qh) + _bytes(ql) + qh.numel() * 8)
    if name == "multi_take":
        cols, idx = args
        n, m = cols[0].numel(), idx.numel()
        groups: dict = {}
        for c in cols:
            groups.setdefault(c.element_size(), []).append(c)
        mats = [torch.stack(g) for g in groups.values()]
        ix = idx.clamp(0, n - 1)

        def library():
            return [mat.index_select(1, ix) for mat in mats]

        rows = torch.unique(ix).numel()  # the rows of each column it reads
        moved = _bytes(idx) + sum((rows + m) * c.element_size() for c in cols)
        return (lambda: permute.multi_take(cols, idx), lambda: permute.plain_multi_take(cols, idx),
                library, moved)
    if name == "run_sum":
        rs, cols = args
        return (lambda: segsum.run_sum(rs, cols), lambda: segsum.plain_run_sum(rs, cols), None,
                _bytes(rs) + 2 * sum(_bytes(c) for c in cols))
    raise KeyError(name)


def check_largest(name: str, samples: dict):
    """Replay `name`'s largest call in `samples` against its plain version.
    Returns (shape, replay(name, args), max_abs_err); raises if they differ."""
    _size, shape, args = samples[name]["largest"]
    fns = replay(name, args)
    got, want = fns[0](), fns[1]()
    torch.cuda.synchronize()
    if not _equal(got, want):
        raise AssertionError(f"kernel {name} differs from its plain version at {shape}")
    if name in ("probe", "probe2", "route_dest"):  # yardsticks must compute the same function
        if not torch.equal(fns[2]().to(want.dtype), want):
            raise AssertionError(f"{name} library yardstick disagrees")
    return shape, fns, _max_abs_err(got, want)


def kernel_table(names, samples: dict, launches: dict) -> list:
    """Each kernel's largest call in `samples`, replayed against its plain
    version and timed by CUDA events: the wrapper and the library call in
    turns, and the host cost of both at one-element inputs."""
    rows = []
    for name in names:
        shape, (kern, plain, library, moved), err = check_largest(name, samples)
        if library is not None:
            ms, library_ms = in_turns(time_ms, kern, library)
        else:
            ms, library_ms = float(np.median([time_ms(kern) for _ in range(4)])), None
        tiny = one_element(samples[name]["largest"][2])
        op_name, op = host_op(name, tiny)
        wrapper_us, op_us = in_turns(host_us, replay(name, tiny)[0], op)
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": time_ms(plain),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms,
            "host_us": {"wrapper": wrapper_us, "op": op_us, "op_name": op_name},
            "shape": list(shape),
        }
        rows.append(row)
        phase(f"{name} at {shape}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({moved / 1e6:.1f} MB), "
              f"library {row['library_ms']}; "
              f"host µs a call at n = 1: {row['host_us']}")
    return rows


def device_times(rows: list, samples: dict) -> None:
    """The profiler's device time of each row's kernel and library call at
    its largest call in `samples` (the path the row's `shape` is from)."""
    for row in rows:
        _size, _shape, args = samples[row["name"]]["largest"]
        kern, _plain, library, _moved = replay(row["name"], args)
        row["kernel_device_ms"], row["device_events_per_call"], _ = kernel_ms(kern)
        row["library_device_ms"] = kernel_ms(library)[0] if library is not None else None
        phase(f"{row['name']}: device {row['kernel_device_ms']} ms in "
              f"{row['device_events_per_call']} device events a call, library device "
              f"{row['library_device_ms']} ms")


# -- phase 7: the auction views through the fused renderer ---------------------

AUCTION_CONFIGS = ("bids_sum_count", "auctions_join_bids", "max_bid_per_auction")
AUCTION_SEED = 0
AUCTION_BIDS = 1 << 16  # bids a tick
AUCTION_NEW = 4096  # auctions a tick
AUCTION_HYDRATE = 64  # hydration ticks: 2^22 bids over 2^18 auctions
AUCTION_TICKS = 5  # timed churn ticks, after one warm-up tick


def auction_caps():
    """FusedCaps for the auction views at the card's size. Levels are
    level_caps(full, delta, 3, ratio=8): level 0 takes 8 ticks of deltas and
    level 1 64, so append-only input runs without a retry when an
    arrangement's top level holds 512 deltas. A reduce's table holds a row a
    group (2^18 auctions; 2^24 leaves each level room); a top-k gather
    holds every row of the touched groups in one level (about 58 k auctions
    x 16 bids, 2^20 rows); a join tick's output is one row a bid."""
    from materialize_tpu_torch.dataflow.fused import FusedCaps

    delta = AUCTION_BIDS
    return FusedCaps(delta=delta, arrangement=512 * delta, groups=1 << 24,
                     join_out=2 * delta, gather=1 << 21)


def mesh_auction_caps():
    """Phase 13a's per-worker FusedCaps: auction_caps() with a quarter of
    the delta (the global delta, 4 x the per-worker one, takes a tick's
    65,536 bids), buckets of one worker's delta (bucket 0), which no
    worker's send can overflow, and a quarter of every state capacity but
    the arrangements', which get half. At a quarter an arrangement's level
    0 would hold exactly 8 per-worker deltas, and the exchange splits a
    tick's bids by key hash, not exactly: a worker that receives more than
    its quarter over 8 ticks would overflow it."""
    caps = auction_caps()
    return dataclasses.replace(
        caps, delta=caps.delta // N_WORKERS, arrangement=2 * caps.arrangement // N_WORKERS,
        groups=caps.groups // N_WORKERS, join_out=caps.join_out // N_WORKERS,
        gather=caps.gather // N_WORKERS, bucket=0)


def exchange_metrics() -> dict:
    """The mzt_device_exchange_* samples of the port's metrics registry."""
    from materialize_tpu_torch.obs import REGISTRY

    return {f"{fam.name}{dict(labels) or ''}": v for fam in REGISTRY.families()
            if fam.name.startswith("mzt_device_exchange_") for labels, v in fam.samples}


AUCTION_INDEX = {"bids_sum_count": "idx_bids_sum", "auctions_join_bids": "idx_join",
                 "max_bid_per_auction": "idx_topk"}


def auction_oracle_check(config: str, df, gen) -> dict:
    """The view against a NumPy oracle over every generated bid and auction:
    config 1 (auction_id, sum(amount), count) per auction; config 2 every
    auction ++ bid pair on a.id = b.auction_id; config 4 per auction the bid
    with the largest amount, ties to the smallest bid id. Configs 1 and 4
    compare `peek`'s rows; config 2 (one row a bid) compares the index's
    consolidated host columns in NumPy, ordered by bid id. No error rows.
    The index is first compacted to the last tick, so that a read
    consolidates the spine's +/- history instead of expanding it."""
    idx = AUCTION_INDEX[config]
    df.compact(df.frontier - 1)
    if df.index_errs[idx].count():
        raise AssertionError(f"{config}: error rows in the index")
    bids = [np.concatenate(c) for c in zip(*gen.host["bids"])]
    auction_id, amount = bids[2], bids[3]
    if config == "bids_sum_count":
        n = np.bincount(auction_id)
        s = np.bincount(auction_id, weights=amount.astype(np.float64)).astype(np.int64)
        live = np.flatnonzero(n)
        want = list(zip(live.tolist(), s[live].tolist(), n[live].tolist()))
        got = df.peek(idx)
        how = "peek"
    elif config == "max_bid_per_auction":
        order = np.lexsort((bids[0], -amount, auction_id))
        first = order[np.r_[True, auction_id[order][1:] != auction_id[order][:-1]]]
        want = sorted(zip(*(c[first].tolist() for c in bids)))
        got = df.peek(idx)
        how = "peek"
    else:
        auctions = [np.concatenate(c) for c in zip(*gen.host["auctions"])]
        if not np.array_equal(auctions[0], np.arange(len(auctions[0]))):
            raise AssertionError("auction ids are not dense")
        want_cols = [a[auction_id] for a in auctions] + bids
        cols, ncols = df.index_traces[idx].host_columns()
        if ncols != len(want_cols) or not (cols["diffs"] == 1).all():
            raise AssertionError(f"{config}: index rows are not one copy each")
        got_cols = [cols[f"c{i}"] for i in range(ncols)]
        # one row a bid: the bid id (column 4) orders both
        ow, og = np.argsort(want_cols[4], kind="stable"), np.argsort(got_cols[4], kind="stable")
        same = len(ow) == len(og) and all(
            np.array_equal(w[ow], g[og]) for w, g in zip(want_cols, got_cols))
        want, got = (len(ow), same), (len(og), True)
        how = "numpy columns of the index"
    if got != want:
        raise AssertionError(f"{config}: view differs from its oracle")
    # a digest of the view, to hold one path's view against another's
    if how == "peek":
        digest = hashlib.sha256(repr(got).encode()).hexdigest()
    else:
        order = np.argsort(got_cols[4], kind="stable")
        digest = hashlib.sha256(b"".join(c[order].tobytes() for c in got_cols)).hexdigest()
    return {"rows": len(got) if how == "peek" else want[0], "compared": how, "digest": digest}


def fit_index(df) -> tuple:
    """Shrink each index and error spine's batches to their live rows
    (`Arrangement.rebucket`); returns the host reads that made (one a
    batch) and its seconds, the card synchronized before and after.
    Neither renderer shrinks them: the fused tick of a top-k emits a batch
    of 6 x `gather` rows, which the spine would keep at that capacity
    (12.6 M rows a tick here, past the card's memory within the
    hydration), and the host renderer inserts every tick's error batch,
    live or not, at its full capacity. This is harness work, not the
    renderer's: the phases report its share of the timed ticks and keep
    its reads apart from the renderer's host syncs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reads = 0
    for arr in (*df.index_traces.values(), *df.index_errs.values()):
        reads += len(arr.batches)
        arr.rebucket()
    torch.cuda.synchronize()
    return reads, time.perf_counter() - t0


def fit_views(coord) -> tuple:
    """`fit_index` for every dataflow of the coordinator `coord`, and the
    same for each view's storage collection, where a fused view appends its
    full-capacity output batches too (and the sink's periodic self-check
    consolidates both whole); returns (reads, seconds) as fit_index does."""
    reads, secs = 0, 0.0
    for gid, df, _srcs in coord.dataflows:
        r, t = fit_index(df)
        store = coord.storage.get(gid)
        t0 = time.perf_counter()
        if store is not None:
            r += len(store.arr.batches)
            store.arr.rebucket()
        torch.cuda.synchronize()
        reads, secs = reads + r, secs + t + time.perf_counter() - t0
    return reads, secs


def run_auction(config: str, device, mesh=None) -> dict:
    """Config `config` of models/auction.py through FusedDataflow: hydrate
    (AUCTION_HYDRATE ticks), one warm-up tick, AUCTION_TICKS timed churn
    ticks with the launch counters zeroed just before and read just after,
    each path kernel replayed at its largest call of the timed ticks against
    its plain version (exact) and timed there. Config 4's index spine is
    rebucketed after every tick (`fit_index`): its time is inside the
    ticks' wall and reported as a share of it, its reads apart from the
    renderer's host syncs. With `mesh` (phase 13a) the dataflow runs on its
    workers at `mesh_auction_caps()`, `route_dest` and `bucket_rank` (the
    exchange) must launch too, and every config's index spine is
    rebucketed: a mesh tick's output joins the workers' full-capacity
    batches, 4 x a single tick's (phase 7 keeps its configs 1 and 2
    spines as they are). Returns the numbers and the closures of the
    profiled ticks and of the oracle check."""
    from materialize_tpu_torch.dataflow.fused import FusedDataflow
    from materialize_tpu_torch.models import auction
    from materialize_tpu_torch.ops.kernels import registry
    from materialize_tpu_torch.ops.reduce import HOST_SYNCS
    from materialize_tpu_torch.storage import AuctionGenerator

    desc = getattr(auction, config)()
    sources = tuple(desc.source_imports)
    caps = auction_caps() if mesh is None else mesh_auction_caps()
    path = SINGLE_PATH if mesh is None else registry.KERNELS
    label = f"auction {config}" if mesh is None else f"mesh auction {config}"
    gen = AuctionGenerator(AUCTION_SEED, AUCTION_NEW, device=device, keep_host=True)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    df = FusedDataflow(desc, caps, mesh=mesh, device=device)
    fit = config == "max_bid_per_auction" or mesh is not None
    fitted = [0, 0.0]  # fit_index's host reads and seconds

    def inputs(tick):
        batches = gen.next_tick(tick, AUCTION_BIDS)
        return {s: batches[s] for s in sources}

    def step(tick, batches):
        df.step(tick, batches)
        if fit:
            reads, secs = fit_index(df)
            fitted[0] += reads
            fitted[1] += secs

    phase(f"{label}: caps {caps}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tick in range(1, AUCTION_HYDRATE + 1):
        step(tick, inputs(tick))
    torch.cuda.synchronize()
    hydrate_s = time.perf_counter() - t0
    hydrate_retries = df.retries
    warm = AUCTION_HYDRATE + 1
    step(warm, inputs(warm))
    later = [(tk, inputs(tk)) for tk in range(warm + 1, warm + 1 + AUCTION_TICKS + PROFILED_TICKS)]
    rows = AUCTION_BIDS + (AUCTION_NEW if "auctions" in sources else 0)
    torch.cuda.synchronize()
    phase(f"{label}: hydrated {AUCTION_HYDRATE} ticks in {hydrate_s:.2f}s "
          f"({hydrate_retries} retries), warm-up tick {warm} done")

    retries0 = df.retries
    registry.reset_launches()
    registry.SAMPLES = {}
    syncs0 = df.host_syncs + HOST_SYNCS["lookup_widen"]
    fit0 = list(fitted)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for tk, b in later[:AUCTION_TICKS]:
        step(tk, b)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = dict(registry.LAUNCHES)
    samples, registry.SAMPLES = registry.SAMPLES, None
    syncs = df.host_syncs + HOST_SYNCS["lookup_widen"] - syncs0
    if df.retries != retries0:
        raise AssertionError(f"{label}: an overflow retry in the timed ticks")
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    timed = [tk for tk, _b in later[:AUCTION_TICKS]]
    kernels = {}
    for k in path:
        shape, (kern, _plain, _library, moved), err = check_largest(k, samples)
        kernels[k] = {"launches": launches[k], "shape": list(shape), "max_abs_err": err,
                      "ms": time_ms(kern), "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
    del samples
    info = df.arrangement_info()
    out = {
        "config": config, "caps": dataclasses.asdict(caps), "sources": list(sources),
        "workers": None if mesh is None else [str(d) for d in mesh],
        "hydrate_ticks": AUCTION_HYDRATE, "hydrate_s": hydrate_s,
        "hydrate_retries": hydrate_retries, "timed_ticks": timed,
        "updates": rows * AUCTION_TICKS, "seconds": elapsed,
        "updates_per_s": rows * AUCTION_TICKS / elapsed,
        "host_syncs_per_tick": syncs / AUCTION_TICKS, "retries": df.retries,
        "index_rebucketed": fit,
        "fit_index_reads_per_tick": (fitted[0] - fit0[0]) / AUCTION_TICKS,
        "fit_index_share": (fitted[1] - fit0[1]) / elapsed,
        "deepest_merge_in_window": any(tk % 64 == 0 for tk in timed),
        "level_merge_in_window": [tk for tk in timed if tk % caps.ratio == 0],
        "state_bytes": sum(r[-1] for r in info if r[0] == "fused"),
        "index_bytes": sum(r[-1] for r in info if r[0] != "fused"),
        "state_rows": sum(r[5] for r in info if r[0] == "fused"),
        "peak_mem_gib": (torch.cuda.max_memory_allocated() - resident) / 2**30,
        "kernels": kernels,
    }
    if mesh is not None:
        out["exchange_metrics"] = exchange_metrics()
        phase(f"{label}: {out['exchange_metrics']}")
    phase(f"{label}: {out['updates']} updates in {elapsed:.4f}s over "
          f"{AUCTION_TICKS} ticks = {out['updates_per_s']:.1f} updates/s; "
          f"{out['host_syncs_per_tick']} host syncs per tick; fit_index "
          f"{out['fit_index_share']:.4f} of the wall, {out['fit_index_reads_per_tick']} reads "
          f"per tick; retries {df.retries}; "
          f"state {out['state_bytes']} B, index {out['index_bytes']} B; "
          f"peak {out['peak_mem_gib']:.2f} GiB; launches {launches}")
    for k, row in kernels.items():
        phase(f"{label}: {k} equals its plain version at its largest call "
              f"{row['shape']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")

    def profiled_ticks() -> dict:
        """The last ticks under the profiler, the plan nodes named."""
        from torch.profiler import ProfilerActivity, profile

        from materialize_tpu_torch.obs import profiler as mzt_profiler

        mzt_profiler.configure(True)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t_prof = time.perf_counter()
                for tk, b in later[AUCTION_TICKS:]:
                    step(tk, b)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t_prof
        finally:
            mzt_profiler.configure(False)
        if df.retries != retries0:
            raise AssertionError(f"{label}: an overflow retry in the profiled ticks")
        from torch.autograd import DeviceType

        nodes: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name.startswith("mzt"):
                nodes[e.name] = nodes.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        return {"profile": {**device_breakdown(prof, prof_wall), "host_ms_by_node": nodes}}

    out["profiled_ticks"] = profiled_ticks
    out["check"] = lambda: auction_oracle_check(config, df, gen)
    return out


# -- phases 9-11: the host renderer (runtime.Dataflow, render_dataflow's default) --


def host_syncs() -> int:
    """Host reads so far: the reduce lookups' widening decisions and every
    count the host renderer and its operators read."""
    from materialize_tpu_torch.ops.reduce import HOST_SYNCS

    return HOST_SYNCS["lookup_widen"] + HOST_SYNCS["host_path"]


def host_kernel_rows(samples: dict, launches: dict, what: str) -> dict:
    """Each path kernel's largest call of a host-renderer phase, replayed
    against its plain version (exact) and timed by CUDA events."""
    missing = [k for k in SINGLE_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched: {missing}")
    rows = {}
    for k in SINGLE_PATH:
        shape, (kern, _plain, _library, moved), err = check_largest(k, samples)
        rows[k] = {"launches": launches[k], "shape": list(shape), "max_abs_err": err,
                   "ms": time_ms(kern), "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
        phase(f"{what}: {k} equals its plain version at its largest call {list(shape)}: "
              f"{rows[k]['ms']:.4f} ms, bound {rows[k]['bound_ms']:.4f} ms")
    return rows


def profile_host_ticks(run_ticks) -> dict:
    """Device time by kernel, idle share and each node's host time and
    device span over `run_ticks()`, under the profiler with the nodes named."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from materialize_tpu_torch.obs import profiler as mzt_profiler

    mzt_profiler.configure(True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_prof = time.perf_counter()
            run_ticks()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t_prof
    finally:
        mzt_profiler.configure(False)
    nodes: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("mzt"):
            nodes[e.name] = nodes.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {**device_breakdown(prof, prof_wall), "host_ms_by_node": nodes}


def run_q3_host(device, sf: float = 1.0, ticks: int = 5, frac: float = 0.02,
                n_cust_retract: int = 1000, seed: int = 0) -> dict:
    """Phase 9: tpch.q3() through render_dataflow (runtime.Dataflow) on
    phase 4's generator, scale, seed and frac, with the plan's int64
    columns: hydrate in one tick, one warm-up tick with the customer
    retraction, `ticks` timed churn ticks (launch counters zeroed just
    before, read just after), then the profiled ticks and the oracle check
    (closures)."""
    from materialize_tpu_torch.dataflow import render_dataflow
    from materialize_tpu_torch.dataflow.runtime import Dataflow
    from materialize_tpu_torch.models import tpch
    from materialize_tpu_torch.ops.kernels import registry
    from materialize_tpu_torch.repr.batch import UpdateBatch
    from materialize_tpu_torch.storage import TpchGenerator

    phase(f"q3 host: generating TPC-H sf={sf}")
    gen = TpchGenerator(sf=sf, seed=seed, device=device)
    df = render_dataflow(tpch.q3(), device=device)
    if not isinstance(df, Dataflow):
        raise AssertionError(f"render_dataflow gave {type(df).__name__}, not runtime.Dataflow")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    init = gen.initial_batches(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df.step(1, {k: init[k] for k in ("customer", "orders", "lineitem")})
    torch.cuda.synchronize()
    hydrate_s = time.perf_counter() - t0
    del init
    phase(f"q3 host: hydrated in {hydrate_s:.2f}s")

    n = n_cust_retract
    cc = tuple(c[:n] for c in gen._customer)
    d_cust = UpdateBatch.build((), cc, np.full(n, 2), -np.ones(n, dtype=np.int64), device=device)
    gen._customer = tuple(c[n:] for c in gen._customer)
    refreshes, n_updates = [], []
    for tk in range(2, 3 + ticks + PROFILED_TICKS):
        r = gen.refresh(tk, frac=frac)
        refreshes.append((tk, r))
        n_updates.append(int(r["orders"].count()) + int(r["lineitem"].count()))
    tk, r = refreshes[0]
    df.step(tk, {"customer": d_cust, **r})
    torch.cuda.synchronize()
    phase("q3 host: warm-up tick (customer retraction) done")

    registry.reset_launches()
    registry.SAMPLES = {}
    syncs0 = host_syncs()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for tk, r in refreshes[1 : 1 + ticks]:
        df.step(tk, r)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = dict(registry.LAUNCHES)
    samples, registry.SAMPLES = registry.SAMPLES, None
    syncs = host_syncs() - syncs0
    timed = sum(n_updates[1 : 1 + ticks])
    out = {
        "sf": sf, "frac": frac, "ticks": ticks, "renderer": type(df).__name__,
        "hydrate_s": hydrate_s, "updates": timed, "seconds": elapsed,
        "updates_per_s": timed / elapsed, "host_syncs_per_tick": syncs / ticks,
        "launches": launches, "peak_mem_gib": (torch.cuda.max_memory_allocated() - resident) / 2**30,
    }
    phase(f"q3 host: {timed} updates in {elapsed:.4f}s over {ticks} ticks = "
          f"{out['updates_per_s']:.1f} updates/s; {out['host_syncs_per_tick']} host syncs per "
          f"tick; peak {out['peak_mem_gib']:.2f} GiB; launches {launches}")
    out["kernels"] = host_kernel_rows(samples, launches, "q3 host")
    del samples

    def profiled() -> dict:
        def run():
            for tk, r in refreshes[1 + ticks :]:
                df.step(tk, r)
        return {"profile": profile_host_ticks(run)}

    def check() -> dict:
        want = tpch.q3_oracle(gen._customer, gen._orders_store, gen._lineitem_store)
        want = {k: v for k, v in want.items() if v != 0}
        got = {(r[0], r[1], r[2]): r[3] for r in df.peek("idx_q3")}
        if got != want:
            raise AssertionError(f"q3 host view differs from q3_oracle: {len(got)} vs "
                                 f"{len(want)} groups")
        return {"groups": len(got)}

    out["profiled_ticks"], out["check"] = profiled, check
    return out


LIVE_WINDOW = 16  # ticks a bid counts in the sliding window


def auction_host_desc():
    from materialize_tpu_torch.models import auction

    return auction.views(auction.bids_sum_count(), auction.auctions_join_bids(),
                         auction.max_bid_per_auction(), auction.live_bids_sum_count(LIVE_WINDOW),
                         auction.bid_rank())


def auction_host_check(df, gen, last_tick: int) -> dict:
    """Every view against a NumPy oracle over the generator's host rows:
    configs 1, 2 and 4 as in phase 7, the sliding window over the bids of
    the last LIVE_WINDOW ticks, and each bid's row_number in its auction
    (amount descending, then id). Large views compare the index's
    consolidated host columns, ordered by bid id."""
    out = {c: auction_oracle_check(c, df, gen) for c in AUCTION_CONFIGS}
    bids = [np.concatenate(c) for c in zip(*gen.host["bids"])]
    live = bids[4] > last_tick - LIVE_WINDOW
    aid, amount = bids[2][live], bids[3][live]
    n = np.bincount(aid)
    s = np.bincount(aid, weights=amount.astype(np.float64)).astype(np.int64)
    keys = np.flatnonzero(n)
    want = list(zip(keys.tolist(), s[keys].tolist(), n[keys].tolist()))
    if df.peek("idx_live_sum") != want:
        raise AssertionError("sliding-window view differs from its oracle")
    out["live_bids_sum_count"] = {"rows": len(want), "live_bids": int(live.sum())}
    order = np.lexsort((bids[0], -bids[3], bids[2]))
    first = np.r_[True, bids[2][order][1:] != bids[2][order][:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(order)), 0))
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order)) - start + 1
    cols, ncols = df.index_traces["idx_rank"].host_columns()
    if ncols != 6 or not (cols["diffs"] == 1).all():
        raise AssertionError("bid_rank: index rows are not one copy each")
    og = np.argsort(cols["c0"], kind="stable")
    ow = np.argsort(bids[0], kind="stable")
    same = len(og) == len(ow) and all(
        np.array_equal(cols[f"c{i}"][og], w[ow]) for i, w in enumerate(bids + [rank]))
    if not same:
        raise AssertionError("bid_rank view differs from its oracle")
    out["bid_rank"] = {"rows": len(og)}
    return out


def run_auction_host(device) -> dict:
    """Phase 10: configs 1, 2 and 4, the sliding window and the bid rank in
    one description through render_dataflow (runtime.Dataflow), at phase
    7's size: AUCTION_HYDRATE hydration ticks, one warm-up tick,
    AUCTION_TICKS timed ticks (launch counters zeroed just before, read
    just after), then profiled ticks and the oracle check (closures). After
    every tick the dataflow compacts to the tick before and its index and
    error spines shrink to their live rows (`fit_index`): updates/s are
    given with and without its time, its reads apart from the renderer's
    host syncs."""
    from materialize_tpu_torch.dataflow import render_dataflow
    from materialize_tpu_torch.dataflow.runtime import Dataflow
    from materialize_tpu_torch.ops.kernels import registry
    from materialize_tpu_torch.storage import AuctionGenerator

    desc = auction_host_desc()
    df = render_dataflow(desc, device=device)
    if not isinstance(df, Dataflow):
        raise AssertionError(f"render_dataflow gave {type(df).__name__}, not runtime.Dataflow")
    gen = AuctionGenerator(AUCTION_SEED, AUCTION_NEW, device=device, keep_host=True)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fitted = [0, 0.0]  # fit_index's host reads and seconds

    def step(tick, batches):
        df.step(tick, batches)
        df.compact(tick - 1)
        reads, secs = fit_index(df)
        fitted[0] += reads
        fitted[1] += secs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tick in range(1, AUCTION_HYDRATE + 1):
        step(tick, gen.next_tick(tick, AUCTION_BIDS))
    torch.cuda.synchronize()
    hydrate_s = time.perf_counter() - t0
    warm = AUCTION_HYDRATE + 1
    step(warm, gen.next_tick(warm, AUCTION_BIDS))
    later = [(tk, gen.next_tick(tk, AUCTION_BIDS))
             for tk in range(warm + 1, warm + 1 + AUCTION_TICKS + PROFILED_TICKS)]
    torch.cuda.synchronize()
    phase(f"auction host: hydrated {AUCTION_HYDRATE} ticks in {hydrate_s:.2f}s, "
          f"warm-up tick {warm} done")

    registry.reset_launches()
    registry.SAMPLES = {}
    syncs0 = host_syncs()
    fit0 = list(fitted)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for tk, b in later[:AUCTION_TICKS]:
        step(tk, b)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = dict(registry.LAUNCHES)
    samples, registry.SAMPLES = registry.SAMPLES, None
    syncs = host_syncs() - syncs0
    fit_s = fitted[1] - fit0[1]
    rows = AUCTION_BIDS + AUCTION_NEW
    info = df.arrangement_info()
    out = {
        "views": sorted(desc.index_exports), "live_window_ticks": LIVE_WINDOW,
        "hydrate_ticks": AUCTION_HYDRATE, "hydrate_s": hydrate_s,
        "timed_ticks": [tk for tk, _b in later[:AUCTION_TICKS]],
        "updates": rows * AUCTION_TICKS, "seconds": elapsed,
        "updates_per_s": rows * AUCTION_TICKS / elapsed,
        "fit_index_s": fit_s, "fit_index_share": fit_s / elapsed,
        "updates_per_s_without_fit": rows * AUCTION_TICKS / (elapsed - fit_s),
        "fit_index_reads_per_tick": (fitted[0] - fit0[0]) / AUCTION_TICKS,
        "host_syncs_per_tick": syncs / AUCTION_TICKS, "launches": launches,
        "state_bytes": sum(r[-1] for r in info if r[1] >= 0),
        "index_bytes": sum(r[-1] for r in info if r[1] < 0),
        "bytes_by_spine": {f"{r[0]}:{r[2]}": r[-1] for r in info},
        "peak_mem_gib": (torch.cuda.max_memory_allocated() - resident) / 2**30,
    }
    phase(f"auction host: {out['updates']} updates in {elapsed:.4f}s over {AUCTION_TICKS} "
          f"ticks = {out['updates_per_s']:.1f} updates/s ({out['updates_per_s_without_fit']:.1f} "
          f"without fit_index, {out['fit_index_share']:.4f} of the wall, "
          f"{out['fit_index_reads_per_tick']} reads per tick); {out['host_syncs_per_tick']} host "
          f"syncs per tick; state {out['state_bytes']} B, index {out['index_bytes']} B; peak "
          f"{out['peak_mem_gib']:.2f} GiB; launches {launches}")
    out["kernels"] = host_kernel_rows(samples, launches, "auction host")
    del samples

    def profiled() -> dict:
        def run():
            for tk, b in later[AUCTION_TICKS:]:
                step(tk, b)
        return {"profile": profile_host_ticks(run)}

    out["profiled_ticks"] = profiled
    out["check"] = lambda: auction_host_check(df, gen, later[-1][0])
    return out


def _batch_bytes(b) -> list:
    from materialize_tpu_torch import interop

    return None if b is None else [a.tobytes() for a in interop.to_numpy(b)]


def _same_results(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    for k in a:
        if (a[k] is None) != (b[k] is None):
            return False
        if a[k] is not None and any(_batch_bytes(x) != _batch_bytes(y)
                                    for x, y in zip(a[k], b[k])):
            return False
    return True


def _peeks(df) -> dict:
    out = {}
    for idx in df.index_traces:
        try:
            out[idx] = df.peek(idx)
        except RuntimeError as e:  # an error collection: its message
            out[idx] = str(e)
    return out


def run_shared_case(device, compare) -> tuple:
    """Phase 11's shared arrangements: on each device, two dataflows of
    models/operators.py's `shared_desc` read one TraceManager (the second
    rendered at as_of 3 and hydrated from the sources' snapshots), the
    card's against the CPU's after every tick, `sharing_rows` too. Returns
    (ticks, the node kinds rendered)."""
    from materialize_tpu_torch.arrangement.trace_manager import TraceManager
    from materialize_tpu_torch.dataflow import render_dataflow
    from materialize_tpu_torch.models import operators as OPS
    from materialize_tpu_torch.repr.batch import UpdateBatch

    devices = ("cpu", device)
    tms = {d: TraceManager() for d in devices}
    dfs = {(d, "mv1"): render_dataflow(OPS.shared_desc("first"), traces=tms[d],
                                       trace_reader="mv1", device=d) for d in devices}
    hist: dict = {s: [] for s in OPS.SHARED_SOURCES}

    def batches(d, parts, tick):
        out = {}
        for src, cols_diffs in parts.items():
            cols = tuple(np.concatenate([c[i] for c, _ in cols_diffs])
                         for i in range(len(OPS.SHARED_SOURCES[src])))
            diffs = np.concatenate([df for _, df in cols_diffs])
            out[src] = UpdateBatch.build((), cols, np.full(len(diffs), tick), diffs, device=d)
        return out

    def check(names, res, what):
        for name in names:
            compare({d: dfs[(d, name)] for d in devices},
                    {d: res[(d, name)] for d in devices}, f"shared {name} {what}")
        if tms["cpu"].sharing_rows() != tms[device].sharing_rows():
            raise AssertionError(f"shared {what}: the card's sharing rows differ")

    ticks = OPS.shared_ticks(5)
    for tick, inputs in enumerate(ticks, start=1):
        for src, cd in inputs.items():
            hist[src].append(cd)
        names = ["mv1"] if tick < 4 else ["mv1", "mv2"]
        res = {(d, n): dfs[(d, n)].step(tick, batches(d, {s: [c] for s, c in inputs.items()},
                                                       tick))
               for d in devices for n in names}
        check(names, res, f"tick {tick}")
        if tick == 3:  # a late import, hydrated from the snapshots at as_of 3
            for d in devices:
                dfs[(d, "mv2")] = render_dataflow(OPS.shared_desc("second", 3), traces=tms[d],
                                                  trace_reader="mv2", device=d)
            res = {(d, "mv2"): dfs[(d, "mv2")].step(3, batches(d, hist, 3)) for d in devices}
            check(["mv2"], res, "hydration")
    if tms[device].stats["imports"] <= 0:
        raise AssertionError("shared: no import hit")
    kinds = {type(n).__name__ for (d, _n), df in dfs.items() if d == device
             for _o, ops, _r in df.builds for n, _i in ops}
    return len(ticks), kinds


def run_node_cases(device) -> dict:
    """Phase 11: every node kind of the host renderer on the card against
    the port's own CPU run of the same plans (models/operators.py, Q3 at sf
    0.001, generate_series through FusedDataflow, and two dataflows
    sharing arrangements through a TraceManager), byte for byte after every
    tick: each object's oks and errs, the peeks, the frontier and
    arrangement_info. probe, probe2, multi_take and run_sum must launch."""
    from materialize_tpu_torch.dataflow import render_dataflow
    from materialize_tpu_torch.dataflow.fused import FusedCaps, FusedDataflow
    from materialize_tpu_torch.models import operators as OPS
    from materialize_tpu_torch.models import tpch
    from materialize_tpu_torch.ops.kernels import registry
    from materialize_tpu_torch.repr.batch import UpdateBatch
    from materialize_tpu_torch.storage import TpchGenerator

    devices = ("cpu", device)

    def compare(dfs, res, what):
        if not _same_results(res["cpu"], res[device]):
            raise AssertionError(f"{what}: the card's outputs differ from the CPU's")
        a, b = dfs["cpu"], dfs[device]
        if (_peeks(a), a.frontier, a.arrangement_info()) != \
                (_peeks(b), b.frontier, b.arrangement_info()):
            raise AssertionError(f"{what}: the card's peeks or state differ from the CPU's")

    registry.reset_launches()
    kinds: set = set()
    ticks_run = {}
    cases = dict(OPS.CASES)
    cases["series_fused"] = (OPS.series_desc, OPS.series_ticks, None)
    for name, (desc_fn, ticks_fn, compact) in cases.items():
        if name == "series_fused":
            caps = FusedCaps(delta=32, arrangement=256, groups=128, join_out=16, gather=64,
                             ratio=2)
            dfs = {d: FusedDataflow(desc_fn(), caps, device=d) for d in devices}
        else:
            dfs = {d: render_dataflow(desc_fn(), device=d) for d in devices}
            kinds |= {type(n).__name__ for _o, ops, _r in dfs[device].builds for n, _i in ops}
        ticks = ticks_fn()
        for tick, inputs in enumerate(ticks, start=1):
            res = {}
            for d, df in dfs.items():
                batches = {s: UpdateBatch.build((), cols, np.full(len(diffs), tick), diffs,
                                                device=d)
                           for s, (cols, diffs) in inputs.items()}
                res[d] = df.step(tick, batches)
                if compact is not None and tick == compact[0]:
                    df.compact(compact[1])
            compare(dfs, res, f"{name} tick {tick}")
        ticks_run[name] = len(ticks)
    gens = {d: TpchGenerator(sf=0.001, seed=7, device=d) for d in devices}
    dfs = {d: render_dataflow(tpch.q3(), device=d) for d in devices}
    kinds |= {type(n).__name__ for _o, ops, _r in dfs[device].builds for n, _i in ops}
    inits = {d: g.initial_batches(0) for d, g in gens.items()}
    res = {d: dfs[d].step(0, {k: inits[d][k] for k in ("customer", "orders", "lineitem")})
           for d in devices}
    compare(dfs, res, "q3 hydration")
    for tick in range(1, 4):
        res = {d: dfs[d].step(tick, gens[d].refresh(tick, frac=0.01)) for d in devices}
        compare(dfs, res, f"q3 tick {tick}")
    ticks_run["q3_sf0.001"] = 4
    ticks_run["shared"], shared_kinds = run_shared_case(device, compare)
    kinds |= shared_kinds
    launches = dict(registry.LAUNCHES)
    missing = [k for k in SINGLE_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"node cases: kernels not launched: {missing}")
    from materialize_tpu_torch.dataflow.runtime import Node

    every = {c.__name__ for c in Node.__subclasses__()}
    if kinds != every:
        raise AssertionError(f"node cases miss {sorted(every - kinds)}")
    return {"cases": ticks_run, "node_kinds": sorted(kinds), "launches": launches}



# -- phase 12: SQL through the port's Coordinator ------------------------------------

SQL_Q3 = """CREATE MATERIALIZED VIEW q3 AS
    SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
           o_orderdate, o_shippriority
    FROM customer, orders, lineitem
    WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
      AND l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15'
      AND l_shipdate > DATE '1995-03-15'
    GROUP BY l_orderkey, o_orderdate, o_shippriority"""
SQL_AUCTION_VIEWS = {
    # the README's view
    "totals": "CREATE MATERIALIZED VIEW totals AS SELECT auction_id, sum(amount) AS total, "
              "count(*) AS n FROM bids GROUP BY auction_id",
    "max_bid": "CREATE MATERIALIZED VIEW max_bid AS SELECT auctions.id, "
               "max(bids.amount) AS top FROM auctions, bids "
               "WHERE auctions.id = bids.auction_id GROUP BY auctions.id",
    "auction_bids": "CREATE MATERIALIZED VIEW auction_bids AS SELECT auctions.id, "
                    "auctions.seller, bids.buyer, bids.amount FROM auctions, bids "
                    "WHERE auctions.id = bids.auction_id",
}
SQL_TIMED = 5  # timed advance() ticks of each SQL phase, after one warm-up tick


SQL_REQUIRED = ("probe", "multi_take", "run_sum")


def sql_kernel_rows(samples: dict, launches: dict, what: str,
                    required: tuple = SQL_REQUIRED) -> dict:
    """As host_kernel_rows, for a SQL phase: the `required` kernels must
    launch in the timed ticks, `probe2` only if the plan merged spines there
    (and `route_dest` and `bucket_rank` only on a mesh); each launched
    kernel's largest call is replayed against its plain version (exact) and
    timed."""
    from materialize_tpu_torch.ops.kernels import registry

    missing = [k for k in required if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched: {missing}")
    rows = {}
    for k in registry.KERNELS:
        if launches[k] <= 0:
            rows[k] = {"launches": 0}
            continue
        shape, (kern, _plain, _library, moved), err = check_largest(k, samples)
        rows[k] = {"launches": launches[k], "shape": list(shape), "max_abs_err": err,
                   "ms": time_ms(kern), "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
        phase(f"{what}: {k} equals its plain version at its largest call {list(shape)}: "
              f"{rows[k]['ms']:.4f} ms, bound {rows[k]['bound_ms']:.4f} ms")
    return rows


def _source_records(coord) -> int:
    return sum(st["records"] for st in coord.source_stats.values())


def _timed_sources(coord) -> list:
    """Time every generator's batch-making call (the sources' host work
    inside advance()): wraps each generator's `refresh`/`next_tick` and
    returns the list the wrappers add their seconds to."""
    spent = [0.0]
    for gen, _gids in coord.generators:
        for name in ("refresh", "next_tick"):
            fn = getattr(gen, name, None)
            if fn is None:
                continue

            def timed(*a, _fn=fn, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    spent[0] += time.perf_counter() - t0
            setattr(gen, name, timed)
    return spent


def _dataflow_s(coord) -> dict:
    """Seconds each of the coordinator's dataflows has spent in `step` so
    far, by its id (its tick histogram, mzt_dataflow_tick_duration_ns)."""
    from materialize_tpu_torch.adapter.coordinator import _TICK_NS

    out = {}
    for gid, _df, _srcs in coord.dataflows:
        v = _TICK_NS.value(dataflow=gid)
        out[gid] = (v[1] if v else 0.0) / 1e9
    return out


def timed_advances(coord, what: str, n_rows: int | None = None,
                   required: tuple = SQL_REQUIRED, after=None) -> dict:
    """One warm-up advance(), then SQL_TIMED timed ones with the launch
    counters zeroed just before and read just after: updates/s (the rows
    the sources committed over the synchronized wall time), host syncs a
    tick, the sources' share of the wall (the generators making their
    batches on the host) and the dataflows' (their `step` calls, also by
    dataflow id), and the kernel replays. `after(coord)`, when given, runs
    after every tick (harness work such as `fit_views`, which returns its
    reads and seconds): its share of the timed wall and its reads are
    reported apart."""
    from materialize_tpu_torch.ops.kernels import registry

    fitted = [0, 0.0]

    def tick():
        coord.advance(n_rows) if n_rows is not None else coord.advance()
        if after is not None:
            reads, secs = after(coord)
            fitted[0] += reads
            fitted[1] += secs

    tick()
    torch.cuda.synchronize()
    registry.reset_launches()
    registry.SAMPLES = {}
    syncs0, rec0, df0 = host_syncs(), _source_records(coord), _dataflow_s(coord)
    fit0 = list(fitted)
    source_s = _timed_sources(coord)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(SQL_TIMED):
        tick()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = dict(registry.LAUNCHES)
    samples, registry.SAMPLES = registry.SAMPLES, None
    updates = _source_records(coord) - rec0
    df1 = _dataflow_s(coord)
    by_df = {gid: (df1[gid] - df0.get(gid, 0.0)) / elapsed for gid in df1}
    out = {"ticks": SQL_TIMED, "updates": updates, "seconds": elapsed,
           "updates_per_s": updates / elapsed,
           "host_syncs_per_tick": (host_syncs() - syncs0) / SQL_TIMED,
           "source_share": source_s[0] / elapsed,
           "dataflow_share": sum(by_df.values()), "dataflow_share_by_id": by_df,
           "launches": launches}
    if after is not None:
        out["fit_share"] = (fitted[1] - fit0[1]) / elapsed
        out["fit_reads_per_tick"] = (fitted[0] - fit0[0]) / SQL_TIMED
    phase(f"{what}: {updates} updates in {elapsed:.4f}s over {SQL_TIMED} advance() ticks = "
          f"{out['updates_per_s']:.1f} updates/s; {out['host_syncs_per_tick']} host syncs per "
          f"tick; of the wall, the sources' batch making {out['source_share']:.1%} and the "
          f"dataflows' steps {out['dataflow_share']:.1%}; "
          f"launches {launches}")
    out["kernels"] = sql_kernel_rows(samples, launches, what, required)
    return out


def run_sql_q3(device, sf: float = 1.0) -> dict:
    """Phase 12a: TPC-H Q3 as SQL text at SF1 through Coordinator.execute:
    the source, the view (hydrated from the storage snapshots, rendered by
    render_dataflow with the shared arrangements), a warm-up and the timed
    advance() ticks (the coordinator's RF1/RF2 refresh at frac 0.001), then
    the profiled ticks and the oracle check (closures)."""
    from materialize_tpu_torch.adapter import Coordinator
    from materialize_tpu_torch.models.tpch import q3_oracle

    coord = Coordinator(device=device)
    t0 = time.perf_counter()
    coord.execute(f"CREATE SOURCE tp FROM LOAD GENERATOR TPCH (SCALE FACTOR {sf})")
    torch.cuda.synchronize()
    source_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    coord.execute(SQL_Q3)
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t0
    df = coord.dataflows[-1][1]
    phase(f"sql q3: source in {source_s:.2f}s, view hydrated in {view_s:.2f}s by "
          f"{type(df).__name__}; sharing {coord.trace_manager.sharing_rows()}")
    out = {"sf": sf, "frac": 0.001, "source_s": source_s, "view_s": view_s,
           "renderer": type(df).__name__, **timed_advances(coord, "sql q3")}

    def profiled() -> dict:
        def run():
            for _ in range(PROFILED_TICKS):
                coord.advance()
        return {"profile": profile_host_ticks(run)}

    def check() -> dict:
        gen = next(g for g, gids in coord.generators if "lineitem" in gids)
        want = q3_oracle(gen._customer_cols(), tuple(gen._orders_store),
                         tuple(gen._lineitem_store),
                         building_code=coord.catalog.dict.lookup("BUILDING"))
        want = {k: v for k, v in want.items() if v != 0}
        rows = coord.execute("SELECT * FROM q3").rows
        got = {(lk, od, sp): round(rev * 10_000) for lk, rev, od, sp in rows}
        if got != want:
            raise AssertionError(f"SQL q3 differs from q3_oracle: {len(got)} vs "
                                 f"{len(want)} groups")
        return {"groups": len(got)}

    out["profiled_ticks"], out["check"] = profiled, check
    return out


def run_sql_auction(device) -> dict:
    """Phase 12b: the README's auction source and views through SQL: 64
    advance(n_rows=65536) ticks before any view (2^22 bids), the three
    views hydrated from snapshots (two share the auctions and bids
    arrangements), a warm-up and the timed ticks, then the profiled ticks
    and the checks against NumPy oracles over the generator's rows
    (closures)."""
    from materialize_tpu_torch.adapter import Coordinator

    coord = Coordinator(device=device)
    coord.execute("CREATE SOURCE auction_house FROM LOAD GENERATOR AUCTION")
    gen = next(g for g, gids in coord.generators if "bids" in gids)
    gen.host = {"auctions": [], "bids": []}  # keep every tick's rows for the oracles
    t0 = time.perf_counter()
    for _ in range(AUCTION_HYDRATE):
        coord.advance(AUCTION_BIDS)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    view_s = {}
    for name, sql in SQL_AUCTION_VIEWS.items():
        t0 = time.perf_counter()
        coord.execute(sql)
        torch.cuda.synchronize()
        view_s[name] = time.perf_counter() - t0
    tm = coord.trace_manager
    phase(f"sql auction: {AUCTION_HYDRATE} ticks ingested in {ingest_s:.2f}s; views hydrated "
          f"in {view_s}; traces {tm.trace_count()}, import hit rate {tm.import_hit_rate()}, "
          f"sharing {tm.sharing_rows()}")
    if tm.stats["imports"] <= 0:
        raise AssertionError("sql auction: no shared-trace import hit")
    out = {"bids_per_tick": AUCTION_BIDS, "ingest_s": ingest_s, "view_s": view_s,
           **timed_advances(coord, "sql auction", AUCTION_BIDS),
           "trace_count": tm.trace_count(), "import_hit_rate": tm.import_hit_rate(),
           "sharing_rows": tm.sharing_rows()}

    def profiled() -> dict:
        def run():
            for _ in range(PROFILED_TICKS):
                coord.advance(AUCTION_BIDS)
        return {"profile": profile_host_ticks(run)}

    def check() -> dict:
        bids = [np.concatenate(c) for c in zip(*gen.host["bids"])]
        auctions = [np.concatenate(c) for c in zip(*gen.host["auctions"])]
        b_auction, b_buyer, b_amount = bids[2], bids[1], bids[3]
        order = np.argsort(auctions[0], kind="stable")
        a_ids, a_seller = auctions[0][order], auctions[1][order]
        keys, inv = np.unique(b_auction, return_inverse=True)
        total = np.bincount(inv, weights=b_amount.astype(np.float64)).astype(np.int64)
        count = np.bincount(inv)
        top = np.full(len(keys), np.iinfo(np.int64).min)
        np.maximum.at(top, inv, b_amount)
        live = np.isin(keys, a_ids)
        want = {
            "totals": sorted(zip(keys.tolist(), total.tolist(), count.tolist())),
            "max_bid": sorted(zip(keys[live].tolist(), top[live].tolist())),
        }
        got = {name: sorted(coord.execute(f"SELECT * FROM {name}").rows)
               for name in ("totals", "max_bid")}
        for name in want:
            if got[name] != want[name]:
                raise AssertionError(f"sql auction: {name} differs from its oracle")
        # the join's 2^22-row view, read on the card: its index against the
        # oracle's columns (auction, seller, buyer, amount), sorted
        jdf = next(df for gid, df, _s in coord.dataflows
                   if gid == coord.catalog.get("auction_bids").global_id)
        h = next(iter(jdf.index_traces.values())).merged().to_host()
        got_j = np.stack([np.asarray(c) for c in h["vals"]], 1)
        got_j = np.repeat(got_j, h["diffs"], axis=0)
        m = np.isin(b_auction, a_ids)
        seller = a_seller[np.searchsorted(a_ids, b_auction[m])]
        want_j = np.stack([b_auction[m], seller, b_buyer[m], b_amount[m]], 1)
        got_j = got_j[np.lexsort(got_j.T[::-1])]
        want_j = want_j[np.lexsort(want_j.T[::-1])]
        if got_j.shape != want_j.shape or not np.array_equal(got_j, want_j):
            raise AssertionError(f"sql auction: auction_bids differs from its oracle "
                                 f"({got_j.shape} vs {want_j.shape})")
        top5 = coord.execute("SELECT * FROM totals ORDER BY total DESC LIMIT 5").rows
        want5 = sorted(want["totals"], key=lambda r: -r[1])[:5]
        if [r[1] for r in top5] != [r[1] for r in want5]:
            raise AssertionError(f"sql auction: top 5 totals {top5} vs {want5}")
        return {"totals": len(got["totals"]), "max_bid": len(got["max_bid"]),
                "auction_bids": int(got_j.shape[0]), "top5": top5}

    out["profiled_ticks"], out["check"] = profiled, check
    return out


def run_sql_mesh(device) -> dict:
    """Phase 13b: the README's `totals` view through
    Coordinator(mesh=make_mesh(4)) with the fused renderer, over the
    auction source: `totals` rendered on the 4 workers (exchange_backend
    'auto' with a mesh), then exchange_backend = 'host' and the same view
    again as `totals_host`, on one worker; then 64 advance(n_rows=65536)
    ticks (2^22 bids) through both, a warm-up and the timed ticks, then the
    profiled ticks and both views against a NumPy oracle over the
    generator's rows (closures). Every tick is followed by `fit_views`,
    timed apart. The views come before the data: hydrated
    from a 2^22-row snapshot, a fused view keeps a delta capacity of 2^22
    rows (2^20 a worker), and every later tick's output would join 4
    workers' 2^23-row batches in its index spine."""
    from materialize_tpu_torch.adapter import Coordinator
    from materialize_tpu_torch.dataflow.fused import FusedDataflow
    from materialize_tpu_torch.ops.kernels import registry
    from materialize_tpu_torch.parallel.mesh import make_mesh

    coord = Coordinator(mesh=make_mesh(N_WORKERS), device=device)
    coord.execute("ALTER SYSTEM SET enable_fused_render = true")
    coord.execute("CREATE SOURCE auction_house FROM LOAD GENERATOR AUCTION")
    gen = next(g for g, gids in coord.generators if "bids" in gids)
    gen.host = {"auctions": [], "bids": []}  # keep every tick's rows for the oracle
    totals = SQL_AUCTION_VIEWS["totals"]
    views = {"totals": totals, "totals_host": totals.replace("VIEW totals", "VIEW totals_host")}
    view_s, shards, gids = {}, {}, {}
    for name, sql in views.items():
        if name == "totals_host":
            coord.execute("ALTER SYSTEM SET exchange_backend = 'host'")
        t0 = time.perf_counter()
        coord.execute(sql)
        torch.cuda.synchronize()
        view_s[name] = time.perf_counter() - t0
        gid, df, _srcs = coord.dataflows[-1]
        if not isinstance(df, FusedDataflow):
            raise AssertionError(f"sql mesh: {name} rendered as {type(df).__name__}")
        shards[name], gids[name] = df.n_shards, gid
    if shards != {"totals": N_WORKERS, "totals_host": 1}:
        raise AssertionError(f"sql mesh: workers per view {shards}")
    t0 = time.perf_counter()
    for _ in range(AUCTION_HYDRATE):
        coord.advance(AUCTION_BIDS)
        fit_views(coord)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    phase(f"sql mesh: views rendered in {view_s}, workers per view {shards}; "
          f"{AUCTION_HYDRATE} ticks through both in {ingest_s:.2f}s")

    out = {"bids_per_tick": AUCTION_BIDS, "ingest_s": ingest_s, "view_s": view_s,
           "workers": shards,
           **timed_advances(coord, "sql mesh", AUCTION_BIDS, registry.KERNELS, fit_views)}
    out["view_step_share"] = {name: out["dataflow_share_by_id"][gid]
                              for name, gid in gids.items()}
    out["exchange_metrics"] = exchange_metrics()
    phase(f"sql mesh: each view's steps' share of the timed wall {out['view_step_share']}; "
          f"fit_views {out['fit_share']:.4f} of the wall, {out['fit_reads_per_tick']} reads "
          f"per tick; {out['exchange_metrics']}")

    def profiled() -> dict:
        def run():
            for _ in range(PROFILED_TICKS):
                coord.advance(AUCTION_BIDS)
                fit_views(coord)
        return {"profile": profile_host_ticks(run)}

    def check() -> dict:
        bids = [np.concatenate(c) for c in zip(*gen.host["bids"])]
        keys, inv = np.unique(bids[2], return_inverse=True)
        total = np.bincount(inv, weights=bids[3].astype(np.float64)).astype(np.int64)
        want = sorted(zip(keys.tolist(), total.tolist(), np.bincount(inv).tolist()))
        for name in views:
            if sorted(coord.execute(f"SELECT * FROM {name}").rows) != want:
                raise AssertionError(f"sql mesh: {name} differs from its oracle")
        return {name: len(want) for name in views}

    out["profiled_ticks"], out["check"] = profiled, check
    return out


MESH_RESULT = "phase 13 result: "


def mesh_phase() -> dict:
    """Phase 13 (the child process's work): 13a's three configs and 13b,
    every timing first, then the profiled ticks and the checks."""
    from materialize_tpu_torch.parallel.mesh import make_mesh

    mesh_auctions = {config: run_auction(config, "cuda", mesh=make_mesh(N_WORKERS))
                     for config in AUCTION_CONFIGS}
    sqm = run_sql_mesh("cuda")
    for config, au in mesh_auctions.items():
        au.update(au.pop("profiled_ticks")())
        au["view"] = au.pop("check")()
        phase(f"mesh auction {config}: view equals its oracle ({au['view']}); profile "
              f"{json.dumps(au['profile'])}")
    sqm.update(sqm.pop("profiled_ticks")())
    sqm["view"] = sqm.pop("check")()
    phase(f"sql mesh: views equal their oracle ({sqm['view']}); profile "
          f"{json.dumps(sqm['profile'])}")
    return {"auction_mesh": mesh_auctions, "sql_mesh": sqm}


def run_mesh_child() -> dict:
    """Run phase 13 as `chip_smoke.py --mesh-phase` in a child process, its
    lines echoed here, and return its result; raise if it failed. The
    earlier phases keep their dataflows until their profiled ticks at the
    end, and the mesh views need the card's memory as phase 7's do."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-phase"],
                            stdout=subprocess.PIPE, text=True)
    result = None
    try:
        for line in proc.stdout:
            if line.startswith(MESH_RESULT):
                result = json.loads(line[len(MESH_RESULT):])
            else:
                print(line, end="", flush=True)
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0 or result is None:
        raise AssertionError(f"phase 13's process failed (rc {rc})")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--mesh-phase"]:
        from materialize_tpu_torch.ops.kernels import registry

        registry.build_all()
        print(MESH_RESULT + json.dumps(mesh_phase()), flush=True)
        return 0
    from materialize_tpu_torch.models.fused_q3 import read_view
    from materialize_tpu_torch.models.tpch import q3_oracle
    from materialize_tpu_torch.ops.kernels import registry
    from materialize_tpu_torch.parallel.devicemesh import overflow_retries

    device = "cuda"
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase(f"device {name} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    registry.build_all()
    phase(f"kernels built in {registry.BUILD_SECONDS:.1f}s")
    for stem, log in registry.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line:
                print(f"#   {stem}: {line.strip()}")

    n_checks = edge_cases(device)
    phase(f"{n_checks} edge-case checks: every kernel equals its plain version")

    q3 = run_q3(device, sf=1.0, ticks=5, frac=0.02, n_cust_retract=1000)
    launches, samples = q3.pop("launches"), q3.pop("samples")
    phase(f"Q3 sf=1: {q3['timed_updates']} updates in {q3['elapsed_s']:.4f}s over "
          f"{q3['ticks']} ticks = {q3['updates_per_s']:.1f} updates/s; "
          f"{q3['host_syncs_per_tick']} host syncs per tick; launches {launches}")
    missing = [k for k in SINGLE_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for k in SINGLE_PATH:
        shapes = sorted(samples[k]["shapes"].items(), key=lambda kv: -kv[1])
        print(f"#   {k} shapes in the timed ticks (shape: calls): {shapes[:12]}")
    _size, shape, (a, q, _side) = samples["probe"]["largest"]
    mix = probe_branch_mix(a, q, *kernel_shapes()["probe"])
    phase(f"probe branch mix at its largest call {shape}: {json.dumps(mix)}")
    rows = kernel_table(SINGLE_PATH, samples, launches)

    sh = run_sharded(sf=1.0, ticks=5, frac=0.02, n_cust_retract=1000)
    sh_launches, sh_samples = sh.pop("launches"), sh.pop("samples")
    phase(f"sharded Q3 sf=1 on {sh['mesh']}: {sh['timed_updates']} updates in "
          f"{sh['elapsed_s']:.4f}s over {sh['ticks']} ticks = {sh['updates_per_s']:.1f} "
          f"updates/s; {sh['host_syncs_per_tick']} host syncs per tick (all workers); "
          f"launches {sh_launches}")
    missing = [k for k in registry.KERNELS if sh_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the sharded path: {missing}")
    for k in ("route_dest", "bucket_rank"):
        shapes = sorted(sh_samples[k]["shapes"].items(), key=lambda kv: -kv[1])
        print(f"#   {k} shapes in the sharded timed ticks (shape: calls): {shapes}")
    # the single path's kernels also at their largest calls of the sharded
    # phase (per-worker shapes); the route kernels run only there
    for row in rows:
        shape, _fns, err = check_largest(row["name"], sh_samples)
        row["sharded_shape"], row["sharded_max_abs_err"] = list(shape), err
        phase(f"{row['name']} equals its plain version at the sharded phase's {shape}")
    sh_rows = kernel_table(("route_dest", "bucket_rank"), sh_samples, sh_launches)

    auctions = {config: run_auction(config, device) for config in AUCTION_CONFIGS}

    q3h = run_q3_host(device)
    auh = run_auction_host(device)
    nodes = run_node_cases(device)
    phase(f"node cases: every node kind on the card equals the CPU run byte for byte: "
          f"{json.dumps(nodes)}")
    sq3 = run_sql_q3(device)
    sau = run_sql_auction(device)

    # every CUDA-event timing is done: now the profiler (the short sessions
    # first: after the ticks' long ones, short ones lost events), and the views
    device_times(rows, samples)
    device_times(sh_rows, sh_samples)
    del samples, sh_samples
    done = sh.pop("profiled_ticks")()
    sh["profile"] = done["profile"]
    gen = sh.pop("gen")
    want = q3_oracle(gen._customer, gen._orders_store, gen._lineitem_store)
    view: dict = {}
    for state in done.pop("states"):
        part = read_view(state)
        if set(part) & set(view):
            raise AssertionError("a group is owned by more than one worker")
        view.update(part)
    if view != want:
        raise AssertionError(f"sharded view differs from q3_oracle: {len(view)} vs "
                             f"{len(want)} groups")
    phase(f"sharded view (union of {len(sh['mesh'])} workers) equals q3_oracle: "
          f"{len(view)} groups")
    del gen, view, want, done

    done = q3.pop("profiled_ticks")()
    q3["profile"] = done["profile"]
    gen = q3.pop("gen")
    view = read_view(done.pop("state"))
    want = q3_oracle(gen._customer, gen._orders_store, gen._lineitem_store)
    if view != want:
        raise AssertionError(f"view differs from q3_oracle: {len(view)} vs {len(want)} groups")
    phase(f"view equals q3_oracle: {len(view)} groups")
    del gen, view, want, done
    for config, au in auctions.items():
        au.update(au.pop("profiled_ticks")())
        au["view"] = au.pop("check")()
        phase(f"auction {config}: view equals its oracle ({au['view']}); profile "
              f"{json.dumps(au['profile'])}")
    for label, host in (("q3 host", q3h), ("auction host", auh), ("sql q3", sq3),
                        ("sql auction", sau)):
        host.update(host.pop("profiled_ticks")())
        host["view"] = host.pop("check")()
        phase(f"{label}: views equal their oracles ({host['view']}); profile "
              f"{json.dumps(host['profile'])}")
    # every earlier phase's dataflows went with its closures: phase 13 gets
    # the card's memory in a process of its own
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"phase 13 in a process of its own; this one holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    mesh = run_mesh_child()
    mesh_auctions, sqm = mesh["auction_mesh"], mesh["sql_mesh"]
    for config, au in mesh_auctions.items():
        if au["view"]["digest"] != auctions[config]["view"]["digest"]:
            raise AssertionError(f"mesh auction {config}: view differs from phase 7's")
        phase(f"mesh auction {config}: view equals phase 7's")
    rows += sh_rows
    for row in rows:
        row["launches_sharded"] = sh_launches[row["name"]]
        row["auction"] = {config: au["kernels"].get(row["name"], {"launches": 0})
                          for config, au in auctions.items()}
        row["q3_host"] = q3h["kernels"].get(row["name"], {"launches": 0})
        row["auction_host"] = auh["kernels"].get(row["name"], {"launches": 0})
        row["node_cases_launches"] = nodes["launches"][row["name"]]
        row["sql_q3"] = sq3["kernels"].get(row["name"], {"launches": 0})
        row["sql_auction"] = sau["kernels"].get(row["name"], {"launches": 0})
        row["fused_mesh"] = {config: au["kernels"].get(row["name"], {"launches": 0})
                             for config, au in mesh_auctions.items()}
        row["sql_mesh"] = sqm["kernels"].get(row["name"], {"launches": 0})

    print(json.dumps({"q3": {
        "sf": 1.0, "ticks": q3["ticks"], "frac": 0.02, "scale": q3["scale"],
        "updates": q3["timed_updates"], "seconds": q3["elapsed_s"],
        "updates_per_s": q3["updates_per_s"], "hydrate_s": q3["hydrate_s"],
        "host_syncs_per_tick": q3["host_syncs_per_tick"],
        "hydrate_launches": q3["hydrate_launches"],
        "peak_mem_gib": q3["peak_mem_gib"],
        "profile": q3["profile"],
    }}))
    print(json.dumps({"q3_sharded": {
        "sf": 1.0, "workers": sh["mesh"], "ticks": sh["ticks"], "frac": 0.02,
        "scale": sh["scale"], "caps_per_worker": dataclasses.asdict(sh["caps"]),
        "updates": sh["timed_updates"], "seconds": sh["elapsed_s"],
        "updates_per_s": sh["updates_per_s"], "hydrate_s": sh["hydrate_s"],
        "host_syncs_per_tick": sh["host_syncs_per_tick"], "peak_mem_gib": sh["peak_mem_gib"],
        "overflow_retries": overflow_retries(), "launches": sh_launches,
        "profile": sh["profile"],
    }}))
    for au in auctions.values():
        print(json.dumps({"auction": au}))
    print(json.dumps({"q3_host": q3h}))
    print(json.dumps({"auction_host": auh}))
    print(json.dumps({"node_cases": nodes}))
    print(json.dumps({"sql_q3": sq3}))
    print(json.dumps({"sql_auction": sau}))
    for au in mesh_auctions.values():
        print(json.dumps({"auction_mesh": au}))
    print(json.dumps({"sql_mesh": sqm}))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
