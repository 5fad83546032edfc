#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Two paths run at TPC-H scale factor 1: the single-GPU Q3 maintenance tick
(materialize_tpu_torch/models/fused_q3.py), and the same tick sharded over
an in-process mesh of 4 workers on the card's devices (all 4 on `cuda:0` on
a machine with one card), whose exchange runs the `route_dest` and
`bucket_rank` kernels. Phases, each of which fails the run on any error:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the kernels from materialize_tpu_torch/csrc/;
3. kernel edge cases: every kernel against its plain PyTorch version;
4. Q3: generate the tables, hydrate, one warm-up tick that also retracts
   some customers (so the customer delta path runs), then the churn ticks
   at frac = 0.02, timed; on a capacity overflow everything reruns with
   doubled capacities. The launch counters are zeroed just before and read
   just after; every kernel must have launched;
5. kernels at the main path's shapes: each kernel's largest call of phase 4
   is replayed on the same inputs against its plain version (exact
   equality), and timed with CUDA events beside the plain version and, where
   one PyTorch call computes the same function, that call (`library_ms`);
6. the maintained view must equal the brute-force `q3_oracle` over the
   generator's host mirrors, with no error rows and no overflow;
7. sharded Q3: hydrate on one device, partition the state over the 4
   workers by `route_dest`, one warm-up tick with the customer retraction,
   then the churn ticks, timed, on the mesh; the same overflow ladder; the
   launch counters are zeroed just before the timed ticks and read just
   after, and all six kernels must have launched; the union of the
   workers' views must equal `q3_oracle`. Every kernel is then replayed
   against its plain version at its largest call of this phase, and
   `route_dest` and `bucket_rank` are timed there as in phase 5.

It prints the kernel table as one JSON line, then the device line as the
last line. It exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
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


def kernel_ms(fn, iters: int = 20) -> float:
    """Mean device time of the CUDA kernels that fn() launches, by the
    profiler: the kernels' own time, without the gaps in which the host
    issues the next call (which `time_ms` includes when a call is short)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters


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
    # a run spanning the whole array across many tiles
    n = 3_000_000
    rs = np.zeros(n, dtype=bool)
    rs[0] = True
    col = t(rng.integers(-(1 << 62), 1 << 62, n))
    check("run_sum", segsum.run_sum(t(rs), (col,)), segsum.plain_run_sum(t(rs), (col,)))

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

    # where the time goes: more churn ticks under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_prof = time.perf_counter()
        for tk, r in refreshes[1 + ticks :]:
            state, out, errs, over = q3_tick(state, empty_c, r["orders"], r["lineitem"], tk,
                                             caps=caps, with_cust=False)
            flags.append(over)
            errs_live.append(errs.count())
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t_prof
    if bool(torch.cat(flags).any()):
        return retry("tick overflow")
    n_errs = int(torch.stack(errs_live).sum())
    if n_errs:
        raise AssertionError(f"{n_errs} error rows in the ticks")
    timed = sum(n_updates[1 : 1 + ticks])
    return {
        "gen": gen, "state": state, "caps": caps, "scale": scale,
        "hydrate_s": hydrate_s, "hydrate_launches": hydrate_launches,
        "timed_updates": timed, "elapsed_s": elapsed, "ticks": ticks,
        "updates_per_s": timed / elapsed, "launches": launches, "samples": samples,
        "host_syncs_per_tick": syncs / ticks,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profile": device_breakdown(prof, prof_wall),
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

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_prof = time.perf_counter()
        for tk, d_ords, d_lis in refreshes[1 + ticks :]:
            tick(churn, empty_c, tk, d_ords, d_lis)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t_prof
    if bool(torch.cat([f.to(mesh[0]) for f in flags]).any()):
        return retry("tick overflow")
    n_errs = int(torch.stack(errs_live).sum())
    if n_errs:
        raise AssertionError(f"sharded: {n_errs} error rows in the ticks")
    timed = sum(n_updates[1 : 1 + ticks])
    return {
        "gen": gen, "states": states, "caps": caps, "scale": scale,
        "mesh": [str(d) for d in mesh],
        "hydrate_s": hydrate_s, "timed_updates": timed, "elapsed_s": elapsed, "ticks": ticks,
        "updates_per_s": timed / elapsed, "launches": launches, "samples": samples,
        "host_syncs_per_tick": syncs / ticks,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profile": device_breakdown(prof, prof_wall),
    }


_OURS = {"scan_tile": "run_sum", "fix_tile": "run_sum", "take_kernel": "multi_take",
         "probe2_kernel": "probe2", "probe_kernel": "probe", "route_kernel": "route_dest",
         "tile_max": "bucket_rank", "apply_tile": "bucket_rank"}


def device_breakdown(prof, wall_s: float) -> dict:
    """Device time by kernel name over the profiled ticks, and the idle share."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    n_events = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_events += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
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
        "idle_share": 1.0 - busy / (wall_s * 1e3), "port_kernels_ms": ours,
        "top": [[name[:90], ms] for name, ms in top],
    }


# -- phase 5: kernels at the main path's shapes ----------------------------------


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def replay(name: str, args: tuple):
    """(kernel fn, plain fn, library fn or None, bytes the function must move)."""
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
                _bytes(a) + _bytes(q) + q.numel() * 8)
    if name == "probe2":
        ah, al, qh, ql, side = args
        # one int64 key that orders like the (hi, lo) pair of u32 values
        ka = ((ah - (1 << 31)) << 32) + al
        kq = ((qh - (1 << 31)) << 32) + ql
        return (lambda: probe.probe2(ah, al, qh, ql, side),
                lambda: probe.plain_searchsorted2(ah, al, qh, ql, side),
                lambda: torch.searchsorted(ka, kq, right=side == "right"),
                _bytes(ah) + _bytes(al) + _bytes(qh) + _bytes(ql) + qh.numel() * 8)
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

        moved = _bytes(idx) + sum(min(n, m) * c.element_size() + m * c.element_size()
                                  for c in cols)
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
    if name in ("probe2", "route_dest"):  # yardsticks must compute the same function
        if not torch.equal(fns[2]().to(want.dtype), want):
            raise AssertionError(f"{name} library yardstick disagrees")
    return shape, fns, _max_abs_err(got, want)


def kernel_table(names, samples: dict, launches: dict) -> list:
    """Each kernel's largest call in `samples`, replayed against its plain
    version and timed."""
    rows = []
    for name in names:
        shape, (kern, plain, library, moved), err = check_largest(name, samples)
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(library) if library is not None else None,
            "kernel_device_ms": kernel_ms(kern),
            "shape": list(shape),
        }
        rows.append(row)
        phase(f"{name} at {shape}: {row['ms']:.4f} ms (device {row['kernel_device_ms']:.4f}), "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, "
              f"library {row['library_ms']}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
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

    gen = q3.pop("gen")
    view = read_view(q3.pop("state"))
    want = q3_oracle(gen._customer, gen._orders_store, gen._lineitem_store)
    if view != want:
        raise AssertionError(f"view differs from q3_oracle: {len(view)} vs {len(want)} groups")
    phase(f"view equals q3_oracle: {len(view)} groups")
    del gen, view, want
    rows = kernel_table(SINGLE_PATH, samples, launches)
    del samples  # so the sharded phase's peak memory is its own

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
    gen = sh.pop("gen")
    want = q3_oracle(gen._customer, gen._orders_store, gen._lineitem_store)
    view: dict = {}
    for state in sh.pop("states"):
        part = read_view(state)
        if set(part) & set(view):
            raise AssertionError("a group is owned by more than one worker")
        view.update(part)
    if view != want:
        raise AssertionError(f"sharded view differs from q3_oracle: {len(view)} vs "
                             f"{len(want)} groups")
    phase(f"sharded view (union of {len(sh['mesh'])} workers) equals q3_oracle: "
          f"{len(view)} groups")
    del gen, view, want

    # the single path's kernels also at their largest calls of the sharded
    # phase (per-worker shapes); the route kernels run only there
    for row in rows:
        shape, _fns, err = check_largest(row["name"], sh_samples)
        row["sharded_shape"], row["sharded_max_abs_err"] = list(shape), err
        phase(f"{row['name']} equals its plain version at the sharded phase's {shape}")
    rows += kernel_table(("route_dest", "bucket_rank"), sh_samples, sh_launches)
    for row in rows:
        row["launches_sharded"] = sh_launches[row["name"]]
    del sh_samples

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
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
