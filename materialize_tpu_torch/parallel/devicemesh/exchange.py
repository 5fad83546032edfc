"""The exchange between the workers of a mesh: hash-routed all-to-all.

Counterpart of materialize_tpu/parallel/devicemesh/exchange.py. Each worker
packs its live rows into `n_dest` buckets of fixed capacity by `hash %
n_dest` (the `route_dest` kernel), ranks each row within its destination
(the `bucket_rank` kernel, after one stable sort), and sends bucket `d` to
worker `d`, which flattens what it receives in source order: exactly
`lax.all_to_all(x, axis, 0, 0)` followed by a reshape. More live rows for
one destination than a bucket holds raise the overflow flag (a bool tensor);
the caller reruns with larger buckets and notes the retry.

Where the JAX package stamps one `shard_map` program over its devices
(`mesh_jit`), the port runs `n` workers as threads of one process
(`mesh_run`): each enters its own device and calls the tick function with a
`WorkerComm`. The workers take turns, one running at a time from one
exchange to the next: `all_to_all` deposits the worker's buckets and passes
the turn on, and reads the others' once the turn has come round. A worker
that raises breaks the turn, so the others stop at their next exchange and
`mesh_run` re-raises the first worker's exception. `mesh_tick` is where a
renderer builds its tick over a mesh, the counterpart of `mesh_jit`: it
counts the builds and the mesh's width in the `mzt_device_exchange_*`
metrics, once per build, not per tick.
"""

from __future__ import annotations

import threading
from contextlib import nullcontext
from functools import partial

import torch

from ...obs import REGISTRY
from ...ops.consolidate import scatter_to
from ...ops.kernels import batch_permute, bucket_rank, route_dest
from ...ops.search import sort_perm
from ...repr.batch import PAD_TIME, UpdateBatch
from ...repr.hashing import PAD_HASH
from ..mesh import WORKERS

# Seconds a worker waits for its turn before the mesh call fails; a worker
# that raises ends the wait at once instead.
TURN_TIMEOUT_S = 300.0

_PROGRAMS = REGISTRY.counter(
    "mzt_device_exchange_programs_total",
    "mesh ticks built by mesh_tick (one bump per build, not per tick)",
    ("axis",),
)
_MESH_DEVICES = REGISTRY.gauge(
    "mzt_device_exchange_mesh_devices",
    "workers on the mesh axis under the most recently built mesh tick",
    ("axis",),
)
_RETRIES = REGISTRY.counter(
    "mzt_device_exchange_retries_total",
    "whole-tick reruns after a capacity overflow on a worker mesh (the "
    "lossless capacity-doubling retry ladder)",
)


def note_overflow_retry() -> None:
    """Record one overflow -> regrow -> rerun trip of the retry ladder."""
    _RETRIES.inc()


def overflow_retries() -> int:
    return int(_RETRIES.value())


def route_to_buckets(batch: UpdateBatch, n_dest: int, bucket_cap: int):
    """Pack rows into [n_dest, bucket_cap] buckets by hash % n_dest.

    Returns (buckets: an UpdateBatch of [n_dest, bucket_cap] tensors, overflow
    flag). Dead rows (padding, diff 0) are not routed.
    """
    dest = route_dest(batch.hashes, n_dest)
    key = torch.where(batch.live, dest, n_dest)  # dead rows to a discard bucket
    order = sort_perm((key,))
    key_s = key[order]
    rank = bucket_rank(key_s)
    routed = key_s < n_dest
    overflow = (routed & (rank >= bucket_cap)).any()
    ok = routed & (rank < bucket_cap)
    # rows that are not routed go to the one slot past the end, which is cut
    # off: the (dest, rank) slots of routed rows are unique
    size = n_dest * bucket_cap
    slot = torch.where(ok, key_s.to(torch.int64) * bucket_cap + rank, size)
    rows = batch_permute(batch, order)

    def scatter(col, fill):
        return scatter_to(col, slot, size, fill).reshape(n_dest, bucket_cap)

    buckets = UpdateBatch(
        hashes=scatter(rows.hashes, PAD_HASH),
        keys=tuple(scatter(k, 0) for k in rows.keys),
        vals=tuple(scatter(v, 0) for v in rows.vals),
        times=scatter(rows.times, PAD_TIME),
        diffs=scatter(rows.diffs, 0),
    )
    return buckets, overflow


def _leaves(b: UpdateBatch) -> list:
    return [b.hashes, *b.keys, *b.vals, b.times, b.diffs]


def _from_leaves(like: UpdateBatch, leaves: list) -> UpdateBatch:
    nk, nv = len(like.keys), len(like.vals)
    return UpdateBatch(leaves[0], tuple(leaves[1 : 1 + nk]),
                       tuple(leaves[1 + nk : 1 + nk + nv]), leaves[-2], leaves[-1])


def exchange(batch: UpdateBatch, comm: "WorkerComm", n_dest: int, bucket_cap: int):
    """All-to-all shuffle by key hash (call from a worker of `mesh_run`).

    Every live row lands on the worker owning `hash % n_dest`. Returns
    (received batch of capacity n_dest * bucket_cap, overflow flag of THIS
    worker's send side).
    """
    if n_dest != comm.size:
        raise ValueError(f"exchange: n_dest {n_dest} is not the mesh's {comm.size} workers")
    buckets, overflow = route_to_buckets(batch, n_dest, bucket_cap)
    recv = comm.all_to_all(_leaves(buckets))
    return _from_leaves(buckets, [x.reshape(-1) for x in recv]), overflow


class _Group:
    """What the workers of one `mesh_run` share: the turn, and per exchange
    (by its parity: a worker deposits exchange k + 2 only after every
    worker has read exchange k) each worker's sent tensors and CUDA events.
    """

    def __init__(self, mesh: tuple):
        n = len(mesh)
        self.mesh = mesh
        self.cond = threading.Condition()
        self.turn = 0  # the rank that runs
        self.broken = False
        self.sent: list = [[None] * n, [None] * n]  # its list of [n, ...] tensors
        self.ready: list = [[None] * n, [None] * n]  # CUDA event after its writes
        self.done: list = [[None] * n, [None] * n]  # CUDA event after its reads

    def wait_turn(self, rank: int) -> None:
        with self.cond:
            ok = self.cond.wait_for(lambda: self.broken or self.turn == rank,
                                    timeout=TURN_TIMEOUT_S)
            if self.broken or not ok:
                self.broken = True
                self.cond.notify_all()
                raise threading.BrokenBarrierError

    def pass_turn(self, rank: int) -> None:
        with self.cond:
            self.turn = (rank + 1) % len(self.mesh)
            self.cond.notify_all()

    def abort(self) -> None:
        with self.cond:
            self.broken = True
            self.cond.notify_all()


class WorkerComm:
    """One worker's end of the mesh: its rank, the mesh size, all_to_all."""

    def __init__(self, group: _Group, rank: int):
        self._group = group
        self.rank = rank
        self.size = len(group.mesh)
        self.device = group.mesh[rank]
        self._exchanges = 0

    def all_to_all(self, xs: list) -> list:
        """For each tensor of `xs` (shape [size, ...]), return the stack over
        source workers s of what s sent at index `rank`, on this worker's
        device, in source order.

        The worker deposits `xs` and passes the turn on; when the turn comes
        back, every worker has deposited, and it reads. On CUDA each worker
        records an event after its writes and after its reads; a reader's
        stream waits on the writers' events, and a writer's stream waits on
        the readers' events of the exchange whose tensors it drops."""
        g, r = self._group, self.rank
        k = self._exchanges % 2
        self._exchanges += 1
        cuda = self.device.type == "cuda"
        if any(int(x.shape[0]) != self.size for x in xs):
            raise ValueError("all_to_all: every tensor needs one row per worker")
        stream = torch.cuda.current_stream(self.device) if cuda else None
        if cuda and g.done[k][r] is not None:
            # the tensors dropped below were read two exchanges ago
            for ev in g.done[k]:
                stream.wait_event(ev)
        g.sent[k][r] = xs
        if cuda:
            g.ready[k][r] = torch.cuda.Event()
            g.ready[k][r].record(stream)
        g.pass_turn(r)
        g.wait_turn(r)
        if cuda:
            for ev in g.ready[k]:
                stream.wait_event(ev)
        out = [
            torch.stack([g.sent[k][s][j][r].to(self.device) for s in range(self.size)])
            for j in range(len(xs))
        ]
        if cuda:
            g.done[k][r] = torch.cuda.Event()
            g.done[k][r].record(stream)
        return out


def mesh_run(fn, mesh: tuple, *per_worker_args) -> list:
    """Run ``fn(comm, *args_w)`` on every worker w of `mesh`, each in its own
    thread with its device current; return the per-worker results.

    The workers take turns: one runs at a time, from one exchange to the
    next, and passes the turn on (rank order) when it has deposited what it
    sends, so the interpreter lock never passes between workers inside an
    operator. Each of `per_worker_args` holds one value per worker. If a
    worker raises, the others stop waiting for their turn, every worker
    ends, and the first worker's exception (in rank order) is raised here.
    """
    n = len(mesh)
    for a in per_worker_args:
        if len(a) != n:
            raise ValueError(f"mesh_run: want one argument per worker ({n}), got {len(a)}")
    group = _Group(tuple(mesh))
    results: list = [None] * n
    errors: list = [None] * n

    def body(rank: int) -> None:
        dev = group.mesh[rank]
        try:
            group.wait_turn(rank)
            with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                results[rank] = fn(WorkerComm(group, rank), *(a[rank] for a in per_worker_args))
            group.pass_turn(rank)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller below
            errors[rank] = e
            group.abort()

    threads = [threading.Thread(target=body, args=(r,), name=f"mesh-worker-{r}")
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    first = next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)), None)
    if first is not None:
        raise first
    if failed:
        raise TimeoutError(
            f"a mesh worker waited more than {TURN_TIMEOUT_S}s for its turn"
        ) from failed[0]
    # the last exchanges' tensors are dropped with the group: each device's
    # stream first waits until every reader has copied them
    for dev in {d for d in group.mesh if d.type == "cuda"}:
        stream = torch.cuda.current_stream(dev)
        for ev in (e for evs in group.done for e in evs if e is not None):
            stream.wait_event(ev)
    return results


def mesh_tick(fn, mesh: tuple, axis_name: str = WORKERS):
    """The one place a tick function meets a mesh (the JAX package's
    `mesh_jit`): returns ``run(*per_worker_args)``, which is `mesh_run(fn,
    mesh, ...)`, and bumps the build count and sets the mesh width of the
    `mzt_device_exchange_*` metrics."""
    axis = str(axis_name)
    _PROGRAMS.inc(axis=axis)
    _MESH_DEVICES.set(len(mesh), axis=axis)
    return partial(mesh_run, fn, tuple(mesh))
