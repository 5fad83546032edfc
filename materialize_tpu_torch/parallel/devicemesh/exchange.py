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
`WorkerComm`, whose `all_to_all` meets the other workers at a barrier and
copies between their buckets. A worker that raises aborts the barrier, so
the others stop at their next exchange and `mesh_run` re-raises the first
worker's exception.
"""

from __future__ import annotations

import threading
from contextlib import nullcontext

import torch

from ...ops.consolidate import scatter_to
from ...ops.kernels import batch_permute, bucket_rank, route_dest
from ...ops.search import sort_perm
from ...repr.batch import PAD_TIME, UpdateBatch
from ...repr.hashing import PAD_HASH

# Seconds a worker waits at an exchange for the others before the mesh call
# fails; a worker that raises ends the wait at once instead.
BARRIER_TIMEOUT_S = 300.0

_RETRIES = {"overflow_retries": 0}
_RETRIES_LOCK = threading.Lock()


def note_overflow_retry() -> None:
    """Record one overflow -> regrow -> rerun trip of the retry ladder."""
    with _RETRIES_LOCK:
        _RETRIES["overflow_retries"] += 1


def overflow_retries() -> int:
    return _RETRIES["overflow_retries"]


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
    """What the workers of one `mesh_run` share."""

    def __init__(self, mesh: tuple):
        n = len(mesh)
        self.mesh = mesh
        self.barrier = threading.Barrier(n, timeout=BARRIER_TIMEOUT_S)
        self.sent: list = [None] * n  # per worker: its list of [n, ...] tensors
        self.ready: list = [None] * n  # per worker: CUDA event after its writes
        self.done: list = [None] * n  # per worker: CUDA event after its reads


class WorkerComm:
    """One worker's end of the mesh: its rank, the mesh size, all_to_all."""

    def __init__(self, group: _Group, rank: int):
        self._group = group
        self.rank = rank
        self.size = len(group.mesh)
        self.device = group.mesh[rank]

    def all_to_all(self, xs: list) -> list:
        """For each tensor of `xs` (shape [size, ...]), return the stack over
        source workers s of what s sent at index `rank`, on this worker's
        device, in source order.

        On CUDA each worker records an event after its writes and after its
        reads; the others' streams wait on them before reading the buckets,
        and before the buckets' memory can be reused."""
        g, r = self._group, self.rank
        cuda = self.device.type == "cuda"
        if any(int(x.shape[0]) != self.size for x in xs):
            raise ValueError("all_to_all: every tensor needs one row per worker")
        g.sent[r] = xs
        if cuda:
            g.ready[r] = torch.cuda.Event()
            g.ready[r].record(torch.cuda.current_stream(self.device))
        g.barrier.wait()
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            for ev in g.ready:
                stream.wait_event(ev)
        out = [
            torch.stack([g.sent[s][j][r].to(self.device) for s in range(self.size)])
            for j in range(len(xs))
        ]
        if cuda:
            g.done[r] = torch.cuda.Event()
            g.done[r].record(stream)
        g.barrier.wait()
        if cuda:
            for ev in g.done:
                stream.wait_event(ev)
        g.sent[r] = None
        return out


def mesh_run(fn, mesh: tuple, *per_worker_args) -> list:
    """Run ``fn(comm, *args_w)`` on every worker w of `mesh`, each in its own
    thread with its device current; return the per-worker results.

    Each of `per_worker_args` holds one value per worker. If a worker
    raises, the barrier is aborted, every worker ends, and the first
    worker's exception (in rank order) is raised here.
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
            with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                results[rank] = fn(WorkerComm(group, rank), *(a[rank] for a in per_worker_args))
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller below
            errors[rank] = e
            group.barrier.abort()

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
            f"a mesh worker waited more than {BARRIER_TIMEOUT_S}s at an exchange"
        ) from failed[0]
    return results
