"""Admission control + overload accounting for the serving path.

Counterpart of materialize_tpu/adapter/overload.py: host Python, kept as a copy in the
port (which never imports the JAX package) and held to the same
behaviour by the port's tests.

The analogue of the reference's coordinator message queue bounds and
balancerd connection limits: the coordinator command loop is single-threaded
(every frontend serializes through one lock), so under a client swarm the
waiting line IS the work queue. An `AdmissionGate` bounds that line and
sheds the overflow with a clean, retryable 53300 instead of letting latency
(and per-thread stacks) grow without bound; `OverloadStats` makes every
degradation decision countable so the saturation chaos tier can assert
"queues stayed bounded" rather than assume it.

This module also holds the ingest backpressure of the reference's
storage/backpressure.py (`IngestBudget`, `batch_bytes_estimate`) and the
memory watchdog of its utils/memory_limiter.py (`MemoryLimiter`).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager

from ..errors import AdmissionShed
from ..obs import get_logger



class OverloadStats:
    """Thread-safe named counters for every shed/cancel/yield decision.

    Queryable as the `mz_overload_counters` introspection relation, so
    degradation is observable from SQL — not just from stderr.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def bump(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + by

    def record_max(self, name: str, value: int) -> None:
        with self._lock:
            if value > self._counts.get(name, 0):
                self._counts[name] = value

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


def looks_like_peek(sql: str) -> bool:
    """Pre-parse read classification for the peek admission gate.

    Heuristic by design (the real parse happens under the lock): leading
    `--` line comments are skipped so a commented read can't slip past the
    peek gate; a read-headed multi-statement script is gated as a peek."""
    head = sql.lstrip()
    while head.startswith("--"):
        nl = head.find("\n")
        if nl < 0:
            return False
        head = head[nl + 1 :].lstrip()
    return head.lower().startswith(
        ("select", "show", "explain", "copy", "values", "with", "(")
    )


@contextmanager
def admitted(coord, sql: str, lock):
    """THE admission discipline, shared by every frontend: the statement
    gate, the (tighter) peek gate for peek-shaped scripts, then the
    coordinator lock. Gates bound the waiting line BEFORE the lock — a shed
    statement raises AdmissionShed (53300) without ever blocking. One
    implementation so the frontends cannot drift."""
    from contextlib import ExitStack

    with ExitStack() as stack:
        stack.enter_context(coord.admission.admit())
        if looks_like_peek(sql):
            stack.enter_context(coord.peek_gate.admit())
        stack.enter_context(lock)
        yield


class AdmissionGate:
    """Bounded waiting line in front of the coordinator lock.

    `admit()` counts the caller into the line for the full duration of its
    statement (waiting + executing). When the line is already at the
    configured depth, the caller is shed immediately with AdmissionShed
    (53300) — it never blocks, never grows the queue. depth_fn is consulted
    per admission so `ALTER SYSTEM SET coord_queue_depth = …` takes effect
    live; 0 disables the bound.
    """

    def __init__(self, name: str, depth_fn, stats: OverloadStats | None = None):
        self.name = name
        self._depth_fn = depth_fn
        self._lock = threading.Lock()
        self._inline = 0
        self.stats = stats or OverloadStats()

    @property
    def depth(self) -> int:
        """Current line length (waiting + executing statements)."""
        with self._lock:
            return self._inline

    @contextmanager
    def admit(self):
        limit = int(self._depth_fn())
        with self._lock:
            if limit > 0 and self._inline >= limit:
                self.stats.bump(f"{self.name}_sheds")
                raise AdmissionShed(
                    f"too many queued requests: {self.name} admission queue is "
                    f"full ({self._inline}/{limit}); retry later"
                )
            self._inline += 1
            self.stats.record_max(f"{self.name}_queue_peak", self._inline)
        try:
            yield
        finally:
            with self._lock:
                self._inline -= 1


# -- ingest backpressure ----------------------------------------------------
class IngestBudget:
    """Per-tick byte allowance shared by every source of one coordinator.

    `grant_rows(row_bytes, want)` → how many rows the source may emit now
    (never 0 for want ≥ 1: the liveness floor grants one record past a
    spent budget); the grant is charged immediately.
    `charge(nbytes)` accounts work whose size is only known after the fact
    (file reads). `yields` counts every time a source got less than it
    wanted — the backpressure signal surfaced in mz_overload_counters.
    """

    def __init__(self, total_bytes: int):
        self.total = int(total_bytes)
        self.spent = 0
        self.yields = 0

    @property
    def enabled(self) -> bool:
        return self.total > 0

    @property
    def remaining(self) -> int | None:
        """Bytes left, or None when budgeting is off."""
        if not self.enabled:
            return None
        return max(0, self.total - self.spent)

    def grant_rows(self, row_bytes: int, want: int) -> int:
        if not self.enabled or want <= 0:
            return want
        rem = self.total - self.spent
        # min-one-record progress doubles as the LIVENESS FLOOR: even a
        # fully spent budget grants one row (charged past the line), so a
        # hungry early source can only slow later ones down, never starve
        # them tick after tick — per-tick growth stays bounded by
        # budget + one record per source
        n = min(want, max(1, rem // max(1, row_bytes)))
        if n < want:
            self.yields += 1
        self.spent += n * max(1, row_bytes)
        return n

    def charge(self, nbytes: int) -> None:
        self.spent += max(0, int(nbytes))

    def note_yield(self) -> None:
        """A source observed more pending data than its grant covered."""
        self.yields += 1


def batch_bytes_estimate(batch) -> int:
    """Rough device/host footprint of an UpdateBatch delta (live rows ×
    (value cols + time + diff) × 8 B)."""
    from ..ops.reduce import host_int

    try:
        n = host_int(batch.count())
    except Exception:
        return 0
    return n * (len(batch.vals) + 2) * 8


# -- the memory watchdog ----------------------------------------------------


_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
_log = get_logger("memory")


def rss_mb() -> float:
    try:
        with open("/proc/self/statm") as f:
            parts = f.read().split()
        return int(parts[1]) * _PAGE / (1024 * 1024)
    except (OSError, IndexError, ValueError):
        return 0.0


class MemoryLimiter:
    def __init__(self, limit_mb: int = 0, soft_frac: float = 0.9):
        self.limit_mb = limit_mb
        self.soft_frac = soft_frac
        self._warned = False

    def check(self) -> None:
        """Raise past the hard limit; warn once past the soft limit."""
        if self.limit_mb <= 0:
            return
        rss = rss_mb()
        if rss > self.limit_mb:
            raise MemoryError(
                f"memory limiter: RSS {rss:.0f} MiB exceeds limit {self.limit_mb} MiB"
            )
        if rss > self.limit_mb * self.soft_frac and not self._warned:
            self._warned = True
            _log.warn(
                "RSS above soft limit",
                rss_mb=round(rss),
                soft_frac=self.soft_frac,
                limit_mb=self.limit_mb,
            )
