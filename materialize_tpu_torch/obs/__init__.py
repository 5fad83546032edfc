"""Observability: leveled logs, the metrics registry and cross-process
trace spans (plus `profiler`, a submodule).

Counterpart of the reference's obs/log.py, obs/metrics.py and
obs/spans.py, one module here: host Python, kept as a copy in the port
(which never imports the JAX package).

-- log: Structured, per-subsystem leveled logging.

The `RUST_LOG` analogue: ``MZT_LOG`` configures a default level and/or
per-subsystem overrides, e.g.

    MZT_LOG=debug                     # everything at debug
    MZT_LOG=mesh=debug,persist=info   # targeted, default stays warn
    MZT_LOG=info,mesh=debug           # default info, mesh at debug

Levels (increasing severity): debug < info < warn < error; ``off`` silences a
subsystem entirely. The default level is ``warn`` so pre-existing warning
paths keep printing while info/debug stay quiet unless asked for.

Every line carries the subsystem and any process-wide context installed with
:func:`set_context` (clusterd sets ``shard``/``epoch`` so chaos and
crash-matrix failures are attributable to a process), plus per-call fields::

    log = get_logger("mesh")
    log.debug("exchange stalled", channel=ch, tick=t, worker=w)
    # -> 12:00:01.234 DEBUG mesh[shard=1 epoch=3] exchange stalled channel=7 tick=9 worker=0

The level check is an int compare on a bound attribute — a disabled call
costs one comparison, no string work.

-- metrics: One metrics registry, Prometheus exposition done right.

The `mz-ore metrics` analogue: every subsystem registers Counter / Gauge /
Histogram families against the process-global :data:`REGISTRY` and bumps them
at the call site; ``/metrics`` renders the registry instead of hand-rolling
text. The renderer emits ``# HELP`` / ``# TYPE`` for every family (including
empty ones, so tooling can assert a family exists before traffic) and escapes
label values per the exposition format (backslash, double-quote, newline).

Scrape-time values that live on engine objects (catalog counts, overload
counters, …) are passed to :func:`render` as extra :class:`Snapshot` families
— gather the numbers under whatever lock guards them, render *outside* it.

Histograms use power-of-two buckets (the engine's house style for duration
histograms): an observation lands in the smallest power of two >= value, and
rendering emits cumulative ``_bucket{le=...}`` counts plus ``_sum``/``_count``.

Cross-process: :meth:`Registry.snapshot` returns a plain-tuple form of every
family that pickles over CTP, so clusterd-side counters (exchange bytes,
persist ops) surface in the coordinator's exposition with a ``process`` label.

-- spans: Cross-process tracing: spans with trace contexts that ride CTP frames.

The analogue of the reference's tracing stack (mz-tracing +
orchestrator-tracing, doc/developer/tracing.md), upgraded from the original
single-process ring buffer: a *trace* is minted per statement at the frontend
(`Tracer.trace`), its (trace_id, parent span_id) context travels on CTP
command envelopes (cluster/protocol.py `Traced`), remote processes adopt the
context (`Tracer.adopt_scope`), record their own child spans, and ship
completed spans back on the response (`TracedResponse`) where the caller
`absorb`s them into its ring. `mz_trace_spans` then shows one statement's
end-to-end timeline — admission wait, coordinator planning, per-shard
exchange/step, merge — and EXPLAIN TIMELINE renders the tree.

Span ids are pid-prefixed so they stay unique across processes without
coordination; `process` names the recording process (``coord``, ``shard0``,
…). ``log_filter`` still gates stderr emission exactly as before.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field


# -- log ---------------------------------------------------------------------


_LEVELS = {"debug": 10, "info": 20, "warn": 30, "warning": 30, "error": 40, "off": 99}
_DEFAULT = "warn"

_lock = threading.Lock()
_loggers: dict[str, "Logger"] = {}
_default_level = _LEVELS[_DEFAULT]
_overrides: dict[str, int] = {}
_context: dict[str, object] = {}


def parse_spec(spec: str) -> tuple[int, dict[str, int]]:
    """Parse an MZT_LOG spec into (default_level, {subsystem: level}).

    Unknown level names fall back to the default rather than raising — a bad
    env var must never take the engine down.
    """
    default = _LEVELS[_DEFAULT]
    overrides: dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, _, lvl = part.partition("=")
            overrides[name.strip()] = _LEVELS.get(lvl.strip().lower(), default)
        else:
            default = _LEVELS.get(part.lower(), default)
    return default, overrides


def configure(spec: str | None = None) -> None:
    """(Re)configure from an explicit spec or the MZT_LOG env var."""
    global _default_level, _overrides
    if spec is None:
        spec = os.environ.get("MZT_LOG", "")
    default, overrides = parse_spec(spec)
    with _lock:
        _default_level = default
        _overrides = overrides
        for name, lg in _loggers.items():
            lg.level = _overrides.get(name, _default_level)


def set_default_level(level: str) -> None:
    """Raise/lower the default level for subsystems without an explicit
    MZT_LOG override (clusterd runs at info so subprocess logs are useful)."""
    global _default_level
    with _lock:
        _default_level = _LEVELS.get(level, _default_level)
        for name, lg in _loggers.items():
            if name not in _overrides:
                lg.level = _default_level


def set_context(**fields) -> None:
    """Install process-wide context rendered on every line (``shard=``,
    ``epoch=``, …). ``None`` removes a key."""
    with _lock:
        for k, v in fields.items():
            if v is None:
                _context.pop(k, None)
            else:
                _context[k] = v


class Logger:
    __slots__ = ("subsystem", "level")

    def __init__(self, subsystem: str, level: int):
        self.subsystem = subsystem
        self.level = level

    def enabled(self, level: str) -> bool:
        return _LEVELS.get(level, 99) >= self.level

    def _emit(self, lvl_num: int, lvl_name: str, msg: str, fields: dict) -> None:
        if lvl_num < self.level:
            return
        t = time.time()
        stamp = time.strftime("%H:%M:%S", time.localtime(t)) + f".{int(t * 1000) % 1000:03d}"
        ctx = ""
        if _context:
            ctx = "[" + " ".join(f"{k}={v}" for k, v in _context.items()) + "]"
        tail = ""
        if fields:
            tail = " " + " ".join(f"{k}={v}" for k, v in fields.items())
        print(
            f"{stamp} {lvl_name:<5} {self.subsystem}{ctx} {msg}{tail}",
            file=sys.stderr,
            flush=True,
        )

    def debug(self, msg: str, **fields) -> None:
        self._emit(10, "DEBUG", msg, fields)

    def info(self, msg: str, **fields) -> None:
        self._emit(20, "INFO", msg, fields)

    def warn(self, msg: str, **fields) -> None:
        self._emit(30, "WARN", msg, fields)

    warning = warn

    def error(self, msg: str, **fields) -> None:
        self._emit(40, "ERROR", msg, fields)


def get_logger(subsystem: str) -> Logger:
    with _lock:
        lg = _loggers.get(subsystem)
        if lg is None:
            lg = Logger(subsystem, _overrides.get(subsystem, _default_level))
            _loggers[subsystem] = lg
        return lg


configure()


# -- metrics -----------------------------------------------------------------


def escape_label(v: object) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _labels_text(labels) -> str:
    """``{k="v",...}`` for a (key, value) item tuple; '' when unlabeled."""
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{escape_label(v)}"' for k, v in labels) + "}"


def _pow2_bucket(v: float) -> int:
    b = 1
    while b < v:
        b <<= 1
    return b


@dataclass
class Snapshot:
    """A renderable family snapshot: scrape-time values not held in the
    registry. ``samples`` is [(labels_items_tuple, value)]; for kind
    'histogram', value is a ({bucket_le: count}, sum, count) triple."""

    name: str
    kind: str  # counter | gauge | histogram
    help: str
    samples: list = field(default_factory=list)


class Family:
    def __init__(self, name: str, kind: str, help: str, labelnames: tuple):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self._lock = threading.Lock()
        # labels value-tuple -> float, or for histograms -> [buckets, sum, count]
        self._values: dict = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared {sorted(self.labelnames)}"
            )
        return tuple(labels[k] for k in self.labelnames)

    def inc(self, n: float = 1, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0) + n

    def set(self, v: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = v

    def observe(self, v: float, **labels) -> None:
        k = self._key(labels)
        b = _pow2_bucket(v)
        with self._lock:
            st = self._values.get(k)
            if st is None:
                st = self._values[k] = [{}, 0.0, 0]
            st[0][b] = st[0].get(b, 0) + 1
            st[1] += v
            st[2] += 1

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0)

    def _snapshot_samples(self) -> list:
        with self._lock:
            out = []
            for k, v in self._values.items():
                labels = tuple(zip(self.labelnames, k))
                if self.kind == "histogram":
                    out.append((labels, (dict(v[0]), v[1], v[2])))
                else:
                    out.append((labels, v))
            return out


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}

    def _family(self, name: str, kind: str, help: str, labels: tuple) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = Family(name, kind, help, tuple(labels))
            elif fam.kind != kind:
                raise ValueError(f"{name} re-registered as {kind}, was {fam.kind}")
            return fam

    def counter(self, name: str, help: str, labels: tuple = ()) -> Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str, labels: tuple = ()) -> Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str, labels: tuple = ()) -> Family:
        return self._family(name, "histogram", help, labels)

    def snapshot(self) -> tuple:
        """Picklable ((name, kind, help, samples), ...) for CTP shipping."""
        with self._lock:
            fams = list(self._families.values())
        return tuple((f.name, f.kind, f.help, tuple(f._snapshot_samples())) for f in fams)

    def families(self) -> list[Snapshot]:
        with self._lock:
            fams = list(self._families.values())
        return [Snapshot(f.name, f.kind, f.help, f._snapshot_samples()) for f in fams]

    def expose(self, extra=()) -> str:
        """Full exposition text: registered families plus scrape-time extras.

        Callers gather `extra` values under their own locks; this function
        only formats — never call it while holding an engine lock.
        """
        return render(self.families() + list(extra))


def render(families) -> str:
    lines: list[str] = []
    seen: set[str] = set()
    for fam in families:
        name, kind, help_, samples = fam.name, fam.kind, fam.help, fam.samples
        if name not in seen:
            seen.add(name)
            lines.append(f"# HELP {name} {escape_help(help_)}")
            lines.append(f"# TYPE {name} {kind}")
        for labels, v in samples:
            lt = _labels_text(labels)
            if kind == "histogram":
                buckets, total, count = v
                acc = 0
                for le in sorted(buckets):
                    acc += buckets[le]
                    blabels = labels + (("le", le),)
                    lines.append(f"{name}_bucket{_labels_text(blabels)} {acc}")
                inf = labels + (("le", "+Inf"),)
                lines.append(f"{name}_bucket{_labels_text(inf)} {count}")
                lines.append(f"{name}_sum{lt} {total}")
                lines.append(f"{name}_count{lt} {count}")
            else:
                lines.append(f"{name}{lt} {v}")
    return "\n".join(lines) + "\n"


REGISTRY = Registry()


# -- spans -------------------------------------------------------------------


@dataclass
class Span:
    id: int
    parent: int
    name: str
    start_ns: int
    duration_ns: int = -1  # -1 while open
    trace_id: int = 0  # 0 = not part of a statement trace
    process: str = "coord"


def _pid_prefix() -> int:
    # 22 bits of pid above 40 bits of counter: ids collide across processes
    # only after 2^40 spans in one process, and stay positive int64
    return (os.getpid() & 0x3FFFFF) << 40


class Tracer:
    def __init__(self, capacity: int = 2048):
        self.spans: deque[Span] = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.stderr_level: str = "off"  # off | info | debug
        self.process: str = "coord"
        # context adopted from a remote parent: (trace_id, parent_span_id).
        # Process-global on purpose — clusterd worker threads have no
        # thread-local parent and fall back to it, which parents their spans
        # under the command span that fanned the work out.
        self._adopted: tuple | None = None
        # completed spans awaiting shipment on the next command response
        # (only populated when shipping is on, i.e. in remote processes)
        self._pending: deque[Span] = deque(maxlen=4096)
        self._ship = False

    # -- configuration -------------------------------------------------------

    def set_filter(self, level: str) -> None:
        self.stderr_level = level

    def set_process(self, name: str) -> None:
        self.process = name

    def set_shipping(self, on: bool) -> None:
        self._ship = on

    # -- context -------------------------------------------------------------

    def _next_id(self) -> int:
        return _pid_prefix() | (next(self._ids) & ((1 << 40) - 1))

    def current_context(self) -> tuple | None:
        """(trace_id, span_id) to propagate to a remote process, or None.

        Must be captured on the *calling* thread — thread-locals do not cross
        the per-shard request threads in the sharded controller.
        """
        cur = getattr(self._local, "current", None)
        return cur if cur is not None else self._adopted

    @contextmanager
    def adopt_scope(self, ctx: tuple | None):
        """Install a remote (trace_id, span_id) as the process-global parent
        fallback for the duration of a command dispatch."""
        prev = self._adopted
        self._adopted = tuple(ctx) if ctx is not None else None
        try:
            yield
        finally:
            self._adopted = prev

    # -- recording -----------------------------------------------------------

    @contextmanager
    def span(self, name: str, trace_id: int | None = None):
        prev = getattr(self._local, "current", None)
        ctx = prev if prev is not None else self._adopted
        tid = trace_id if trace_id is not None else (ctx[0] if ctx else 0)
        parent = ctx[1] if ctx else 0
        s = Span(self._next_id(), parent, name, time.time_ns(), -1, tid, self.process)
        self._local.current = (tid, s.id)
        try:
            yield s
        finally:
            s.duration_ns = time.time_ns() - s.start_ns
            self._local.current = prev
            self.spans.append(s)
            if self._ship and tid:
                self._pending.append(s)
            if self.stderr_level in ("info", "debug"):
                print(
                    f"[trace] {name} {s.duration_ns/1e6:.2f}ms (span {s.id}<-{s.parent})",
                    file=sys.stderr,
                )

    @contextmanager
    def trace(self, name: str):
        """Mint a fresh trace rooted at a new span (per-statement entry
        point); the root ignores any enclosing context."""
        tid = self._next_id()
        prev = getattr(self._local, "current", None)
        s = Span(self._next_id(), 0, name, time.time_ns(), -1, tid, self.process)
        self._local.current = (tid, s.id)
        try:
            yield s
        finally:
            s.duration_ns = time.time_ns() - s.start_ns
            self._local.current = prev
            self.spans.append(s)
            if self._ship:
                self._pending.append(s)

    # -- shipping ------------------------------------------------------------

    def drain_pending(self) -> tuple:
        out = []
        while True:
            try:
                out.append(self._pending.popleft())
            except IndexError:
                return tuple(out)

    def absorb(self, spans) -> None:
        """Append spans shipped from a remote process into the local ring."""
        for s in spans:
            self.spans.append(s)

    # -- queries -------------------------------------------------------------

    def recent(self, n: int = 256) -> list[Span]:
        return list(self.spans)[-n:]

    def spans_for_trace(self, trace_id: int) -> list[Span]:
        return [s for s in self.spans if s.trace_id == trace_id]


TRACER = Tracer()
span = TRACER.span


def render_timeline(spans: list[Span]) -> list[str]:
    """Indented tree of one trace's spans, in start order, durations in ms.

    Spans whose parent is missing from the set (e.g. evicted from a ring)
    render as roots rather than vanishing.
    """
    spans = sorted(spans, key=lambda s: (s.start_ns, s.id))
    ids = {s.id for s in spans}
    children: dict[int, list[Span]] = {}
    roots: list[Span] = []
    for s in spans:
        if s.parent in ids:
            children.setdefault(s.parent, []).append(s)
        else:
            roots.append(s)
    lines: list[str] = []

    def walk(s: Span, depth: int) -> None:
        dur = f"{s.duration_ns/1e6:.3f}ms" if s.duration_ns >= 0 else "open"
        lines.append(f"{'  ' * depth}{s.name} [{s.process}] {dur}")
        for c in children.get(s.id, []):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return lines
