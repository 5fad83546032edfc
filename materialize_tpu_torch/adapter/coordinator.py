"""Coordinator: the single-threaded command loop executing SQL, in memory.

Counterpart of materialize_tpu/adapter/coordinator.py without durability.
DDL transacts against the catalog, INSERTs group-commit at oracle write
timestamps, SELECTs choose between the index fast path and a one-shot
dataflow, and materialized views install continuously maintained
dataflows (rendered by `dataflow.runtime.render_dataflow` with the shared
arrangements of `arrangement/trace_manager.py`) whose outputs feed storage
collections. Every collection, arrangement and dataflow lives on the
coordinator's `device` ("cuda" unless the caller asks for "cpu"). With
`mesh` (a tuple of worker devices, parallel/mesh.py), fused dataflows run
sharded over its workers, as the `exchange_backend` setting decides.

Not ported yet, each raising NotImplementedError that names its module:
durability (`data_dir`, `blob`, `consensus`, `preflight`, `checkpoint`,
`catch_up`, `promote`: persist/), SUBSCRIBE and CREATE SINK (egress/),
CREATE SOURCE ... FROM FILE (storage/file_source.py), LOAD GENERATOR KEY
VALUE (storage/upsert.py), compute replicas (cluster/, orchestrator/),
the mz_* relations (adapter/introspection.py), and the JAX-only settings
(`kernel_backend` other than its default, `enable_jax_profiler`,
`jax_profiler_dir`).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from time import monotonic as _monotonic

import numpy as np

from ..arrangement.spine import Arrangement
from ..dataflow import Dataflow
from ..dataflow import plan as lir
from ..dataflow.runtime import torch_dtypes
from ..errors import QueryCanceled
from ..expr import relation as mir
from ..obs import REGISTRY, TRACER, get_logger
from ..ops.consolidate import advance_times, consolidate
from ..ops.reduce import host_int
from ..repr.batch import UpdateBatch
from ..repr.types import ColType, ColumnDesc, RelationDesc
from ..sql import ast
from ..sql.lower import Lowerer, lower_to_dataflow
from ..sql.parser import parse_statement, parse_statements
from ..sql.plan import PlanError, Planner, PlannedQuery, PType
from ..storage.generator import AuctionGenerator, CounterGenerator, TpchGenerator
from ..transform import optimize
from .catalog import Catalog, CatalogItem, coltype_of

_log = get_logger("coord")

# Per-dataflow write-tick duration, a /metrics histogram family.
_TICK_NS = REGISTRY.histogram(
    "mzt_dataflow_tick_duration_ns",
    "duration of one dataflow step at one write timestamp",
    labels=("dataflow",),
)


# the values the reference accepts for its kernel registry's setting; the
# port runs only the first
_KERNEL_MODES = ("auto", "xla", "pallas")


class TimestampOracle:
    """Linearizable read/write timestamp allocation: the single-node,
    in-memory oracle of the reference's adapter/timestamp_oracle.py. Writes
    get strictly increasing timestamps; a read sees every write before it."""

    def __init__(self, start: int = 0):
        self._ts = start

    def write_ts(self) -> int:
        """Allocate a fresh write timestamp (strictly monotonic)."""
        self._ts += 1
        return self._ts

    def read_ts(self) -> int:
        """Latest timestamp whose writes are complete."""
        return self._ts

    def apply_write(self, ts: int) -> None:
        self._ts = max(self._ts, ts)


def _not_ported(what: str, module: str) -> NotImplementedError:
    return NotImplementedError(f"{what} needs {module}, which is not ported yet")


@dataclass
class ExecResult:
    kind: str  # rows | status
    rows: list = field(default_factory=list)
    columns: tuple = ()
    status: str = "ok"


class StorageCollection:
    """In-memory collection of update batches on the coordinator's device:
    the definite record of a table, source or materialized view, readable
    as a snapshot at any time <= upper."""

    def __init__(self, dtypes: tuple, device="cuda"):
        self.dtypes = tuple(dtypes)
        self.device = device
        self.arr = Arrangement(key_cols=(), device=device)
        self.upper = 0

    def append(self, batch: UpdateBatch, tick: int) -> None:
        self.arr.insert(batch)
        self.upper = max(self.upper, tick + 1)

    def snapshot(self, as_of: int) -> UpdateBatch:
        """Consolidated contents as of `as_of` (times advanced to as_of)."""
        if not self.arr.batches:
            return UpdateBatch.empty(8, (), torch_dtypes(self.dtypes), device=self.device)
        merged = self.arr.merged()
        return consolidate(advance_times(merged, as_of))


class Coordinator:
    """The in-memory coordinator. `device` holds every collection and
    dataflow; the durable and distributed arguments of the reference raise
    NotImplementedError naming the module that would serve them."""

    def __init__(
        self, data_dir: str | None = None, blob=None, consensus=None,
        preflight: bool = False, mesh=None, device="cuda",
    ) -> None:
        if data_dir is not None or blob is not None or consensus is not None or preflight:
            raise _not_ported("a durable Coordinator (data_dir, blob, consensus, preflight)",
                              "persist/")
        # with `mesh`, fused dataflows run sharded over its workers (per
        # exchange_backend, read at each render)
        self.mesh = mesh
        self.device = device
        self.catalog = Catalog()
        self.oracle = TimestampOracle()
        self.storage: dict[str, StorageCollection] = {}
        self.generators: list = []  # (generator, {table -> gid})
        # per-source ingestion statistics: cumulative bytes/records and the
        # last-update wall clock
        self.source_stats: dict[str, dict] = {}
        # installed continuous dataflows in dependency order: (mv_gid, Dataflow, src_gids)
        self.dataflows: list = []
        self.planner = Planner(self.catalog)
        from .dyncfg import default_configs
        from .overload import AdmissionGate, OverloadStats

        self.configs = default_configs()
        # overload protection: every shed/cancel/yield decision is counted;
        # the gates bound the waiting line in front of the single-threaded
        # command loop (adapter/overload.py)
        self.overload = OverloadStats()
        self.admission = AdmissionGate(
            "statement", lambda: self.configs.get("coord_queue_depth"), self.overload
        )
        self.peek_gate = AdmissionGate(
            "peek", lambda: self.configs.get("peek_queue_depth"), self.overload
        )
        # cross-dataflow arrangement sharing (arrangement/trace_manager.py):
        # dataflows reading the same collection share one arrangement per
        # (collection, key) with reader-held compaction; the dyncfg
        # enable_arrangement_sharing force-disables for bisection
        from ..arrangement.trace_manager import TraceManager

        self.trace_manager = TraceManager()

    # -- public API ----------------------------------------------------------
    def new_session(self):
        from .dyncfg import SessionConfigs

        return SessionConfigs(self.configs)

    def execute(self, sql: str, session=None, params=None) -> ExecResult:
        stmt = parse_statement(sql)
        return self.execute_stmt(stmt, session, params=params)

    def execute_script(self, sql: str, session=None, params=None) -> list[ExecResult]:
        return [
            self.execute_stmt(s, session, params=params)
            for s in parse_statements(sql)
        ]

    def execute_stmt(self, stmt, session=None, params=None) -> ExecResult:
        self._session = session  # per-statement; coordinator is single-threaded
        self.planner.set_params(params)
        # NOTE: session.cancelled is deliberately NOT cleared here. A cancel
        # targets the in-flight QUERY MESSAGE, which may be a multi-statement
        # script — clearing per statement would drop a cancel at the next
        # statement boundary. The protocol layer (pgwire) clears the event
        # once per incoming query message instead.
        timeout_ms = int(self._cfg().get("statement_timeout"))
        # The timer starts at query RECEIPT when the protocol layer stamped
        # one (pg semantics): time spent waiting in the admission queue and
        # on the coordinator lock counts against the budget, so a statement
        # that queued past its deadline cancels at the entry checkpoint
        # instead of running arbitrarily late. Consumed once — later
        # statements of the same script start their own windows.
        t0 = _monotonic()
        if session is not None:
            arrival = getattr(session, "arrival", None)
            if arrival is not None:
                t0 = arrival
                session.arrival = None
        self._deadline = t0 + timeout_ms / 1000.0 if timeout_ms > 0 else None
        try:
            # a top-level statement mints a fresh TRACE (its context rides
            # CTP to clusterd and remote spans ship back — obs); a
            # nested execute (EXPLAIN TIMELINE's inner run) records a child
            # span in the enclosing trace instead
            name = f"execute:{type(stmt).__name__}"
            cm = (
                TRACER.span(name)
                if TRACER.current_context() is not None
                else TRACER.trace(name)
            )
            with cm as s:
                self.last_trace_id = s.trace_id
                return self._execute_stmt_inner(stmt)
        except Exception as e:
            from ..errors import ResultSizeExceeded

            if isinstance(e, ResultSizeExceeded):
                self.overload.bump("result_size_rejections")
            raise
        finally:
            self._deadline = None
            self.planner.set_params(None)

    def check_cancellation(self) -> None:
        """Cooperative checkpoint (57014): raises QueryCanceled once the
        statement's deadline passed or its session was canceled. Installed as
        `Dataflow.cancel_check` on ephemeral peek dataflows and called at
        coordinator read-path boundaries; NEVER consulted past a durable
        commit point, so a timeout can't tear a write."""
        s = getattr(self, "_session", None)
        if (
            s is not None
            and getattr(s, "cancelled", None) is not None
            and s.cancelled.is_set()
        ):
            self.overload.bump("cancels_honored")
            raise QueryCanceled("canceling statement due to user request")
        dl = getattr(self, "_deadline", None)
        if dl is not None and _monotonic() >= dl:
            self.overload.bump("statement_timeouts")
            raise QueryCanceled("canceling statement due to statement timeout")

    def _cfg(self):
        """Effective configs: session overlay when a session is active."""
        return self._session if getattr(self, "_session", None) is not None else self.configs

    def _execute_stmt_inner(self, stmt) -> ExecResult:
        # entry checkpoint: a statement admitted after its deadline (it sat
        # in the admission queue too long) cancels BEFORE doing any work —
        # nothing durable has happened yet for any statement kind
        self.check_cancellation()
        if isinstance(stmt, ast.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, ast.CreateSource):
            return self._create_source(stmt)
        if isinstance(stmt, ast.CreateFileSource):
            raise _not_ported("CREATE SOURCE ... FROM FILE", "storage/file_source.py")
        if isinstance(stmt, ast.CreateView):
            return self._create_view(stmt)
        if isinstance(stmt, ast.CreateMaterializedView):
            return self._create_materialized_view(stmt)
        if isinstance(stmt, ast.CreateIndex):
            return self._create_index(stmt)
        if isinstance(stmt, ast.Insert):
            return self._insert(stmt)
        if isinstance(stmt, ast.Delete):
            return self._delete(stmt)
        if isinstance(stmt, ast.SelectStatement):
            return self._select(stmt.query)
        if isinstance(stmt, ast.Explain):
            return self._explain(stmt)
        if isinstance(stmt, ast.Show):
            return self._show(stmt)
        if isinstance(stmt, ast.DropObject):
            return self._drop(stmt)
        if isinstance(stmt, ast.Subscribe):
            raise _not_ported("SUBSCRIBE", "egress/")
        if isinstance(stmt, ast.CreateSink):
            raise _not_ported("CREATE SINK", "egress/")
        if isinstance(stmt, ast.SetVariable):
            target = (
                self.configs
                if stmt.system or getattr(self, "_session", None) is None
                else self._session
            )
            if stmt.name == "kernel_backend":
                if str(stmt.value) not in _KERNEL_MODES:
                    raise PlanError(
                        f"invalid value for kernel_backend: {stmt.value!r} "
                        f"(expected one of {', '.join(_KERNEL_MODES)})"
                    )
                if str(stmt.value) != _KERNEL_MODES[0]:
                    # the port's kernels are its CUDA ones (CPU tensors take
                    # the plain versions); the XLA/Pallas choice is the JAX
                    # package's
                    raise _not_ported(f"kernel_backend = {stmt.value!r}",
                                      "the JAX package's kernel registry")
            elif stmt.name == "exchange_backend":
                from ..parallel.devicemesh import EXCHANGE_MODES

                if str(stmt.value) not in EXCHANGE_MODES:
                    raise PlanError(
                        f"invalid value for exchange_backend: {stmt.value!r} "
                        f"(expected one of {', '.join(EXCHANGE_MODES)})"
                    )
            elif stmt.name in ("enable_jax_profiler", "jax_profiler_dir"):
                raise _not_ported(f"SET {stmt.name}", "the JAX package's profiler "
                                  "(obs/profiler.py there)")
            try:
                target.set(stmt.name, stmt.value)
            except KeyError as e:
                raise PlanError(str(e))
            if stmt.name == "log_filter":
                        TRACER.set_filter(self._cfg().get("log_filter"))
            elif stmt.name == "enable_operator_logging":
                # flip LIVE dataflows too — newly rendered ones read the
                # config at construction (_make_dataflow)
                on = bool(self._cfg().get("enable_operator_logging"))
                for _gid, df, _srcs in self.dataflows:
                    df.operator_logging = on
            return ExecResult("status", status="SET")
        if isinstance(stmt, ast.ResetVariable):
            if stmt.name not in self.configs.names():
                raise PlanError(
                    f"unknown configuration parameter: {stmt.name}"
                )
            target = (
                self._session
                if getattr(self, "_session", None) is not None
                else self.configs
            )
            target.reset(stmt.name)
            return ExecResult("status", status="RESET")
        if isinstance(stmt, ast.Update):
            return self._update(stmt)
        if isinstance(stmt, ast.Copy):
            return self._copy(stmt)
        raise PlanError(f"unsupported statement: {type(stmt).__name__}")

    def _copy(self, stmt: ast.Copy) -> ExecResult:
        """COPY … TO STDOUT (reference: pgwire COPY + copy_to sinks)."""
        if stmt.format not in ("csv", "text"):
            raise PlanError(f"unsupported COPY format {stmt.format}")
        res = self._select(stmt.query)
        import csv as _csv
        import io as _io

        buf = _io.StringIO()
        if stmt.format == "csv":
            w = _csv.writer(buf, lineterminator="\n")  # Postgres COPY uses \n
            for row in res.rows:
                w.writerow(row)
        else:
            for row in res.rows:
                buf.write("\t".join(str(v) for v in row) + "\n")
        out = ExecResult("copy", columns=res.columns, status=f"COPY {len(res.rows)}")
        out.copy_data = buf.getvalue()
        return out

    # -- DDL -------------------------------------------------------------------
    def _create_table(self, stmt: ast.CreateTable) -> ExecResult:
        cols = tuple(
            ColumnDesc(c.name, coltype_of(c.typ), nullable=not c.not_null)
            for c in stmt.columns
        )
        desc = RelationDesc(cols)
        item = self.catalog.create(CatalogItem(stmt.name, "table", desc=desc))
        self.storage[item.global_id] = StorageCollection(desc.dtypes, self.device)
        return ExecResult("status", status="CREATE TABLE")

    _AUCTION_TABLES = {
        "organizations": RelationDesc.of(
            ("id", ColType.INT64), ("name", ColType.STRING), key=(0,)
        ),
        "users": RelationDesc.of(
            ("id", ColType.INT64), ("org_id", ColType.INT64), ("name", ColType.STRING),
            key=(0,),
        ),
        "accounts": RelationDesc.of(
            ("id", ColType.INT64), ("org_id", ColType.INT64), ("balance", ColType.INT64),
            key=(0,),
        ),
        "auctions": RelationDesc.of(
            ("id", ColType.INT64), ("seller", ColType.INT64), ("item", ColType.STRING),
            ("end_time", ColType.TIMESTAMP), key=(0,),
        ),
        "bids": RelationDesc.of(
            ("id", ColType.INT64), ("buyer", ColType.INT64), ("auction_id", ColType.INT64),
            ("amount", ColType.INT64), ("bid_time", ColType.TIMESTAMP), key=(0,),
        ),
    }

    _TPCH_TABLES = {
        "customer": RelationDesc.of(
            ("c_custkey", ColType.INT64), ("c_mktsegment", ColType.STRING),
            ("c_nationkey", ColType.INT64), key=(0,),
        ),
        "orders": RelationDesc.of(
            ("o_orderkey", ColType.INT64), ("o_custkey", ColType.INT64),
            ("o_orderdate", ColType.TIMESTAMP), ("o_shippriority", ColType.INT64),
            key=(0,),
        ),
        "lineitem": RelationDesc.of(
            ("l_orderkey", ColType.INT64),
            ColumnDesc("l_extendedprice", ColType.NUMERIC, scale=2),
            ColumnDesc("l_discount", ColType.NUMERIC, scale=2),
            ("l_shipdate", ColType.TIMESTAMP), ("l_quantity", ColType.INT64),
            ("l_partkey", ColType.INT64),
        ),
        "part": RelationDesc.of(
            ("p_partkey", ColType.INT64), ("p_brand", ColType.INT64),
            ("p_container", ColType.INT64), key=(0,),
        ),
    }


    def _create_source(self, stmt: ast.CreateSource) -> ExecResult:
        opts = dict(stmt.options)
        if stmt.generator == "auction":
            gen = AuctionGenerator(seed=0, dict_=self.catalog.dict, device=self.device)
            tables = self._AUCTION_TABLES
        elif stmt.generator == "key_value":
            raise _not_ported("LOAD GENERATOR KEY VALUE", "storage/upsert.py")
        elif stmt.generator == "counter":
            maxc = opts.get("max cardinality")
            gen = CounterGenerator(int(maxc) if maxc else None, device=self.device)
            tables = {"counter": RelationDesc.of(("counter", ColType.INT64))}
        elif stmt.generator == "tpch":
            sf = float(opts.get("scale factor", 0.01) or 0.01)
            from ..storage.generator import _SEGMENTS

            codes = [self.catalog.dict.encode(seg) for seg in _SEGMENTS]
            gen = TpchGenerator(sf=sf, segment_codes=codes, device=self.device)
            tables = self._TPCH_TABLES
        else:
            raise PlanError(f"unsupported load generator {stmt.generator}")
        append_only = stmt.generator == "auction" or (
            stmt.generator == "counter" and not opts.get("max cardinality")
        )
        gids = {}
        for tname, desc in tables.items():
            item = self.catalog.create(
                CatalogItem(tname, "source", desc=desc, append_only=append_only)
            )
            self.storage[item.global_id] = StorageCollection(desc.dtypes, self.device)
            gids[tname] = item.global_id
        self.catalog.create(CatalogItem(stmt.name, "source_parent", generator=stmt.generator))
        self.generators.append((gen, gids))
        if stmt.generator == "auction":
            ts = self.oracle.write_ts()
            for tname, cols in gen.static_tables().items():
                n = len(cols[0])
                batch = UpdateBatch.build((), cols, np.full(n, ts), np.ones(n, dtype=np.int64),
                                          device=self.device)
                self._apply_writes({gids[tname]: batch}, ts)
        elif stmt.generator == "tpch":
            ts = self.oracle.write_ts()
            init = gen.initial_batches(ts)
            self._apply_writes({gids[t]: b for t, b in init.items()}, ts)
        return ExecResult("status", status="CREATE SOURCE")

    def _create_view(self, stmt: ast.CreateView) -> ExecResult:
        pq = self.planner.plan_query(stmt.query)
        self.catalog.create(
            CatalogItem(stmt.name, "view", desc=pq.desc, query_ast=stmt.query, mir=pq)
        )
        return ExecResult("status", status="CREATE VIEW")

    def _create_materialized_view(self, stmt: ast.CreateMaterializedView) -> ExecResult:
        pq = self.planner.plan_query(stmt.query)
        rel = pq.mir
        if pq.finishing.limit is not None:
            from ..sql.plan import _apply_finishing_as_topk

            rel = _apply_finishing_as_topk(pq)
        rel = optimize(rel, self.configs)
        item = self.catalog.create(
            CatalogItem(stmt.name, "materialized_view", desc=pq.desc, query_ast=stmt.query)
        )
        try:
            return self._install_mv(item, pq, rel)
        except Exception:
            # install is transactional against the shared-trace registry and
            # in-memory state: a CREATE that fails after exporting a trace
            # must not leak the export (a later dataflow would import a
            # stale, reader-less trace)
            self._rollback_mv_install(item)
            raise

    def _install_mv(self, item: CatalogItem, pq, rel) -> ExecResult:
        gid = item.global_id
        src_gids = sorted(_collect_gets(rel))
        env = {g: self.storage[g].dtypes for g in src_gids}
        desc = lower_to_dataflow(
            gid, rel, env, src_gids, index_key=(), as_of=0, mono_ids=self._mono_ids()
        )
        # hydrate: snapshot all inputs at the current read timestamp
        as_of = self.oracle.read_ts()
        desc.as_of = as_of
        snaps = {g: self.storage[g].snapshot(as_of) for g in src_gids}
        df = self._make_dataflow(desc, snaps, trace_reader=gid)
        results = df.step(as_of, snaps)
        self.storage[gid] = StorageCollection(pq.desc.dtypes, self.device)
        out = results.get(gid)
        item.mir = rel
        if out is not None and out[0] is not None:
            self.storage[gid].append(out[0], as_of)
        self.dataflows.append((gid, df, src_gids))
        return ExecResult("status", status="CREATE MATERIALIZED VIEW")

    def _rollback_mv_install(self, item: CatalogItem) -> None:
        """Undo a failed CREATE MATERIALIZED VIEW: in-memory state, the
        dataflow, and — crucially — any shared-trace exports/holds the
        render registered, leaving the TraceManager exactly as before."""
        gid = item.global_id
        self.catalog.items.pop(item.name, None)
        self.storage.pop(gid, None)
        self.dataflows = [d for d in self.dataflows if d[0] != gid]
        self.trace_manager.rollback_install(gid)

    def _create_index(self, stmt: ast.CreateIndex) -> ExecResult:
        on = self.catalog.get(stmt.on)
        key = tuple(on.desc.index_of(c) for c in stmt.key_columns) if stmt.key_columns else tuple(on.desc.key)
        name = stmt.name or f"{stmt.on}_idx"
        self.catalog.create(
            CatalogItem(name, "index", index_on=stmt.on, index_key=key)
        )
        return ExecResult("status", status="CREATE INDEX")

    def _drop(self, stmt: ast.DropObject) -> ExecResult:
        item = self.catalog.drop(stmt.name, stmt.if_exists)
        if item is not None:
            self.storage.pop(item.global_id, None)
            self.dataflows = [d for d in self.dataflows if d[0] != item.global_id]
            # release the dropped dataflow's since holds: shared traces it
            # read re-arm compaction to the next-slowest reader, and a trace
            # left with NO readers is deleted (nobody would maintain it)
            self.trace_manager.release(item.global_id)
        return ExecResult("status", status=f"DROP {stmt.kind.upper()}")

    # -- DML -------------------------------------------------------------------
    def _insert(self, stmt: ast.Insert) -> ExecResult:
        item = self.catalog.get(stmt.table)
        if item.kind != "table":
            raise PlanError(f"cannot INSERT into {item.kind} {stmt.table}")
        desc = item.desc
        if stmt.columns:
            positions = [desc.index_of(c) for c in stmt.columns]
        else:
            positions = list(range(desc.arity))
        cols = [[] for _ in range(desc.arity)]
        for row in stmt.rows:
            if len(row) != len(positions):
                raise PlanError("INSERT row arity mismatch")
            vals = [None] * desc.arity
            for pos, e in zip(positions, row):
                vals[pos] = self._literal_value(e, desc.columns[pos])
            for i, v in enumerate(vals):
                if v is None:
                    # unmentioned column: SQL default is NULL
                    from ..expr.scalar import null_sentinel

                    v = null_sentinel(desc.columns[i].dtype)
                cols[i].append(v)
        arrays = tuple(
            np.array(c, dtype=desc.columns[i].dtype) for i, c in enumerate(cols)
        )
        ts = self.oracle.write_ts()
        n = len(stmt.rows)
        batch = UpdateBatch.build((), arrays, np.full(n, ts), np.ones(n, dtype=np.int64),
                                  device=self.device)
        self._apply_writes({item.global_id: batch}, ts)
        return ExecResult("status", status=f"INSERT 0 {n}")

    def _delete(self, stmt: ast.Delete) -> ExecResult:
        item = self.catalog.get(stmt.table)
        if item.kind != "table":
            raise PlanError(f"cannot DELETE from {item.kind}")
        # evaluate SELECT * FROM t WHERE pred, emit retractions
        q = ast.Query(
            ast.Select(
                items=(ast.SelectItem(ast.Star()),),
                from_=(ast.TableRef(stmt.table),),
                where=stmt.where,
            )
        )
        res = self._select(q)
        if not res.rows:
            return ExecResult("status", status="DELETE 0")
        desc = item.desc
        cols = tuple(
            np.array(
                [self._encode_val(r[i], desc.columns[i]) for r in res.rows],
                dtype=desc.columns[i].dtype,
            )
            for i in range(desc.arity)
        )
        ts = self.oracle.write_ts()
        n = len(res.rows)
        batch = UpdateBatch.build((), cols, np.full(n, ts), -np.ones(n, dtype=np.int64),
                                  device=self.device)
        self._apply_writes({item.global_id: batch}, ts)
        return ExecResult("status", status=f"DELETE {n}")

    def _traces(self):
        """The shared-trace registry, or None when arrangement sharing is
        force-disabled (enable_arrangement_sharing, the bisection dyncfg)."""
        if not bool(self.configs.get("enable_arrangement_sharing")):
            return None
        return self.trace_manager

    def _make_dataflow(self, desc, snaps: dict | None = None, trace_reader=None):
        """Render a DataflowDescription through the shared rendering decision
        point (`runtime.render_dataflow`): the fused path when enabled and
        expressible, over the worker mesh as `exchange_backend` decides,
        else the host-orchestrated operator graph."""
        from ..dataflow.fused import FusedCaps
        from ..dataflow.runtime import render_dataflow

        caps = FusedCaps(
            ratio=int(self.configs.get("lsm_merge_ratio")),
            cap_ratio=int(self.configs.get("fused_join_cap_ratio")),
        )
        # pre-size so the hydration tick doesn't ladder through doubling
        # retries on large input snapshots
        snap_rows = max((host_int(b.count()) for b in (snaps or {}).values()), default=0)
        return render_dataflow(
            desc,
            fused=bool(self.configs.get("enable_fused_render")),
            exchange_backend=str(self.configs.get("exchange_backend")),
            mesh=self.mesh,
            caps=caps,
            traces=self._traces() if trace_reader is not None else None,
            trace_reader=trace_reader,
            operator_logging=bool(self.configs.get("enable_operator_logging")),
            snap_rows=snap_rows,
            device=self.device,
        )

    def _encode_val(self, v, cd):
        """Re-encode a decoded row value to its storage representation:
        strings to dictionary codes, NUMERIC floats back to fixed-point,
        None back to the dtype's NULL sentinel. Decoded SELECT rows carry
        NUMERIC as scaled floats; retractions and rewrites must target the
        stored fixed-point value exactly."""
        if v is None:
            from ..expr.scalar import null_sentinel

            return null_sentinel(cd.dtype)
        if isinstance(v, str):
            return self.catalog.dict.encode(v)
        if cd.typ == ColType.NUMERIC and isinstance(v, float):
            return int(round(v * 10**cd.scale))
        return v

    def _update(self, stmt: ast.Update) -> ExecResult:
        """UPDATE = retract matching rows + insert modified versions (the
        read-then-write shape of the reference's sequence_update)."""
        item = self.catalog.get(stmt.table)
        if item.kind != "table":
            raise PlanError(f"cannot UPDATE {item.kind}")
        q = ast.Query(
            ast.Select(
                items=(ast.SelectItem(ast.Star()),),
                from_=(ast.TableRef(stmt.table),),
                where=stmt.where,
            )
        )
        res = self._select(q)
        if not res.rows:
            return ExecResult("status", status="UPDATE 0")
        desc = item.desc
        assign = {col: e for col, e in stmt.assignments}
        encode_val = self._encode_val
        old_cols = [[] for _ in range(desc.arity)]
        new_cols = [[] for _ in range(desc.arity)]
        from ..sql.plan import Scope, ScopeCol, PType

        scope = Scope(
            [
                ScopeCol(stmt.table, c.name, PType(c.typ, c.scale if c.typ == ColType.NUMERIC else 0))
                for c in desc.columns
            ]
        )
        for row in res.rows:
            encoded = [encode_val(v, desc.columns[i]) for i, v in enumerate(row)]
            for i in range(desc.arity):
                old_cols[i].append(encoded[i])
            # evaluation happens in None-space (decoded rows carry None for
            # NULL) so the interpreter never has to guess sentinel widths;
            # results re-encode (None -> sentinel) below
            eval_row = [
                None if row[i] is None else encoded[i] for i in range(desc.arity)
            ]
            newrow = list(encoded)
            for i, c in enumerate(desc.columns):
                if c.name in assign:
                    # evaluate assignment expression against the OLD row
                    e, _t = self.planner.plan_scalar(assign[c.name], scope)
                    newrow[i] = encode_val(_eval_scalar_on_row(e, eval_row), c)
            for i in range(desc.arity):
                new_cols[i].append(newrow[i])
        import numpy as _np

        ts = self.oracle.write_ts()
        n = len(res.rows)
        arrays = tuple(
            _np.concatenate([
                _np.array(old_cols[i], dtype=desc.columns[i].dtype),
                _np.array(new_cols[i], dtype=desc.columns[i].dtype),
            ])
            for i in range(desc.arity)
        )
        diffs = _np.concatenate([-_np.ones(n, dtype=_np.int64), _np.ones(n, dtype=_np.int64)])
        batch = UpdateBatch.build((), arrays, _np.full(2 * n, ts), diffs, device=self.device)
        self._apply_writes({item.global_id: batch}, ts)
        return ExecResult("status", status=f"UPDATE {n}")

    def _literal_value(self, e, cdesc: ColumnDesc):
        if isinstance(e, ast.Param):
            # extended-protocol parameter: re-dispatch the bound text value
            # as the equivalent literal AST (typed by the target column)
            ps = self.planner._params
            if ps is None or not (1 <= e.index <= len(ps)):
                raise PlanError(f"parameter ${e.index} not bound")
            v = ps[e.index - 1]
            if v is None:
                return self._literal_value(ast.NullLit(), cdesc)
            if cdesc.typ == ColType.STRING:
                return self.catalog.dict.encode(v)
            if cdesc.typ == ColType.JSONB:
                return self.catalog.dict.encode(self._json_canonical(v))
            if cdesc.typ == ColType.BOOL:
                return v.lower() in ("t", "true", "1")
            import re as _re

            if _re.fullmatch(r"\d{4}-\d{2}-\d{2}", v):
                return self._literal_value(ast.DateLit(v), cdesc)
            return self._literal_value(ast.NumberLit(v.lstrip("+")), cdesc)
        if isinstance(e, ast.NullLit):
            from ..expr.scalar import null_sentinel

            return null_sentinel(cdesc.dtype)
        if cdesc.typ == ColType.STRING and isinstance(
            e, (ast.NumberLit, ast.BoolLit)
        ):
            # coerce non-string literals into text columns (pg casts them)
            v = e.value if isinstance(e, ast.NumberLit) else str(e.value).lower()
            return self.catalog.dict.encode(str(v))
        if isinstance(e, ast.NumberLit):
            if "e" in e.value or "E" in e.value:  # scientific notation
                # expand the exponent exactly and reuse the plain-decimal
                # path, so '2.678' and '2.678e0' encode identically
                # (truncation, not rounding — advisor r4)
                from decimal import Decimal

                txt = format(Decimal(e.value), "f")
                if cdesc.typ in (ColType.INT64, ColType.INT32):
                    return int(Decimal(e.value))
                return self._literal_value(ast.NumberLit(txt), cdesc)
            if cdesc.typ == ColType.NUMERIC:
                if "." in e.value:
                    # sign applies to the WHOLE value: int('-1')*100 + 50 would
                    # yield -50 for '-1.50' instead of -150
                    neg = e.value.lstrip().startswith("-")
                    ip, fp = e.value.lstrip().lstrip("-").split(".")
                    fp = (fp + "0" * cdesc.scale)[: cdesc.scale]
                    mag = int(ip or "0") * 10**cdesc.scale + int(fp or "0")
                    return -mag if neg else mag
                return int(e.value) * 10**cdesc.scale
            if "." in e.value:
                # f32 like plan.py's literal typing — host and device agree
                return float(np.float32(e.value))
            return int(e.value)
        if isinstance(e, ast.StringLit):
            if cdesc.typ == ColType.JSONB:
                return self.catalog.dict.encode(self._json_canonical(e.value))
            return self.catalog.dict.encode(e.value)
        if isinstance(e, ast.BoolLit):
            return e.value
        if isinstance(e, ast.UnaryOp) and e.op == "-":
            v = self._literal_value(e.expr, cdesc)
            return -v
        if isinstance(e, ast.DateLit):
            from ..storage.generator import date_num

            y, m, d = (int(x) for x in e.value.split("-"))
            return int(date_num(y, m, d))
        raise PlanError(f"unsupported literal {e!r}")

    def _json_canonical(self, text: str) -> str:
        from ..expr.strings import json_canonical

        try:
            return json_canonical(text)
        except ValueError as exc:
            raise PlanError(f"invalid input syntax for type jsonb: {exc}") from exc

    # -- durability and replicas (not ported) -----------------------------------
    def checkpoint(self) -> None:
        raise _not_ported("checkpoint()", "persist/")

    def catch_up(self) -> int:
        raise _not_ported("catch_up()", "persist/")

    def promote(self) -> None:
        raise _not_ported("promote()", "persist/")

    def create_compute_replica(self, name: str, size: str, *args, **kwargs):
        raise _not_ported("create_compute_replica()", "cluster/ and orchestrator/")

    def drop_compute_replica(self, name: str) -> None:
        raise _not_ported("drop_compute_replica()", "cluster/ and orchestrator/")

    def replica_peek(self, dataflow_id: str, index_id: str, at=None):
        raise _not_ported("replica_peek()", "cluster/ and orchestrator/")

    def replica_stats(self) -> list:
        raise _not_ported("replica_stats()", "cluster/ and orchestrator/")

    def _diff_correction(self, desired, persisted: list, t: int):
        """(desired - sum of persisted) advanced to `t`, consolidated: the
        correction delta of the self-correcting sink (_mv_sink_correct)."""
        from ..dataflow.runtime import negate_batch

        merged = desired
        for p in persisted:
            merged = UpdateBatch.concat(merged, negate_batch(p))
        return consolidate(advance_times(merged, t))

    def _mono_ids(self) -> set:
        return {
            i.global_id for i in self.catalog.items.values() if i.append_only
        }

    # -- write propagation -----------------------------------------------------
    def _apply_writes(self, writes: dict[str, UpdateBatch], ts: int) -> None:
        """Group commit: append to storage, then flow through every
        installed dataflow in dependency order (an MV's output delta becomes
        visible to downstream MVs at the same timestamp). In memory the
        storage append is the commit point."""
        from .overload import MemoryLimiter

        limit = int(self.configs.get("memory_limit_mb"))
        if limit:
            MemoryLimiter(limit).check()
        env = dict(writes)
        for gid, batch in writes.items():
            self.storage[gid].append(batch, ts)
        interval = int(self.configs.get("mv_sink_self_correct_interval"))
        correct = interval > 0 and ts % interval == 0
        for mv_gid, df, src_gids in self.dataflows:
            deltas = {g: env[g] for g in src_gids if g in env}
            if not deltas and not df.has_temporal:
                # quiet dataflow; temporal ones must still see time pass —
                # but sink correction still runs (an idle view's corrupted
                # collection must heal even with no source deltas)
                df.frontier = ts + 1
                if correct:
                    self._mv_sink_correct(mv_gid, df, ts)
                continue
            _t0 = _monotonic()
            results = df.step(ts, deltas)
            _TICK_NS.observe((_monotonic() - _t0) * 1e9, dataflow=mv_gid)
            out = results.get(mv_gid)
            if out is not None and out[0] is not None:
                env[mv_gid] = out[0]
                self.storage[mv_gid].append(out[0], ts)
            if correct:
                self._mv_sink_correct(mv_gid, df, ts)
        self._drive_compaction(ts)

    def _mv_sink_correct(self, mv_gid: str, df, ts: int):
        """Self-correcting sink: append (desired - stored) at `ts`.

        `desired` is the dataflow's own index trace, the authoritative view
        contents; `stored` is the storage collection readers see. In a
        healthy check the diff consolidates to nothing and nothing is
        appended; any divergence is healed with one correction delta. The
        full-snapshot diff costs O(view), so it runs every
        `mv_sink_self_correct_interval` ticks. Returns the correction batch
        or None.
        """
        idx = f"idx_{mv_gid}"
        if idx not in df.index_traces or mv_gid not in self.storage:
            return None
        desired = df.index_traces[idx].merged()
        persisted = self.storage[mv_gid].snapshot(ts)
        correction = self._diff_correction(desired, [persisted], ts)
        n = host_int(correction.count())
        if not n:
            return None
        from ..repr.batch import bucket_cap

        _log.warn(
            "mv sink self-correction: collection diverged from its "
            "dataflow; healing",
            mv=mv_gid,
            rows=n,
            ts=ts,
        )
        self.mv_corrections = getattr(self, "mv_corrections", 0) + n
        correction = correction.with_capacity(bucket_cap(n))
        self.storage[mv_gid].append(correction, ts)
        return correction

    def _drive_compaction(self, ts: int) -> None:
        """Advance `since` on dataflow state and storage arrangements,
        keeping a configured window of history (the reference's read-policy
        and AllowCompaction loop)."""
        window = int(self.configs.get("compaction_window"))
        if window <= 0:
            return
        since = ts - window
        if since <= 0:
            return
        for _gid, df, _src in self.dataflows:
            df.compact(since)
        for gid, store in self.storage.items():
            store.arr.compact(since)

    def advance(self, n_rows: int = 100) -> int:
        """Pull one batch from every generator source and commit it.

        Ingest is byte-budgeted (`source_ingest_budget_bytes`): each source
        gets a bounded grant per tick and yields its remainder to later
        ticks (`overload.IngestBudget`); yields are counted in
        `overload` as ingest_yields."""
        from .overload import IngestBudget, batch_bytes_estimate

        ts = self.oracle.write_ts()
        writes: dict[str, UpdateBatch] = {}
        budget = IngestBudget(int(self.configs.get("source_ingest_budget_bytes")))
        for gen, gids in self.generators:
            # a spent budget still grants one record per source (the
            # IngestBudget liveness floor): sources shrink, never starve
            if isinstance(gen, AuctionGenerator):
                batches = gen.next_tick(ts, budget.grant_rows(gen.ROW_BYTES, n_rows))
            elif isinstance(gen, CounterGenerator):
                budget.grant_rows(gen.ROW_BYTES, 1)
                batches = gen.next_tick(ts, 1)
            else:
                # TPC-H refresh sizes itself; charge the actual batches so
                # later sources in the same tick see the spend
                batches = gen.refresh(ts)
                for b in batches.values():
                    budget.charge(batch_bytes_estimate(b))
            for t, b in batches.items():
                if t in gids:
                    writes[gids[t]] = b
                    self._note_source_progress(
                        gids[t],
                        records=host_int(b.count()),
                        nbytes=batch_bytes_estimate(b),
                    )
        if budget.yields:
            self.overload.bump("ingest_yields", budget.yields)
        # a quiet tick still advances the dataflow frontiers: write_ts above
        # moved read_ts forward, and an MV peek at read_ts >= frontier
        # errors as incomplete
        self._apply_writes(writes, ts)
        return ts

    def _note_source_progress(
        self, gid: str, records: int = 0, nbytes: int = 0, offset=None
    ) -> None:
        st = self.source_stats.setdefault(
            gid, {"offset": 0, "bytes": 0, "records": 0, "updated": 0.0}
        )
        st["records"] += int(records)
        st["bytes"] += int(nbytes)
        if offset is not None:
            st["offset"] = int(offset)
        st["updated"] = _time.time()

    # -- reads -----------------------------------------------------------------
    def _result_budget(self) -> int | None:
        """max_result_size in bytes, or None when unlimited (0)."""
        b = int(self._cfg().get("max_result_size"))
        return b if b > 0 else None

    def _select(self, query: ast.Query) -> ExecResult:
        import time as _time

        t0 = _time.perf_counter_ns()
        self.check_cancellation()
        with TRACER.span("plan"):
            pq = self.planner.plan_query(query)
            rel = optimize(pq.mir, self._cfg())
        as_of = self.oracle.read_ts()

        with TRACER.span("peek"):
            rows = self._peek_fast_path(rel, as_of)
        if rows is None:
            with TRACER.span("peek:slow_path"):
                self.slow_path_peeks = getattr(self, "slow_path_peeks", 0) + 1
                src_gids = sorted(_collect_gets(rel))
                env = {g: self.storage[g].dtypes for g in src_gids}
                desc = lower_to_dataflow(
                    "peek", rel, env, src_gids, as_of=as_of, mono_ids=self._mono_ids(),
                    until=as_of + 1,
                )
                # ephemeral peeks IMPORT shared traces (export=False: a trace
                # exported by a one-tick dataflow would instantly go stale) and
                # hold them at as_of for the peek's lifetime; get_arrangement
                # validates as_of against each shared since — a trace compacted
                # past as_of is skipped so the peek renders privately from
                # snapshots instead of reading a partial history
                tm = self._traces()
                peek_reader = None
                if tm is not None:
                    self._peek_seq = getattr(self, "_peek_seq", 0) + 1
                    peek_reader = f"_peek_{self._peek_seq}"
                try:
                    df = Dataflow(
                        desc, traces=tm, trace_reader=peek_reader, trace_export=False,
                        device=self.device,
                    )
                    # the ephemeral dataflow is cancel-safe: no shared state to
                    # tear, so the tick loop checks the deadline between every
                    # dispatch
                    df.cancel_check = self.check_cancellation
                    snaps = {g: self.storage[g].snapshot(as_of) for g in src_gids}
                    df.step(as_of, snaps)
                    rows = df.peek("idx_peek", byte_budget=self._result_budget())
                finally:
                    if tm is not None:
                        # the peek expiring releases its holds (compaction re-arms)
                        tm.release(peek_reader)
        rows = self._finish(rows, pq)
        self._record_peek(_time.perf_counter_ns() - t0)
        return ExecResult("rows", rows=rows, columns=tuple(c.name for c in pq.scope.cols))

    # power-of-two histogram of peek durations (mz_peek_durations analogue)
    def _record_peek(self, ns: int) -> None:
        if not hasattr(self, "peek_histogram"):
            self.peek_histogram: dict[int, int] = {}
        bucket = 1
        while bucket < ns:
            bucket <<= 1
        self.peek_histogram[bucket] = self.peek_histogram.get(bucket, 0) + 1

    def _peek_fast_path(self, rel, as_of: int):
        """Fast-path peeks (peek.rs:119 path (a)): a Get of a maintained
        collection, optionally under a Map/Filter/Project chain — the chain is
        applied host-side to the peeked rows (FastPathPlan::PeekExisting with
        an MFP), avoiding an ephemeral dataflow build entirely."""
        if not bool(self.configs.get("enable_index_fast_path")):
            return None
        # peel a Map/Filter/Project chain down to a Get
        chain = []
        base = rel
        while isinstance(base, (mir.MirMap, mir.MirFilter, mir.MirProject)):
            chain.append(base)
            base = base.input
        if chain and isinstance(base, mir.MirGet):
            inner_rows = self._peek_fast_path(base, as_of)
            if inner_rows is None:
                return None
            from ..expr.linear import MfpBuilder

            b = MfpBuilder(mir.arity(base))
            for node in reversed(chain):
                if isinstance(node, mir.MirMap):
                    b.add_maps(node.exprs)
                elif isinstance(node, mir.MirFilter):
                    b.add_predicates(node.predicates)
                else:
                    b.project(node.outputs)
            mfp = b.finish()
            out = []
            for _i, row in enumerate(inner_rows):
                if (_i & 1023) == 0:
                    self.check_cancellation()
                cols = list(row)
                err = None
                for m in mfp.map_exprs:
                    try:
                        cols.append(_eval_scalar_on_row(m, cols))
                    except Exception as e:
                        cols.append(None)
                        err = err or e
                keep = True
                for p in mfp.predicates:
                    try:
                        ok = bool(_eval_scalar_on_row(p, cols))
                    except Exception as e:
                        err = err or e
                        ok = True  # an erroring predicate errors, not filters
                    keep = keep and ok
                if not keep:
                    continue  # guard semantics: filtered rows cannot error
                if err is not None:
                    raise RuntimeError(f"query error: {err}")
                out.append(tuple(cols[i] for i in mfp.projection))
            return sorted(out, key=_null_safe_row_key)
        if isinstance(rel, mir.MirGet):
            budget = self._result_budget()
            for mv_gid, df, _src in self.dataflows:
                if mv_gid == rel.id:
                    rows = df.peek(f"idx_{mv_gid}", at=as_of, byte_budget=budget)
                    return self._sentinels_to_none(rows, rel.id)
            st = self.storage.get(rel.id)
            if st is not None:
                out: dict = {}
                triples = st.arr.rows_host(as_of)
                for _i, (data, _t, d) in enumerate(triples):
                    if (_i & 4095) == 0:
                        self.check_cancellation()
                    out[data] = out.get(data, 0) + d
                from ..dataflow.runtime import materialize_counts

                return self._sentinels_to_none(
                    materialize_counts(out, rel.id, byte_budget=budget), rel.id
                )
        return None

    def _sentinels_to_none(self, rows: list, gid: str) -> list:
        """Encoded host rows → None-space NULLs, by storage column dtype.

        Host-side expression evaluation (fast-path MFPs, UPDATE assignments)
        cannot tell a -128 INT64 from a NULL BOOL by value alone; the storage
        dtype disambiguates. Idempotent for rows already holding None."""
        st = self.storage.get(gid)
        if st is None:
            return rows
        import numpy as _np

        from ..expr.scalar import NULL_I8, NULL_I32, NULL_I64

        sentinels = []
        for dt in st.dtypes:
            dt = _np.dtype(dt)
            if dt == _np.int8:
                sentinels.append(int(NULL_I8))
            elif dt == _np.int32:
                sentinels.append(int(NULL_I32))
            elif dt in (_np.dtype(_np.int64), _np.dtype(_np.uint64)):
                sentinels.append(int(NULL_I64))
            else:
                sentinels.append(None)  # floats: NaN checked directly
        out = []
        for r in rows:
            out.append(
                tuple(
                    None
                    if v is None
                    or (isinstance(v, float) and v != v)
                    or (sentinels[i] is not None and int(v) == sentinels[i])
                    else v
                    for i, v in enumerate(r)
                )
            )
        return out

    def _finish(self, rows: list, pq: PlannedQuery) -> list:
        from ..dataflow.runtime import row_bytes_estimate
        from ..errors import ResultSizeExceeded

        f = pq.finishing
        # max_result_size bounds the MATERIALIZED working set (pre-LIMIT:
        # ORDER BY needs every row in memory before the limit can apply), so
        # the decode loop stops at the budget instead of building the rest
        budget = self._result_budget()
        decoded = []
        spent = 0
        for i, r in enumerate(rows):
            if (i & 511) == 0:
                self.check_cancellation()
            d = self._decode_row(r, pq)
            if budget is not None:
                spent += row_bytes_estimate(d)
                if spent > budget:
                    raise ResultSizeExceeded(
                        f"result exceeds max_result_size ({budget} bytes); "
                        f"aborted after {len(decoded)} rows"
                    )
            decoded.append(d)
        if f.order_by:
            nulls = f.nulls_last or tuple(not d for _c, d in f.order_by)
            for (col, desc_), nl in reversed(list(zip(f.order_by, nulls))):
                # k0 places NULLs per the requested side under the reverse
                # flag (pg default: NULLS LAST ascending, FIRST descending)
                null_hi = nl != desc_
                decoded.sort(
                    key=lambda r: (
                        (r[col] is None) if null_hi else (r[col] is not None),
                        r[col] if r[col] is not None else 0,
                    ),
                    reverse=desc_,
                )
        if f.offset:
            decoded = decoded[f.offset :]
        if f.limit is not None:
            decoded = decoded[: f.limit]
        return decoded

    def _decode_row(self, row: tuple, pq: PlannedQuery) -> tuple:
        from ..expr.scalar import is_null_value

        out = []
        for v, c in zip(row, pq.scope.cols):
            t = c.typ
            if is_null_value(v, t.col):
                out.append(None)
            elif t.col in (ColType.STRING, ColType.JSONB):
                out.append(self.catalog.dict.decode(int(v)))
            elif t.col == ColType.NUMERIC and t.scale:
                out.append(v / (10**t.scale))
            elif t.col == ColType.BOOL:
                out.append(bool(v))
            else:
                out.append(v)
        return tuple(out)

    # -- introspection ---------------------------------------------------------
    def _explain(self, stmt: ast.Explain) -> ExecResult:
        inner = stmt.statement
        if stmt.stage == "timeline":
            # run the inner statement under a fresh trace, then render the
            # end-to-end span tree — including clusterd-side spans absorbed
            # from TracedResponses (obs)
            from ..obs import render_timeline

            with TRACER.trace(f"timeline:{type(inner).__name__}") as root:
                # through execute_stmt, not _execute_stmt_inner: the nested
                # call records its "execute:<Stmt>" span as a child here
                self.execute_stmt(inner)
            spans = TRACER.spans_for_trace(root.trace_id)
            return ExecResult(
                "rows",
                rows=[(line,) for line in render_timeline(spans)],
                columns=("timeline",),
            )
        if stmt.stage == "timestamp" and isinstance(inner, ast.SelectStatement):
            pq = self.planner.plan_query(inner.query)
            rel = optimize(pq.mir, self._cfg())
            as_of = self.oracle.read_ts()
            lines = [f"query timestamp: {as_of}", f"oracle read:     {as_of}"]
            for gid in sorted(_collect_gets(rel)):
                name = next(
                    (i.name for i in self.catalog.items.values() if i.global_id == gid),
                    gid,
                )
                st = self.storage.get(gid)
                upper = getattr(st, "upper", "?")
                since = getattr(getattr(st, "arr", None), "since", 0)
                lines.append(f"source {name} ({gid}): [{since}, {upper})")
            return ExecResult(
                "rows", rows=[(line,) for line in lines], columns=("timestamp",)
            )
        if isinstance(inner, ast.SelectStatement):
            pq = self.planner.plan_query(inner.query)
            rel = (
                optimize(pq.mir, self.configs)
                if stmt.stage in ("optimized", "physical")
                else pq.mir
            )
            if stmt.stage == "physical":
                src_gids = sorted(_collect_gets(rel))
                env = {g: self.storage[g].dtypes for g in src_gids}
                lo = Lowerer(env, self._mono_ids())
                text = explain_lir(lo.lower(rel))
            else:
                text = explain_mir(rel)
            return ExecResult("rows", rows=[(line,) for line in text.splitlines()], columns=("plan",))
        raise PlanError("EXPLAIN supports SELECT only")

    def _show(self, stmt: ast.Show) -> ExecResult:
        kind_map = {
            "tables": ("table",),
            "views": ("view",),
            "sources": ("source",),
            "indexes": ("index",),
            "materialized": ("materialized_view",),
        }
        if stmt.what == "all":
            cfg = self._cfg()
            rows = [(name, str(cfg.get(name))) for name in self.configs.names()]
            return ExecResult("rows", rows=rows, columns=("name", "setting"))
        kinds = kind_map.get(stmt.what)
        if kinds is None and stmt.what in self.configs.names():
            return ExecResult(
                "rows", rows=[(str(self._cfg().get(stmt.what)),)], columns=(stmt.what,)
            )
        if kinds is None:
            if stmt.what == "columns" and stmt.on:
                item = self.catalog.get(stmt.on)
                rows = [(c.name, c.typ.value) for c in item.desc.columns]
                return ExecResult("rows", rows=rows, columns=("name", "type"))
            raise PlanError(f"SHOW {stmt.what} unsupported")
        rows = [(i.name,) for i in self.catalog.items.values() if i.kind in kinds]
        return ExecResult("rows", rows=sorted(rows), columns=("name",))


def explain_lir(e, indent: int = 0) -> str:
    """EXPLAIN PHYSICAL PLAN rendering of a lowered LIR tree."""
    pad = "  " * indent
    name = type(e).__name__
    extra = ""
    kids = []
    if isinstance(e, lir.Get):
        extra = f" {e.id}"
    elif isinstance(e, lir.Mfp):
        m = e.mfp
        extra = f" maps={len(m.map_exprs)} preds={len(m.predicates)}"
        kids = [e.input]
    elif isinstance(e, lir.Join):
        kind = "delta" if isinstance(e.plan, lir.DeltaJoinPlan) else "linear"
        extra = f" type={kind}"
        kids = list(e.inputs)
    elif isinstance(e, lir.Reduce):
        extra = f" keys={list(e.key_cols)} aggs={[a.func for a in e.aggs]}" + (
            " distinct" if e.distinct else ""
        )
        kids = [e.input]
    elif isinstance(e, lir.TopK):
        extra = f" group={list(e.plan.group_cols)} limit={e.plan.limit}" + (
            " monotonic" if getattr(e, "monotonic", False) else ""
        )
        kids = [e.input]
    elif isinstance(e, lir.BasicAgg):
        extra = f" keys={list(e.key_cols)} func={e.func}"
        kids = [e.input]
    elif isinstance(e, (lir.Negate, lir.Threshold, lir.ArrangeBy, lir.TemporalFilter)):
        kids = [e.input]
    elif isinstance(e, lir.Union):
        kids = list(e.inputs)
    elif isinstance(e, lir.LetRec):
        extra = f" bindings={len(e.bindings)}"
        kids = [b[1] for b in e.bindings] + [e.body]
    elif isinstance(e, lir.Constant):
        extra = f" rows={len(e.rows)}"
    lines = [f"{pad}{name}{extra}"]
    for k in kids:
        lines.append(explain_lir(k, indent + 1))
    return "\n".join(lines)


def _null_safe_row_key(row: tuple):
    """Deterministic sort key for host-path rows that may hold None."""
    return tuple((v is None, 0 if v is None else v) for v in row)


def _eval_scalar_on_row(e, row: list):
    """Host interpreter for a planned ScalarExpr over one encoded row
    (UPDATE assignments, fast-path peek MFPs; mirrors eval_expr3's
    three-valued semantics with Python None as NULL)."""
    from ..expr import scalar as s
    from ..expr.scalar import is_null_value

    if isinstance(e, s.Column):
        v = row[e.index]
        return None if is_null_value(v) else v
    if isinstance(e, s.Literal):
        return e.value
    if isinstance(e, s.CallUnary):
        v = _eval_scalar_on_row(e.expr, row)
        if e.func == "is_null":
            return v is None
        if e.func == "is_not_null":
            return v is not None
        if v is None:
            return None
        if e.func in ("extract_year", "extract_month", "extract_day"):
            from ..expr.scalar import civil_from_days_int

            y, m, d = civil_from_days_int(int(v))
            return {"extract_year": y, "extract_month": m, "extract_day": d}[e.func]
        if e.func == "sqrt":
            # f32 like the device kernel (expr/scalar.py sqrt), so host
            # fast-path peeks agree bit-for-bit with rendered dataflows
            return float(np.sqrt(np.float32(v), dtype=np.float32))
        if e.func in s._DATE_UNARY:
            from ..expr.scalar import date_unary_int

            return date_unary_int(e.func, int(v))
        if e.func in s._FLOAT_UNARY_NP:
            return float(np.float32(s._FLOAT_UNARY_NP[e.func](np.float32(v))))
        if e.func == "round_half_away":
            fv = np.float32(v)
            return float(np.float32(np.sign(fv) * np.floor(np.abs(fv) + np.float32(0.5))))
        if e.func == "sign":
            return float(np.sign(v)) if isinstance(v, float) else int(np.sign(v))
        return {
            "neg": lambda: -v,
            "not": lambda: not v,
            "abs": lambda: abs(v),
            "cast_int64": lambda: int(v),
            "cast_int32": lambda: int(v),
            "cast_float": lambda: float(np.float32(v)),
            "is_true": lambda: bool(v),
        }[e.func]()
    if isinstance(e, s.CallBinary):
        l = _eval_scalar_on_row(e.left, row)
        r = _eval_scalar_on_row(e.right, row)
        if e.func == "and":  # Kleene: FALSE dominates NULL
            if l is False or r is False or l == 0 and l is not None or r == 0 and r is not None:
                return False
            if l is None or r is None:
                return None
            return bool(l) and bool(r)
        if e.func == "or":  # Kleene: TRUE dominates NULL
            if (l is not None and bool(l)) or (r is not None and bool(r)):
                return True
            if l is None or r is None:
                return None
            return False
        if l is None or r is None:
            return None
        # float arithmetic mirrors the device's f32 kernels exactly, so a
        # fast-path peek and a rendered dataflow never disagree on a value
        # (the FLOAT64 precision rule, repr/types.py)
        fl = isinstance(l, float) or isinstance(r, float)

        def f32(x):
            return float(np.float32(x))

        if e.func in ("div", "floordiv"):
            if r == 0:
                raise PlanError("division by zero")
            if fl:
                return f32(np.float32(l) / np.float32(r))
            q = abs(l) // abs(r)
            return -q if (l < 0) != (r < 0) else q
        if e.func in ("fdiv", "fmod"):
            if r == 0:
                raise PlanError("division by zero")
            return l // r if e.func == "fdiv" else l - r * (l // r)
        if e.func == "add_months":
            from ..expr.scalar import add_months_int

            return add_months_int(int(l), int(r))
        return {
            "add": lambda: f32(np.float32(l) + np.float32(r)) if fl else l + r,
            "sub": lambda: f32(np.float32(l) - np.float32(r)) if fl else l - r,
            "mul": lambda: f32(np.float32(l) * np.float32(r)) if fl else l * r,
            # float mod mirrors the device's f32 kernel step-for-step
            # (advisor r4: f64 host arithmetic could disagree with a
            # rendered dataflow for float operands)
            "mod": lambda: (
                f32(
                    np.float32(l)
                    - np.float32(r)
                    * np.float32(
                        (np.abs(np.float32(l)) // np.abs(np.float32(r)))
                        * (1 if (l < 0) == (r < 0) else -1)
                    )
                )
                if fl
                else l - r * (abs(l) // abs(r)) * (1 if (l < 0) == (r < 0) else -1)
            ),
            "pow": lambda: f32(np.power(np.float32(l), np.float32(r))),
            "atan2": lambda: f32(np.arctan2(np.float32(l), np.float32(r))),
            "eq": lambda: l == r,
            "ne": lambda: l != r,
            "lt": lambda: l < r,
            "lte": lambda: l <= r,
            "gt": lambda: l > r,
            "gte": lambda: l >= r,
            "min": lambda: min(l, r),
            "max": lambda: max(l, r),
        }[e.func]()
    if isinstance(e, s.CallVariadic):
        vs = [_eval_scalar_on_row(x, row) for x in e.exprs]
        if e.func == "if":
            return vs[1] if (vs[0] is not None and vs[0]) else vs[2]
        if e.func == "and":
            if any(v is not None and not v for v in vs):
                return False
            if any(v is None for v in vs):
                return None
            return True
        if e.func == "or":
            if any(v is not None and v for v in vs):
                return True
            if any(v is None for v in vs):
                return None
            return False
        if e.func == "coalesce":
            for v in vs:
                if v is not None:
                    return v
            return None
        if e.func == "nullif":
            a, b = vs
            if a is not None and b is not None and a == b:
                return None
            return a
        if e.func == "greatest":
            nn = [v for v in vs if v is not None]
            return max(nn) if nn else None
        if e.func == "least":
            nn = [v for v in vs if v is not None]
            return min(nn) if nn else None
    if isinstance(e, s.DictFunc):
        vs = [_eval_scalar_on_row(a, row) for a in e.args]
        if e.spec[0] == "concat_ws":
            # NULL args are skipped (passed as None); NULL separator → NULL
            if vs[0] is None:
                return None
            args = [
                None if v is None else e.tables._decode_arg(at, v)
                for at, v in zip(e.argtypes, vs)
            ]
            r = e.tables.eval_one(e.spec, args)
            return None if r is None else e.tables.dct.encode(r)
        if any(v is None for v in vs):
            return None
        args = [e.tables._decode_arg(at, v) for at, v in zip(e.argtypes, vs)]
        r = e.tables.eval_one(e.spec, args)
        if r is None:
            return None
        if e.out == "string":
            return e.tables.dct.encode(r)
        if e.out == "bool":
            return bool(r)
        return int(r)
    raise PlanError(f"cannot evaluate {e!r} host-side")


def _collect_gets(e) -> set:
    return mir.collect_get_ids(e)


def explain_mir(e, indent: int = 0) -> str:
    """EXPLAIN text rendering of a MIR tree (reference: EXPLAIN PLAN)."""
    pad = "  " * indent
    name = type(e).__name__.replace("Mir", "")
    extra = ""
    if isinstance(e, mir.MirGet):
        extra = f" {e.id}"
    if isinstance(e, mir.MirJoin) and e.implementation is not None:
        extra = f" type={e.implementation.kind}"
    if isinstance(e, mir.MirReduce):
        extra = f" keys={list(e.group_key)} aggs={[a.func for a in e.aggregates]}"
    if isinstance(e, mir.MirTopK):
        extra = f" group={list(e.group_key)} limit={e.limit}"
    if isinstance(e, mir.MirWindow):
        extra = (
            f" partition={list(e.partition_cols)}"
            f" funcs={[f.func for f in e.funcs]}"
        )
    lines = [f"{pad}{name}{extra}"]
    for k in mir.children(e):
        lines.append(explain_mir(k, indent + 1))
    return "\n".join(lines)
