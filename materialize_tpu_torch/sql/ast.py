"""SQL AST — statements and expressions.

Counterpart of materialize_tpu/sql/ast.py: host Python, kept as a copy in the
port (which never imports the JAX package) and held to the same
behaviour by the port's tests.

The analogue of the reference's `mz-sql-parser` AST (src/sql-parser/src/ast/).
Only the statement surface the engine executes is modeled; everything is a
frozen dataclass for hashability and easy matching.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

# -- scalar expressions ------------------------------------------------------


@dataclass(frozen=True)
class Ident:
    """Possibly-qualified name: a.b → qualifier 'a', name 'b'."""

    name: str
    qualifier: Optional[str] = None


@dataclass(frozen=True)
class NumberLit:
    value: str  # textual; planner decides int vs numeric


@dataclass(frozen=True)
class StringLit:
    value: str


@dataclass(frozen=True)
class BoolLit:
    value: bool


@dataclass(frozen=True)
class NullLit:
    pass


@dataclass(frozen=True)
class DateLit:
    value: str  # 'YYYY-MM-DD'


@dataclass(frozen=True)
class IntervalLit:
    """INTERVAL '<n> year/month/week/day …' (reference: mz-repr Interval,
    src/repr/src/adt/interval.rs — the DATE-granularity slice: the engine's
    calendar unit is days, so sub-day fields are rejected at planning)."""

    value: str


@dataclass(frozen=True)
class UnaryOp:
    op: str  # - | not
    expr: Any


@dataclass(frozen=True)
class BinaryOp:
    op: str  # + - * / % = <> < <= > >= and or like
    left: Any
    right: Any


@dataclass(frozen=True)
class Param:
    """$n parameter placeholder (extended-protocol prepared statements)."""

    index: int  # 1-based


@dataclass(frozen=True)
class WindowSpec:
    """OVER ( [PARTITION BY exprs] [ORDER BY items] )."""

    partition_by: tuple = ()
    order_by: tuple = ()  # of OrderByItem


@dataclass(frozen=True)
class FuncCall:
    name: str
    args: tuple
    distinct: bool = False
    is_star: bool = False  # count(*)
    over: Optional[Any] = None  # WindowSpec → this is a window function call


@dataclass(frozen=True)
class Cast:
    expr: Any
    typ: str


@dataclass(frozen=True)
class Case:
    operand: Optional[Any]
    whens: tuple  # ((cond, result), ...)
    else_: Optional[Any]


@dataclass(frozen=True)
class InList:
    expr: Any
    items: tuple
    negated: bool = False


@dataclass(frozen=True)
class Between:
    expr: Any
    low: Any
    high: Any
    negated: bool = False


@dataclass(frozen=True)
class IsNull:
    expr: Any
    negated: bool = False


@dataclass(frozen=True)
class Star:
    qualifier: Optional[str] = None


@dataclass(frozen=True)
class Subquery:
    """Scalar or EXISTS subquery (decorrelated during HIR lowering)."""

    query: Any
    exists: bool = False


# -- relations ---------------------------------------------------------------


@dataclass(frozen=True)
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass(frozen=True)
class SubqueryRef:
    query: Any
    alias: str


@dataclass(frozen=True)
class TableFuncRef:
    """Table function in FROM (generate_series, …) — the reference's
    TableFunc/FlatMap surface (src/expr/src/relation/func.rs:3563)."""

    name: str
    args: tuple
    alias: Optional[str] = None


@dataclass(frozen=True)
class JoinClause:
    left: Any
    right: Any
    kind: str  # inner | left | right | full | cross
    on: Optional[Any]


@dataclass(frozen=True)
class SelectItem:
    expr: Any
    alias: Optional[str] = None


@dataclass(frozen=True)
class OrderByItem:
    expr: Any
    desc: bool = False
    nulls_last: Any = None  # None = dialect default (pg: last asc, first desc)


@dataclass(frozen=True)
class Select:
    items: tuple
    from_: tuple  # relation refs (comma list, each possibly a JoinClause tree)
    where: Optional[Any] = None
    group_by: tuple = ()
    having: Optional[Any] = None
    distinct: bool = False


@dataclass(frozen=True)
class CteBinding:
    """WITH binding; `columns` (name, type) pairs are required for MUTUALLY
    RECURSIVE bindings (as in the reference's WMR syntax) and absent for
    plain CTEs."""

    name: str
    query: Any
    columns: tuple = ()


@dataclass(frozen=True)
class Query:
    """Select plus set-ops / ordering / limit, optionally under WITH [MUTUALLY
    RECURSIVE] bindings."""

    body: Any  # Select | SetOp
    order_by: tuple = ()
    limit: Optional[int] = None
    offset: int = 0
    ctes: tuple = ()  # of CteBinding
    recursive: bool = False


@dataclass(frozen=True)
class Values:
    """VALUES (…), (…) as a query body."""

    rows: tuple


@dataclass(frozen=True)
class SetOp:
    op: str  # union | union_all | except | except_all | intersect | intersect_all
    left: Any
    right: Any


# -- statements --------------------------------------------------------------


@dataclass(frozen=True)
class ColumnDef:
    name: str
    typ: str
    not_null: bool = False


@dataclass(frozen=True)
class CreateTable:
    name: str
    columns: tuple


@dataclass(frozen=True)
class CreateSource:
    name: str
    generator: str  # auction | tpch | counter
    options: tuple = ()  # ((key, value), ...)


@dataclass(frozen=True)
class CreateFileSource:
    """CREATE SOURCE name (cols) FROM FILE 'path' (FORMAT JSON|CSV)
    [ENVELOPE UPSERT (KEY (cols))] — external CDC ingestion with durable
    offset reclocking."""

    name: str
    columns: tuple  # ColumnDef
    path: str
    format: str  # json | csv
    envelope: str = "none"
    key_cols: tuple = ()  # column names (upsert)


@dataclass(frozen=True)
class CreateMaterializedView:
    name: str
    query: Query


@dataclass(frozen=True)
class CreateView:
    name: str
    query: Query


@dataclass(frozen=True)
class CreateIndex:
    name: Optional[str]
    on: str
    key_columns: tuple  # column names; empty = default key


@dataclass(frozen=True)
class Insert:
    table: str
    columns: tuple
    rows: tuple  # tuple of tuples of exprs


@dataclass(frozen=True)
class Delete:
    table: str
    where: Optional[Any]


@dataclass(frozen=True)
class Update:
    table: str
    assignments: tuple  # ((col, expr), ...)
    where: Optional[Any]


@dataclass(frozen=True)
class SelectStatement:
    query: Query


@dataclass(frozen=True)
class Explain:
    stage: str  # raw | decorrelated | optimized | physical | timestamp | timeline
    statement: Any


@dataclass(frozen=True)
class Show:
    what: str  # tables | views | sources | indexes | columns
    on: Optional[str] = None


@dataclass(frozen=True)
class DropObject:
    kind: str  # table | view | source | index | materialized view
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class SetVariable:
    name: str
    value: str
    system: bool = False  # ALTER SYSTEM SET vs session SET


@dataclass(frozen=True)
class ShowVariable:
    name: str


@dataclass(frozen=True)
class ResetVariable:
    """RESET <name>: drop the session override, falling back to the system
    value (pg RESET; the session-vars half of overload budgeting)."""

    name: str


@dataclass(frozen=True)
class Copy:
    """COPY (query | table) TO STDOUT [WITH (FORMAT CSV)]."""

    query: Query
    format: str = "csv"


@dataclass(frozen=True)
class Subscribe:
    """SUBSCRIBE [TO] (query | name) [WITH (SNAPSHOT [true|false], PROGRESS)].

    `snapshot` controls whether the collection's contents as of the read
    timestamp are emitted before the per-tick deltas; `progress` requests
    interleaved progress rows (mz_progressed = true) marking frontier
    advancement (the reference's SUBSCRIBE options, sql/src/plan/statement/
    dml.rs SubscribeStatement)."""

    query: Query
    snapshot: bool = True
    progress: bool = False


@dataclass(frozen=True)
class CreateSink:
    """CREATE SINK <name> FROM <view> INTO FILE '<path>' FORMAT {JSON|CSV}:
    a catalog object streaming the view's consolidated per-tick changelog
    into an append-only file with exactly-once resume (the
    sink/materialized_view.rs shape, aimed at a file instead of Kafka)."""

    name: str
    from_name: str
    path: str
    format: str  # json | csv
