"""MIR — the mid-level relational IR the optimizer works on.

Counterpart of materialize_tpu/expr/relation.py: host Python, kept as a copy in the
port (which never imports the JAX package) and held to the same
behaviour by the port's tests.

The analogue of the reference's `MirRelationExpr`
(src/expr/src/relation.rs:100-309). Variants kept: Constant, Get, Map,
Filter, Project, Join, Reduce, TopK, Negate, Threshold, Union, Distinct
(a Reduce special case kept explicit for planning clarity). Correlated
subqueries are eliminated before MIR (HIR decorrelation lives in sql/plan.py
as in src/sql/src/plan/lowering.rs).

All nodes are frozen dataclasses; transforms rebuild rather than mutate.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional

from .scalar import ScalarExpr


@dataclass(frozen=True)
class MirConstant:
    rows: tuple  # ((data...), diff) pairs, all at the dataflow's as_of
    dtypes: tuple


@dataclass(frozen=True)
class MirGet:
    id: str
    arity: int


@dataclass(frozen=True)
class MirMap:
    input: Any
    exprs: tuple  # appended columns


@dataclass(frozen=True)
class MirFilter:
    input: Any
    predicates: tuple


@dataclass(frozen=True)
class MirProject:
    input: Any
    outputs: tuple  # column indices


@dataclass(frozen=True)
class MirJoin:
    """N-way join with equivalence classes of column references.

    equivalences: tuple of tuples of GLOBAL column indices — all members of
    a class must be equal. Global column order = concatenation of input
    columns (the reference's flat join column space, relation.rs Join docs).
    """

    inputs: tuple
    equivalences: tuple
    # filled by the JoinImplementation transform (join_implementation.rs):
    implementation: Optional[Any] = None  # "linear" | "delta" plan object
    # IS NOT DISTINCT FROM semantics: NULL keys match NULL keys. Used by
    # planner-internal joins (outer-join compensation semijoins) where the
    # in-band sentinel's native equality is exactly what's wanted; lowering
    # skips the IS NOT NULL key guards for these.
    null_safe: bool = False


@dataclass(frozen=True)
class MirAggregate:
    """func in {sum,count,min,max,avg is planned as sum/count} plus the Basic
    class (string_agg/array_agg/list_agg — reference AggregateFunc's
    catch-all, src/expr/src/relation/func.rs:1878); expr over input cols.

    `extra` carries Basic-aggregate rendering state: (delimiter | None,
    element argtype tag, StringDictionary ref)."""

    func: str
    expr: ScalarExpr
    distinct: bool = False
    extra: tuple | None = None


@dataclass(frozen=True)
class MirReduce:
    input: Any
    group_key: tuple  # column indices (scalar-expr keys are pre-Mapped)
    aggregates: tuple  # of MirAggregate


@dataclass(frozen=True)
class MirTopK:
    input: Any
    group_key: tuple
    order_by: tuple  # ((col, desc), ...)
    limit: Optional[int]
    offset: int = 0
    # per-order-col NULL placement; None = pg default (last asc, first desc)
    nulls_last: Optional[tuple] = None


@dataclass(frozen=True)
class MirWindowFunc:
    """func in {row_number, rank, dense_rank, ntile, lag, lead, first_value,
    last_value, sum, count, min, max}; arg is an input column index (None for
    argument-less funcs); offset = lag/lead distance or ntile buckets."""

    func: str
    arg: Optional[int] = None
    offset: int = 1


@dataclass(frozen=True)
class MirWindow:
    """Window functions: appends one column per func. The reference models
    window functions as AggregateFunc variants inside a whole-group-recompute
    reduce (src/expr/src/relation/func.rs:1963); this node is the explicit
    equivalent over affected partitions."""

    input: Any
    partition_cols: tuple  # input column indices
    order_by: tuple  # ((col, desc), ...)
    funcs: tuple  # of MirWindowFunc
    nulls_last: Optional[tuple] = None


@dataclass(frozen=True)
class MirFlatMap:
    """Table function over each input row (reference: MirRelationExpr::FlatMap,
    src/expr/src/relation/mod.rs; rendered at compute/src/render/flat_map.rs).

    `func` = "generate_series"; `exprs` are (lo, hi, step) scalar exprs over
    the input row. Output = input columns ++ one series-value column; a row
    with count k fans out to k rows carrying its diff/time.
    """

    input: "MirExpr"
    func: str
    exprs: tuple = ()


@dataclass(frozen=True)
class MirNegate:
    input: Any


@dataclass(frozen=True)
class MirThreshold:
    input: Any


@dataclass(frozen=True)
class MirUnion:
    inputs: tuple


@dataclass(frozen=True)
class MirDistinct:
    input: Any


@dataclass(frozen=True)
class MirTemporalFilter:
    """Temporal filter: each row is valid while max(lowers) <= mz_now() <
    min(uppers); the operator schedules its own future retractions
    (reference: doc/developer/design/20210426_temporal_filters.md,
    extensions/temporal_bucket.rs)."""

    input: Any
    lowers: tuple  # ScalarExprs over input cols (validity start, inclusive)
    uppers: tuple  # ScalarExprs over input cols (validity end, exclusive)


@dataclass(frozen=True)
class MirLetRec:
    """WITH MUTUALLY RECURSIVE: bindings may reference each other (and
    themselves) via MirGet of their rec ids; evaluated to fixpoint per
    timestamp (reference: relation.rs LetRec + iterative PointStamp scopes,
    src/compute/src/render.rs:365)."""

    bindings: tuple  # ((rec_id, dtypes, MirExpr), ...)
    body: Any


MirExpr = Any


def arity(e: MirExpr) -> int:
    """Number of output columns."""
    if isinstance(e, MirConstant):
        return len(e.dtypes)
    if isinstance(e, MirGet):
        return e.arity
    if isinstance(e, MirMap):
        return arity(e.input) + len(e.exprs)
    if isinstance(e, MirFilter):
        return arity(e.input)
    if isinstance(e, MirProject):
        return len(e.outputs)
    if isinstance(e, MirJoin):
        return sum(arity(i) for i in e.inputs)
    if isinstance(e, MirReduce):
        return len(e.group_key) + len(e.aggregates)
    if isinstance(e, MirTopK):
        return arity(e.input)
    if isinstance(e, MirWindow):
        return arity(e.input) + len(e.funcs)
    if isinstance(e, (MirNegate, MirThreshold, MirDistinct)):
        return arity(e.input) if not isinstance(e, MirDistinct) else arity(e.input)
    if isinstance(e, MirUnion):
        return arity(e.inputs[0])
    if isinstance(e, MirLetRec):
        return arity(e.body)
    if isinstance(e, MirTemporalFilter):
        return arity(e.input)
    if isinstance(e, MirFlatMap):
        return arity(e.input) + 1
    raise TypeError(f"not a MirExpr: {e!r}")


def children(e: MirExpr) -> tuple:
    if isinstance(e, (MirConstant, MirGet)):
        return ()
    if isinstance(e, (MirMap, MirFilter, MirProject, MirReduce, MirTopK, MirWindow, MirNegate, MirThreshold, MirDistinct, MirTemporalFilter, MirFlatMap)):
        return (e.input,)
    if isinstance(e, (MirJoin, MirUnion)):
        return tuple(e.inputs)
    if isinstance(e, MirLetRec):
        return tuple(b[2] for b in e.bindings) + (e.body,)
    raise TypeError(f"not a MirExpr: {e!r}")


def collect_get_ids(e: MirExpr) -> set:
    """FREE MirGet ids of a tree (LetRec binding ids are bound, not free)."""
    if isinstance(e, MirGet):
        return {e.id}
    if isinstance(e, MirLetRec):
        bound = {b[0] for b in e.bindings}
        out: set = set()
        for _g, _d, b in e.bindings:
            out |= collect_get_ids(b)
        out |= collect_get_ids(e.body)
        return out - bound
    out = set()
    for k in children(e):
        out |= collect_get_ids(k)
    return out


def with_children(e: MirExpr, new: tuple) -> MirExpr:
    if isinstance(e, (MirConstant, MirGet)):
        return e
    if isinstance(e, (MirMap, MirFilter, MirProject, MirReduce, MirTopK, MirWindow, MirNegate, MirThreshold, MirDistinct, MirTemporalFilter, MirFlatMap)):
        return replace(e, input=new[0])
    if isinstance(e, (MirJoin, MirUnion)):
        return replace(e, inputs=tuple(new))
    if isinstance(e, MirLetRec):
        nb = tuple(
            (b[0], b[1], body) for b, body in zip(e.bindings, new[:-1])
        )
        return MirLetRec(nb, new[-1])
    raise TypeError(f"not a MirExpr: {e!r}")
