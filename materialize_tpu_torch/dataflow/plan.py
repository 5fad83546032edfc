"""LIR: the physical dataflow plan the renderer executes.

Counterpart of materialize_tpu/dataflow/plan.py, node for node: the
`RenderPlan` operator set (Constant, Get, Mfp, FlatMap, Join, Reduce, TopK,
Negate, Threshold, Union, ArrangeBy, and the nodes only the host runtime
renders) and `DataflowDescription`. Plans are host-side values; the fused
renderer (fused.py) turns a description into one tick of tensor operations.
Column dtypes are numpy dtypes, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..expr.linear import MapFilterProject
from ..ops.reduce import AggregateExpr
from ..ops.topk import TopKPlan

# ---------------------------------------------------------------------------
# plan expressions (one per LIR operator)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Constant:
    """Literal collection: rows as (data tuple, time, diff)."""

    rows: tuple
    dtypes: tuple  # np dtype per column


@dataclass(frozen=True)
class Get:
    """Reference a source import, an index import, or a previously-built object."""

    id: str


@dataclass(frozen=True)
class Mfp:
    input: Any
    mfp: MapFilterProject


@dataclass(frozen=True)
class FlatMap:
    """Table function application (unnest etc.); func is host-registered."""

    input: Any
    func: str
    exprs: tuple = ()


@dataclass(frozen=True)
class JoinStage:
    """One binary stage of a linear join chain.

    stream_key: column indices into the accumulated (left) row.
    lookup_key: column indices into the joined input's row.
    """

    stream_key: tuple[int, ...]
    lookup_key: tuple[int, ...]


@dataclass(frozen=True)
class LinearJoinPlan:
    """Binary join chain over inputs in order (reference: plan/join.rs linear).

    stages[i] joins the accumulated stream with inputs[i+1].
    """

    stages: tuple[JoinStage, ...]


@dataclass(frozen=True)
class DeltaPathStage:
    """One half-join lookup of a delta path (reference: delta_join.rs:51)."""

    other_input: int
    stream_key: tuple[int, ...]  # cols into the accumulated stream row
    lookup_key: tuple[int, ...]  # cols into the other input's row


@dataclass(frozen=True)
class DeltaJoinPlan:
    """One path per input; update streams flow through the other inputs'
    arrangements without new intermediate state (plan/join/delta_join.rs:10-17)."""

    paths: tuple[tuple[DeltaPathStage, ...], ...]
    # paths[k] starts from input k's delta; column order of the final output
    # is given by permute[k]: per-path projection to canonical column order
    permutations: tuple[tuple[int, ...], ...]


@dataclass(frozen=True)
class Join:
    inputs: tuple
    plan: Any  # LinearJoinPlan | DeltaJoinPlan
    closure: Optional[MapFilterProject] = None  # applied to concatenated rows


@dataclass(frozen=True)
class Reduce:
    """Accumulable (sum/count) and/or hierarchical (min/max) aggregates.

    Mirrors ReducePlan (src/compute-types/src/plan/reduce.rs:130); collation of
    mixed aggregate kinds is planned by the SQL layer as a join of reduces.
    """

    input: Any
    key_cols: tuple[int, ...]
    aggs: tuple[AggregateExpr, ...] = ()
    distinct: bool = False  # ReducePlan::Distinct


@dataclass(frozen=True, eq=False)
class BasicAgg:
    """ReducePlan::Basic — order-insensitive catch-all aggregates whose value
    is rendered from the group's full multiset of inputs (string_agg /
    array_agg / list_agg; reference render: compute/src/render/reduce.rs:196).

    Input rows are (key_cols…, element); output is (key_cols…, rendered i64
    string code). Elements are maintained host-side as per-group multisets
    (strings are host data in this engine — see expr/strings.py); each tick
    re-renders only the affected groups, emitting a retract/insert pair.
    `extra` = (delimiter | None, element argtype tag, StringDictionary)."""

    input: Any
    key_cols: tuple[int, ...]
    func: str  # string_agg | array_agg | list_agg
    extra: tuple


@dataclass(frozen=True)
class HierarchicalReduce:
    """MIN/MAX per group via the topk kernel (k=1 per aggregate)."""

    input: Any
    key_cols: tuple[int, ...]
    agg_col: int
    is_max: bool


@dataclass(frozen=True)
class TopK:
    input: Any
    plan: TopKPlan
    monotonic: bool = False  # append-only input: keep only current winners


@dataclass(frozen=True)
class Window:
    """Window functions over partitions (ops/window.py): output = input row
    columns ++ one column per plan.funcs entry. The reference plans window
    functions as reduce-based whole-group recomputation
    (src/expr/src/relation/func.rs:1963); here the recompute is a batched
    affected-partition kernel."""

    input: Any
    plan: Any  # ops.window.WindowPlan


@dataclass(frozen=True)
class Negate:
    input: Any


@dataclass(frozen=True)
class Threshold:
    input: Any


@dataclass(frozen=True)
class Union:
    inputs: tuple


@dataclass(frozen=True)
class ArrangeBy:
    input: Any
    key_cols: tuple[int, ...]


@dataclass(frozen=True)
class TemporalFilter:
    """Validity-window filter: emit +row at window start, schedule -row at
    window end (reference: temporal filters design doc; the pending queue is
    the temporal-bucketing analogue, extensions/temporal_bucket.rs)."""

    input: Any
    lowers: tuple
    uppers: tuple


@dataclass(frozen=True)
class LetRec:
    """Iterative scope: bindings reference each other via Get(rec_id) and are
    iterated to fixpoint within each outer tick (reference: render.rs:887
    render_recursive_plan over PointStamp scopes; here the inner dataflow's
    private timestamp IS the iteration counter)."""

    bindings: tuple  # ((rec_id, plan, dtypes), ...)
    body: Any
    body_dtypes: tuple
    external_ids: tuple  # outer collections the scope reads
    ext_dtypes: tuple  # ((id, dtypes), ...) aligned with external_ids
    max_iters: int = 100


# ---------------------------------------------------------------------------
# dataflow description
# ---------------------------------------------------------------------------


@dataclass
class BuildDesc:
    id: str
    plan: Any
    dtypes: tuple  # output column dtypes


@dataclass
class DataflowDescription:
    """What to build: mirrors dataflows.rs:32 (source_imports, objects_to_build,
    index_exports, sink_exports, as_of)."""

    source_imports: dict  # id -> RelationDesc/dtypes
    objects_to_build: list  # list[BuildDesc] in dependency order
    index_exports: dict  # index id -> (object id, key_cols)
    sink_exports: dict = field(default_factory=dict)  # sink id -> object id
    as_of: int = 0
    # outputs at times >= until are not needed (None = unbounded); one-shot
    # peek dataflows set until = as_of + 1 (reference dataflows.rs:54-74)
    until: int | None = None
