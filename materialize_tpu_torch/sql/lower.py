"""MIR → LIR lowering: produce a renderable DataflowDescription.

Counterpart of materialize_tpu/sql/lower.py: host Python, kept as a copy in the
port (which never imports the JAX package) and held to the same
behaviour by the port's tests.

The analogue of the reference's plan lowering
(src/compute-types/src/plan/lowering.rs:136): Map/Filter/Project chains fuse
into single MFPs, joins take their physical plan from the
JoinImplementation transform, reduces split into accumulable and
hierarchical parts (collation via a join of partial reduces, mirroring
ReducePlan::Collation, src/compute-types/src/plan/reduce.rs:386).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from ..dataflow import BuildDesc, DataflowDescription
from ..dataflow import plan as lir
from ..expr import relation as mir
from ..expr.linear import MapFilterProject, MfpBuilder, substitute_columns
from ..expr.scalar import CallBinary, CallUnary, Column, Literal
from ..ops.reduce import AggregateExpr
from ..ops.topk import TopKPlan
from ..transform import plan_join_implementation

I64 = np.dtype(np.int64)
F32 = np.dtype(np.float32)


class Lowerer:
    def __init__(self, dtypes_env: dict, mono_ids: set | None = None):
        self.env = dict(dtypes_env)
        self.mono_ids = set(mono_ids or ())

    # -- dtype inference ------------------------------------------------------
    def dtypes(self, e) -> tuple:
        if isinstance(e, mir.MirGet):
            return tuple(self.env[e.id])
        if isinstance(e, mir.MirConstant):
            return tuple(e.dtypes)
        if isinstance(e, mir.MirMap):
            base = list(self.dtypes(e.input))
            for ex in e.exprs:
                base.append(_expr_np_dtype(ex, base))
            return tuple(base)
        if isinstance(e, mir.MirFilter):
            return self.dtypes(e.input)
        if isinstance(e, mir.MirProject):
            base = self.dtypes(e.input)
            return tuple(base[i] for i in e.outputs)
        if isinstance(e, mir.MirJoin):
            out = []
            for i in e.inputs:
                out.extend(self.dtypes(i))
            return tuple(out)
        if isinstance(e, mir.MirReduce):
            base = self.dtypes(e.input)
            out = [base[i] for i in e.group_key]
            for a in e.aggregates:
                if a.func == "count":
                    out.append(I64)
                elif a.func in ("string_agg", "array_agg", "list_agg",
                                "jsonb_agg", "min_str", "max_str"):
                    out.append(I64)  # rendered string code
                else:
                    out.append(_expr_np_dtype(a.expr, list(base)))
            return tuple(out)
        if isinstance(e, mir.MirTopK):
            return self.dtypes(e.input)
        if isinstance(e, mir.MirWindow):
            base = self.dtypes(e.input)
            return tuple(base) + tuple(
                _window_out_dtype(f, base) for f in e.funcs
            )
        if isinstance(e, (mir.MirNegate, mir.MirThreshold, mir.MirDistinct)):
            return self.dtypes(e.input)
        if isinstance(e, mir.MirUnion):
            return self.dtypes(e.inputs[0])
        if isinstance(e, mir.MirLetRec):
            for gid, dts, _b in e.bindings:
                self.env[gid] = tuple(dts)
            return self.dtypes(e.body)
        if isinstance(e, mir.MirTemporalFilter):
            return self.dtypes(e.input)
        if isinstance(e, mir.MirFlatMap):
            return self.dtypes(e.input) + (I64,)
        raise TypeError(f"dtypes: {type(e).__name__}")

    # -- lowering -------------------------------------------------------------
    def lower(self, e):
        """MIR expr → LIR expr."""
        # fuse M/F/P chains into one MFP over the chain's base
        if isinstance(e, (mir.MirMap, mir.MirFilter, mir.MirProject)):
            chain = []
            base = e
            while isinstance(base, (mir.MirMap, mir.MirFilter, mir.MirProject)):
                chain.append(base)
                base = base.input
            b = MfpBuilder(mir.arity(base))
            for node in reversed(chain):
                if isinstance(node, mir.MirMap):
                    b.add_maps(node.exprs)
                elif isinstance(node, mir.MirFilter):
                    b.add_predicates(node.predicates)
                else:
                    b.project(node.outputs)
            mfp = b.finish()
            lowered = self.lower(base)
            if mfp.is_identity():
                return lowered
            return lir.Mfp(lowered, mfp)
        if isinstance(e, mir.MirGet):
            return lir.Get(e.id)
        if isinstance(e, mir.MirConstant):
            rows = tuple((data, 0, diff) for data, diff in e.rows)
            return lir.Constant(rows, tuple(e.dtypes))
        if isinstance(e, mir.MirJoin):
            impl = e.implementation or plan_join_implementation(e)
            inputs = tuple(self.lower(i) for i in e.inputs)
            # SQL equality never matches NULLs, but the in-band sentinel
            # representation would (sentinel == sentinel); guard every
            # equivalence column with IS NOT NULL in the join closure
            # (the reference's join planning likewise hoists non-null
            # constraints from equivalences, lowering.rs)
            guard_cols = (
                []
                if e.null_safe
                else sorted({g for cls in e.equivalences for g in cls})
            )

            def res_eq(a, c):
                if not e.null_safe:
                    return CallBinary("eq", Column(a), Column(c))
                # IS NOT DISTINCT FROM: NULL matches NULL in null-safe joins
                from ..expr.scalar import CallVariadic

                return CallVariadic(
                    "or",
                    (
                        CallBinary("eq", Column(a), Column(c)),
                        CallBinary(
                            "and",
                            CallUnary("is_null", Column(a)),
                            CallUnary("is_null", Column(c)),
                        ),
                    ),
                )

            preds = tuple(
                CallUnary("is_not_null", Column(c)) for c in guard_cols
            ) + tuple(
                res_eq(a, c) for a, c in impl.residual_equalities
            )
            closure = None
            if preds:
                total = sum(mir.arity(i) for i in e.inputs)
                b = MfpBuilder(total)
                b.add_predicates(preds)
                closure = b.finish()
            return lir.Join(inputs=inputs, plan=impl.lir_plan, closure=closure)
        if isinstance(e, mir.MirReduce):
            return self.lower_reduce(e)
        if isinstance(e, mir.MirTopK):
            from ..transform import is_monotonic

            return lir.TopK(
                self.lower(e.input),
                TopKPlan(
                    group_cols=tuple(e.group_key),
                    order_by=tuple(e.order_by),
                    limit=e.limit,
                    offset=e.offset,
                    nulls_last=e.nulls_last,
                ),
                monotonic=is_monotonic(e.input, self.mono_ids),
            )
        if isinstance(e, mir.MirWindow):
            from ..ops.window import WindowFuncSpec, WindowPlan

            base = self.dtypes(e.input)
            funcs = tuple(
                WindowFuncSpec(
                    func=f.func,
                    arg=f.arg,
                    offset=f.offset,
                    out_dtype=_window_out_dtype(f, base).name,
                )
                for f in e.funcs
            )
            return lir.Window(
                self.lower(e.input),
                WindowPlan(
                    partition_cols=tuple(e.partition_cols),
                    order_by=tuple(e.order_by),
                    funcs=funcs,
                    nulls_last=e.nulls_last,
                ),
            )
        if isinstance(e, mir.MirNegate):
            return lir.Negate(self.lower(e.input))
        if isinstance(e, mir.MirThreshold):
            return lir.Threshold(self.lower(e.input))
        if isinstance(e, mir.MirDistinct):
            n = mir.arity(e.input)
            return lir.Reduce(
                self.lower(e.input), key_cols=tuple(range(n)), distinct=True
            )
        if isinstance(e, mir.MirUnion):
            return lir.Union(tuple(self.lower(i) for i in e.inputs))
        if isinstance(e, mir.MirTemporalFilter):
            return lir.TemporalFilter(
                self.lower(e.input), tuple(e.lowers), tuple(e.uppers)
            )
        if isinstance(e, mir.MirFlatMap):
            return lir.FlatMap(self.lower(e.input), e.func, tuple(e.exprs))
        if isinstance(e, mir.MirLetRec):
            rec_ids = set()
            for gid, dts, _b in e.bindings:
                self.env[gid] = tuple(dts)
                rec_ids.add(gid)
            bindings = tuple(
                (gid, self.lower(b), tuple(dts)) for gid, dts, b in e.bindings
            )
            body = self.lower(e.body)
            refs = set()
            for _g, _d, b in e.bindings:
                refs |= mir.collect_get_ids(b)
            refs |= mir.collect_get_ids(e.body)
            ext = tuple(sorted(refs - rec_ids))
            return lir.LetRec(
                bindings=bindings,
                body=body,
                body_dtypes=self.dtypes(e.body),
                external_ids=ext,
                ext_dtypes=tuple((g, tuple(self.env[g])) for g in ext),
            )
        raise TypeError(f"lower: {type(e).__name__}")

    def lower_reduce(self, e: mir.MirReduce):
        result = self._lower_reduce_inner(e)
        if e.group_key or not e.aggregates:
            return result
        return self._with_default_row(result, e)

    def _with_default_row(self, result, e: mir.MirReduce):
        """Global (no GROUP BY) aggregates return one default row over empty
        input: count → 0, sum accumulators → 0 (the paired-count post guard
        turns them into NULL), min/max → the NULL sentinel directly. The
        reference's reduce lowering unions a default row minus an existence
        marker (lowering.rs empty-key pattern):

            result ∪ π_aggs(default − (default ⋈ marker))

        where marker is DISTINCT over a constant column of result (nonempty
        iff result is), so exactly one branch survives.
        """
        from ..expr.scalar import null_sentinel

        n = len(e.aggregates)
        out_dtypes = self.dtypes(e)
        defaults = tuple(
            null_sentinel(dt)
            if a.func in ("min", "max", "string_agg", "array_agg", "list_agg",
                          "jsonb_agg", "min_str", "max_str")
            else (0 if np.issubdtype(dt, np.integer) else np.float32(0.0))
            for a, dt in zip(e.aggregates, out_dtypes)
        )
        b = MfpBuilder(n)
        b.add_maps((Literal(1),))
        b.project((n,))
        marker = lir.Reduce(lir.Mfp(result, b.finish()), key_cols=(0,), distinct=True)
        default_marked = lir.Constant(
            rows=(((1,) + defaults, 0, 1),), dtypes=(I64,) + tuple(out_dtypes)
        )
        jb = MfpBuilder(2 + n)
        jb.project(tuple(range(1 + n)))
        joined = lir.Join(
            inputs=(default_marked, marker),
            plan=lir.LinearJoinPlan(
                stages=(lir.JoinStage(stream_key=(0,), lookup_key=(0,)),)
            ),
            closure=jb.finish(),
        )
        anti = lir.Union((default_marked, lir.Negate(joined)))
        db = MfpBuilder(1 + n)
        db.project(tuple(range(1, 1 + n)))
        return lir.Union((result, lir.Mfp(anti, db.finish())))

    def _lower_reduce_inner(self, e: mir.MirReduce):
        """Split aggregates into accumulable and hierarchical parts.

        Mirrors ReducePlan construction (plan/reduce.rs:130): Accumulable for
        sum/count, Hierarchical (top-1 kernel) for min/max, Collation (a join
        of the partial reduces on the group key) when mixed.
        """
        in_dtypes = list(self.dtypes(e.input))
        key = tuple(e.group_key)
        if not e.aggregates:
            return lir.Reduce(self.lower(e.input), key_cols=key, distinct=True)

        parts = []  # (agg_indices, lir builder fn)
        _BASIC = (
            "string_agg", "array_agg", "list_agg", "jsonb_agg",
            "min_str", "max_str",
        )
        acc_idx = [i for i, a in enumerate(e.aggregates) if a.func in ("sum", "count")]
        hier_idx = [i for i, a in enumerate(e.aggregates) if a.func in ("min", "max")]
        basic_idx = [i for i, a in enumerate(e.aggregates) if a.func in _BASIC]
        unknown = [
            a.func
            for a in e.aggregates
            if a.func not in ("sum", "count", "min", "max") + _BASIC
        ]
        if unknown:
            raise NotImplementedError(f"aggregates {unknown}")

        lowered_in = self.lower(e.input)

        def accumulable_part():
            aggs = []
            for i in acc_idx:
                a = e.aggregates[i]
                if a.func == "count":
                    # keep the argument: count(x) skips NULL inputs
                    aggs.append(AggregateExpr("count", a.expr))
                else:
                    dt = _expr_np_dtype(a.expr, in_dtypes)
                    if dt == F32:
                        # float sums accumulate in i64 fixed point so
                        # retractions cancel exactly (ops/reduce.py
                        # AggregateExpr docstring; reference Accum::Float)
                        from ..ops.reduce import FLOAT_FIXED_SCALE

                        aggs.append(
                            AggregateExpr(
                                "sum", a.expr, "int64",
                                fixed_scale=FLOAT_FIXED_SCALE,
                            )
                        )
                    else:
                        aggs.append(AggregateExpr("sum", a.expr, "int64"))
            return lir.Reduce(lowered_in, key_cols=key, aggs=tuple(aggs))

        def hierarchical_part(agg_i: int):
            a = e.aggregates[agg_i]
            n_in = len(in_dtypes)
            # materialize the agg expr as a column, top-1 it per group
            b = MfpBuilder(n_in)
            b.add_maps((a.expr,))
            b.project(tuple(key) + (n_in,))
            pre = lir.Mfp(lowered_in, b.finish())
            nk = len(key)
            from ..transform import is_monotonic

            topk = lir.TopK(
                pre,
                TopKPlan(
                    group_cols=tuple(range(nk)),
                    order_by=((nk, a.func == "max"),),
                    limit=1,
                    # NULL inputs never win min/max, but an all-NULL group
                    # still yields its (NULL) row (SQL aggregate semantics)
                    nulls_last=(True,),
                ),
                monotonic=is_monotonic(e.input, self.mono_ids),
            )
            return topk

        def basic_part(agg_i: int):
            # ReducePlan::Basic: materialize (keys, element) and hand the
            # multiset to the BasicAgg host operator (render/reduce.rs:196)
            a = e.aggregates[agg_i]
            n_in = len(in_dtypes)
            b = MfpBuilder(n_in)
            b.add_maps((a.expr,))
            b.project(tuple(key) + (n_in,))
            pre = lir.Mfp(lowered_in, b.finish())
            nk = len(key)
            return lir.BasicAgg(
                pre, key_cols=tuple(range(nk)), func=a.func, extra=a.extra
            )

        if acc_idx and not hier_idx and not basic_idx:
            return accumulable_part()
        if len(hier_idx) == 1 and not acc_idx and not basic_idx:
            return hierarchical_part(hier_idx[0])
        if len(basic_idx) == 1 and not acc_idx and not hier_idx:
            return basic_part(basic_idx[0])
        # collation: join partial reduces on the group key
        partials = []  # (lir expr, agg indices, out arity)
        if acc_idx:
            partials.append((accumulable_part(), acc_idx))
        for hi in hier_idx:
            partials.append((hierarchical_part(hi), [hi]))
        for bi in basic_idx:
            partials.append((basic_part(bi), [bi]))
        nk = len(key)
        # every partial outputs (key cols ++ its agg cols)
        stages = []
        arities = [nk + len(p[1]) for p in partials]
        for i in range(1, len(partials)):
            prior = sum(arities[:i])
            stages.append(
                lir.JoinStage(
                    stream_key=tuple(range(nk)),
                    lookup_key=tuple(range(nk)),
                )
            )
        # closure: project canonical (keys, aggs in declaration order)
        total = sum(arities)
        pos_of_agg: dict[int, int] = {}
        off = 0
        for part_expr, idxs in partials:
            for j, agg_i in enumerate(idxs):
                pos_of_agg[agg_i] = off + nk + j
            off += nk + len(idxs)
        proj = tuple(range(nk)) + tuple(
            pos_of_agg[i] for i in range(len(e.aggregates))
        )
        b = MfpBuilder(total)
        b.project(proj)
        return lir.Join(
            inputs=tuple(p[0] for p in partials),
            plan=lir.LinearJoinPlan(stages=tuple(stages)),
            closure=b.finish(),
        )


def _window_out_dtype(f, in_dtypes) -> np.dtype:
    """np dtype of one window function's output column."""
    if f.func in ("row_number", "rank", "dense_rank", "ntile", "count"):
        return I64
    dt = np.dtype(in_dtypes[f.arg])
    if dt == np.bool_:
        dt = np.dtype(np.int8)
    if f.func == "sum":
        return F32 if dt == F32 else I64
    return dt


def _expr_np_dtype(expr, col_dtypes):
    from ..dataflow.runtime import _expr_dtype

    return _expr_dtype(expr, col_dtypes)


def lower_to_dataflow(
    obj_id: str,
    mir_expr,
    dtypes_env: dict,
    source_ids: list[str],
    index_key: tuple = (),
    as_of: int = 0,
    mono_ids: set | None = None,
    until: int | None = None,
) -> DataflowDescription:
    """Build a one-object DataflowDescription for `mir_expr`."""
    lo = Lowerer(dtypes_env, mono_ids)
    plan = lo.lower(mir_expr)
    out_dtypes = lo.dtypes(mir_expr)
    return DataflowDescription(
        source_imports={sid: tuple(dtypes_env[sid]) for sid in source_ids},
        objects_to_build=[BuildDesc(obj_id, plan, out_dtypes)],
        index_exports={f"idx_{obj_id}": (obj_id, tuple(index_key))},
        as_of=as_of,
        until=until,
    )
