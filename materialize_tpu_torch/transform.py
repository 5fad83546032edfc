"""The MIR optimizer: join implementation planning, monotonicity and the
optimize pass pipeline.

Counterpart of the reference package materialize_tpu/transform/ (its
join_implementation.py, monotonic.py and optimize.py, one module here):
host Python, kept as a copy in the port (which never imports the JAX
package) and held to the same behaviour by the port's tests.

-- join_implementation --
The analogue of the reference's `JoinImplementation` transform
(src/transform/src/join_implementation.rs): given an N-way MirJoin with
equivalence classes over the flat column space, pick

- **linear** (binary chain arranging intermediates — differential
  `join_core`, linear_join.rs) for 2 inputs, or
- **delta** (one update path per input, no intermediate arrangements —
  delta_join.rs) for 3+ inputs,

and derive per-stage stream/lookup keys by walking the equivalence graph in
input order. Equality members not consumed as lookup keys are re-asserted as
residual closure predicates (correct even when classes span 3+ columns).

-- monotonic --
The analogue of the reference's monotonic analysis
(src/transform/src/monotonic.rs), which unlocks the Monotonic top-k/min/max
render plans (plan/top_k.rs MonotonicTop1/TopK, reduce.rs ReductionMonoid):
append-only collections never retract, so a top-k needs to remember only its
current winners, not the whole input.

-- optimize --
A compact analogue of the reference's `mz-transform` logical/physical
pipelines (src/transform/src/lib.rs:752,822). Passes implemented:

- fuse_filters / fuse_maps / fuse_projects: canonicalize M/F/P chains
- predicate_pushdown: push filters toward sources (through Map/Project/Union)
- fold_constants (literal predicates)
- join_implementation: attach physical join plans (above)

Projection pushdown (Demand), EquivalencePropagation, ReductionPushdown and
monotonic analysis are future rounds' work; the pass list shape mirrors the
reference so they slot in.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .dataflow import plan as lir
from .expr import relation as mir
from .expr.linear import substitute_columns
from .expr.scalar import CallBinary, Column, Literal



@dataclass(frozen=True)
class JoinPlanned:
    """Physical join choice attached to MirJoin.implementation."""

    kind: str  # "linear" | "delta"
    lir_plan: object  # lir.LinearJoinPlan | lir.DeltaJoinPlan
    input_order: tuple  # for linear: order in which inputs are chained
    residual_equalities: tuple  # ((global_col_a, global_col_b), ...)


def _offsets(arities):
    out, off = [], 0
    for a in arities:
        out.append(off)
        off += a
    return out


def plan_join_implementation(
    join: mir.MirJoin, enable_delta: bool = True, max_delta_inputs: int = 6
) -> JoinPlanned:
    arities = [mir.arity(i) for i in join.inputs]
    offsets = _offsets(arities)
    n = len(join.inputs)

    def owner(gcol: int) -> int:
        for k in range(n - 1, -1, -1):
            if gcol >= offsets[k]:
                return k
        return 0

    def local(gcol: int) -> int:
        return gcol - offsets[owner(gcol)]

    # equivalence classes as {input: [local cols]}
    classes = []
    for cls in join.equivalences:
        bymem: dict[int, list[int]] = {}
        for g in cls:
            bymem.setdefault(owner(g), []).append(local(g))
        classes.append((cls, bymem))

    def stage_keys(done: set[int], nxt: int, stream_cols: list):
        """Keys joining `nxt` to the accumulated inputs in `done`.

        stream_cols: list of (input, local) in current stream order.
        Returns (stream_key, lookup_key, used_class_idxs).
        """
        skey, lkey, used = [], [], []
        for ci, (_cls, bymem) in enumerate(classes):
            if nxt not in bymem:
                continue
            stream_side = None
            for inp in done:
                if inp in bymem:
                    stream_side = (inp, bymem[inp][0])
                    break
            if stream_side is None:
                continue
            skey.append(stream_cols.index(stream_side))
            lkey.append(bymem[nxt][0])
            used.append(ci)
        return tuple(skey), tuple(lkey), used

    def next_input(done: set[int]) -> int:
        # prefer an input connected to what's done; fall back to input order
        for k in range(n):
            if k in done:
                continue
            for _cls, bymem in classes:
                if k in bymem and any(d in bymem for d in done):
                    return k
        for k in range(n):
            if k not in done:
                return k
        raise AssertionError("no next input")

    residuals = []
    for cls, bymem in classes:
        members = sorted(cls)
        for m in members[1:]:
            residuals.append((members[0], m))
    # residuals re-assert full class equality; the used lookup keys make most
    # of them tautological, which the closure MFP evaluates cheaply.

    if n == 2:
        done = {0}
        stream_cols = [(0, j) for j in range(arities[0])]
        skey, lkey, _ = stage_keys(done, 1, stream_cols)
        plan = lir.LinearJoinPlan(stages=(lir.JoinStage(skey, lkey),))
        return JoinPlanned("linear", plan, (0, 1), tuple(residuals))

    if n > max_delta_inputs or not enable_delta:
        # very wide joins (or delta joins disabled by dyncfg): chain linearly
        # in input order (delta paths grow O(n^2) lookups; reference caps
        # delta breadth similarly and has tested 64-relation linear chains,
        # README.md:46)
        stages = []
        done = {0}
        stream_cols = [(0, j) for j in range(arities[0])]
        for nxt in range(1, n):
            skey, lkey, _ = stage_keys(done, nxt, stream_cols)
            stages.append(lir.JoinStage(skey, lkey))
            stream_cols += [(nxt, j) for j in range(arities[nxt])]
            done.add(nxt)
        plan = lir.LinearJoinPlan(stages=tuple(stages))
        return JoinPlanned("linear", plan, tuple(range(n)), tuple(residuals))

    # delta join: one path per input
    paths, perms = [], []
    canonical = [(k, j) for k in range(n) for j in range(arities[k])]
    for k in range(n):
        done = {k}
        stream_cols = [(k, j) for j in range(arities[k])]
        path = []
        for _ in range(n - 1):
            nxt = next_input(done)
            skey, lkey, _ = stage_keys(done, nxt, stream_cols)
            path.append(
                lir.DeltaPathStage(other_input=nxt, stream_key=skey, lookup_key=lkey)
            )
            stream_cols += [(nxt, j) for j in range(arities[nxt])]
            done.add(nxt)
        paths.append(tuple(path))
        perms.append(tuple(stream_cols.index(c) for c in canonical))
    plan = lir.DeltaJoinPlan(paths=tuple(paths), permutations=tuple(perms))
    return JoinPlanned("delta", plan, tuple(range(n)), tuple(residuals))


# -- monotonicity ------------------------------------------------------------


def is_monotonic(e, mono_ids: set) -> bool:
    """True if the collection only ever receives additions (diff > 0)."""
    if isinstance(e, mir.MirGet):
        return e.id in mono_ids
    if isinstance(e, mir.MirConstant):
        return all(d > 0 for _row, d in e.rows)
    if isinstance(e, (mir.MirMap, mir.MirFilter, mir.MirProject)):
        return is_monotonic(e.input, mono_ids)
    if isinstance(e, mir.MirJoin):
        return all(is_monotonic(i, mono_ids) for i in e.inputs)
    if isinstance(e, mir.MirUnion):
        return all(is_monotonic(i, mono_ids) for i in e.inputs)
    if isinstance(e, (mir.MirDistinct, mir.MirThreshold)):
        # distinct/threshold over additions only ever add
        return is_monotonic(e.input, mono_ids)
    if isinstance(e, mir.MirTemporalFilter):
        # upper bounds schedule retractions; lower-bound-only stays monotonic
        return not e.uppers and is_monotonic(e.input, mono_ids)
    if isinstance(e, mir.MirFlatMap):
        # fan-out preserves the sign of diffs
        return is_monotonic(e.input, mono_ids)
    # Reduce/TopK/Negate/LetRec outputs can retract
    return False


# -- the optimizer ----------------------------------------------------------


def _map_tree(e, f):
    """Bottom-up rewrite."""
    kids = mir.children(e)
    if kids:
        e = mir.with_children(e, tuple(_map_tree(k, f) for k in kids))
    return f(e)


def fuse(e):
    """Merge adjacent Filters and Maps; drop identity Projects."""

    def go(n):
        if isinstance(n, mir.MirFilter) and isinstance(n.input, mir.MirFilter):
            return mir.MirFilter(n.input.input, n.input.predicates + n.predicates)
        if isinstance(n, mir.MirMap) and isinstance(n.input, mir.MirMap):
            return mir.MirMap(n.input.input, n.input.exprs + n.exprs)
        if isinstance(n, mir.MirProject):
            if n.outputs == tuple(range(mir.arity(n.input))):
                return n.input
            if isinstance(n.input, mir.MirProject):
                return mir.MirProject(
                    n.input.input, tuple(n.input.outputs[i] for i in n.outputs)
                )
            if isinstance(n.input, mir.MirMap):
                # Project over Map whose referenced maps are pure column
                # copies → project the underlying columns directly (makes
                # `SELECT * FROM mv` a bare Get for the peek fast path)
                base_arity = mir.arity(n.input.input)
                new_out = []
                for i in n.outputs:
                    if i < base_arity:
                        new_out.append(i)
                    else:
                        ex = n.input.exprs[i - base_arity]
                        if isinstance(ex, Column) and ex.index < base_arity:
                            new_out.append(ex.index)
                        else:
                            return n
                return mir.MirProject(n.input.input, tuple(new_out))
        if isinstance(n, mir.MirUnion):
            flat = []
            for i in n.inputs:
                if isinstance(i, mir.MirUnion):
                    flat.extend(i.inputs)
                else:
                    flat.append(i)
            if len(flat) != len(n.inputs):
                return mir.MirUnion(tuple(flat))
        return n

    return _map_tree(e, go)


def predicate_pushdown(e):
    """Push Filter below Map / Project / Union when its columns allow."""

    def go(n):
        if not isinstance(n, mir.MirFilter):
            return n
        inp = n.input
        if isinstance(inp, mir.MirMap):
            in_arity = mir.arity(inp.input)
            below, above = [], []
            for p in n.predicates:
                from .expr.scalar import expr_columns

                if all(c < in_arity for c in expr_columns(p)):
                    below.append(p)
                else:
                    above.append(p)
            if below:
                pushed = mir.MirMap(
                    mir.MirFilter(inp.input, tuple(below)), inp.exprs
                )
                return mir.MirFilter(pushed, tuple(above)) if above else pushed
        if isinstance(inp, mir.MirProject):
            mapping = {i: c for i, c in enumerate(inp.outputs)}
            pushed = tuple(substitute_columns(p, mapping) for p in n.predicates)
            return mir.MirProject(
                mir.MirFilter(inp.input, pushed), inp.outputs
            )
        if isinstance(inp, mir.MirUnion):
            return mir.MirUnion(
                tuple(mir.MirFilter(i, n.predicates) for i in inp.inputs)
            )
        return n

    return _map_tree(e, go)


def demand(e):
    """Demand analysis (the reference's Demand transform,
    src/transform/src/demand.rs): map expressions whose output column no
    consumer reads are replaced with a dummy literal, so their (possibly
    expensive — string tables, window math) evaluation is skipped. Arity is
    preserved (the reference uses the same dummy trick), so no index
    remapping ripples through parents.

    Propagation is top-down through the column-stable nodes; Join/Reduce/
    TopK/FlatMap/Window conservatively demand everything below them.
    """
    from .expr.scalar import expr_columns

    def go(n, needed):
        # needed: set of demanded output columns, or None = all
        if isinstance(n, mir.MirProject):
            # a projection narrows demand even at the root (needed=None means
            # "all MY outputs", which is still only the projected columns)
            idx = range(len(n.outputs)) if needed is None else needed
            child_needed = {n.outputs[i] for i in idx if i < len(n.outputs)}
            return mir.MirProject(go(n.input, child_needed), n.outputs)
        if isinstance(n, mir.MirMap):
            base = mir.arity(n.input)
            nmaps = len(n.exprs)
            if needed is None:
                keep = set(range(base + nmaps))
            else:
                keep = set(needed)
            # transitive demand: a kept map's references are demanded too
            changed = True
            while changed:
                changed = False
                for j in range(nmaps - 1, -1, -1):
                    if base + j in keep:
                        for c in expr_columns(n.exprs[j]):
                            if c not in keep:
                                keep.add(c)
                                changed = True
            new_exprs = tuple(
                ex if base + j in keep else Literal(0)
                for j, ex in enumerate(n.exprs)
            )
            child_needed = {c for c in keep if c < base}
            return mir.MirMap(go(n.input, child_needed), new_exprs)
        if isinstance(n, mir.MirFilter):
            base = mir.arity(n.input)
            child_needed = None
            if needed is not None:
                child_needed = set(needed)
                for p in n.predicates:
                    child_needed |= {c for c in expr_columns(p) if c < base}
            return mir.MirFilter(go(n.input, child_needed), n.predicates)
        if isinstance(n, mir.MirUnion):
            # a dummy changes the column's dtype; union branches must concat
            # with IDENTICAL dtypes, so no dummies below a union
            return mir.MirUnion(tuple(go(i, None) for i in n.inputs))
        if isinstance(n, mir.MirNegate):
            # sign flip is per-row-linear: merging dummy-equal rows is
            # observation-equivalent, so demand passes through
            return replace(n, input=go(n.input, needed))
        if isinstance(n, mir.MirThreshold):
            # threshold depends on FULL-row multiplicities: dummying an
            # unread column could merge rows whose counts must stay separate
            # (demand.rs likewise demands all columns here)
            return replace(n, input=go(n.input, None))
        # everything else (Join, Reduce, TopK, Window, Distinct, FlatMap,
        # TemporalFilter, LetRec, leaves): demand everything below
        kids = mir.children(n)
        if kids:
            n = mir.with_children(n, tuple(go(k, None) for k in kids))
        return n

    return go(e, None)


def simplify_algebraic(e):
    """Local algebraic identities (reference: canonicalization transforms):
    Negate(Negate(x)) → x, Distinct(Distinct(x)) → Distinct(x),
    Threshold(Threshold(x)) → Threshold(x), Distinct over a Reduce keyed on
    every output column → the Reduce (its keys are already unique),
    single-input Union → the input."""

    def go(n):
        if isinstance(n, mir.MirNegate) and isinstance(n.input, mir.MirNegate):
            return n.input.input
        if isinstance(n, mir.MirDistinct) and isinstance(n.input, mir.MirDistinct):
            return n.input
        if isinstance(n, mir.MirThreshold) and isinstance(
            n.input, mir.MirThreshold
        ):
            return n.input
        if isinstance(n, mir.MirDistinct) and isinstance(n.input, mir.MirReduce):
            r = n.input
            if not r.aggregates and len(r.group_key) == mir.arity(r):
                return r
        if isinstance(n, mir.MirUnion) and len(n.inputs) == 1:
            return n.inputs[0]
        return n

    return _map_tree(e, go)


def fold_constants(e):
    """Remove always-true literal predicates; empty always-false branches."""

    def go(n):
        if isinstance(n, mir.MirFilter):
            preds = [
                p
                for p in n.predicates
                if not (isinstance(p, Literal) and bool(p.value))
            ]
            if not preds:
                return n.input
            if len(preds) != len(n.predicates):
                return mir.MirFilter(n.input, tuple(preds))
        return n

    return _map_tree(e, go)


def attach_join_plans(e, configs=None):
    enable_delta = True
    max_inputs = 6
    if configs is not None:
        enable_delta = bool(configs.get("enable_delta_join"))
        max_inputs = int(configs.get("delta_join_max_inputs"))

    def go(n):
        if isinstance(n, mir.MirJoin) and n.implementation is None:
            return replace(
                n,
                implementation=plan_join_implementation(
                    n, enable_delta=enable_delta, max_delta_inputs=max_inputs
                ),
            )
        return n

    return _map_tree(e, go)


def optimize(e, configs=None):
    """The logical+physical pipeline (reference: logical_optimizer lib.rs:752
    then physical_optimizer lib.rs:822, much abbreviated). `configs` is the
    dyncfg ConfigSet gating optimizer choices (lib.rs:580 conditional
    transforms)."""
    e = fuse(e)
    e = predicate_pushdown(e)
    e = fuse(e)
    e = simplify_algebraic(e)
    e = fold_constants(e)
    e = demand(e)
    e = attach_join_plans(e, configs)
    return e
