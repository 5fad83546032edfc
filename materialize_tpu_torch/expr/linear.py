"""MapFilterProject: the fused row-level operator.

Counterpart of materialize_tpu/expr/linear.py (`MapFilterProject.apply`).
Appended map expressions, a conjunction of predicates, then a projection,
evaluated columnwise over a batch. Filtered rows keep their slot with
diff 0; erroring rows go to a parallel error batch instead of trapping.
`MfpBuilder` fuses a chain of Map/Filter/Project steps into one MFP (the
SQL lowering and the coordinator's fast-path peeks use it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..repr.batch import PAD_TIME, UpdateBatch
from ..repr.hashing import PAD_HASH
from .scalar import (
    CallBinary,
    CallUnary,
    CallVariadic,
    Column,
    DictFunc,
    Literal,
    ScalarExpr,
    _truth,
    eval_expr3,
    force_sentinel,
)


def _pad(mask: torch.Tensor, col: torch.Tensor, fill) -> torch.Tensor:
    return torch.where(mask, col, torch.full_like(col, fill))


def substitute_columns(e: ScalarExpr, mapping) -> ScalarExpr:
    """Rewrite Column indices through `mapping` (list or dict)."""
    if isinstance(e, Column):
        return Column(mapping[e.index])
    if isinstance(e, Literal):
        return e
    if isinstance(e, CallUnary):
        return CallUnary(e.func, substitute_columns(e.expr, mapping))
    if isinstance(e, CallBinary):
        return CallBinary(
            e.func,
            substitute_columns(e.left, mapping),
            substitute_columns(e.right, mapping),
        )
    if isinstance(e, CallVariadic):
        return CallVariadic(
            e.func, tuple(substitute_columns(x, mapping) for x in e.exprs)
        )
    if isinstance(e, DictFunc):
        return DictFunc(
            e.spec,
            tuple(substitute_columns(x, mapping) for x in e.args),
            e.argtypes,
            e.out,
            e.tables,
        )
    raise TypeError(f"not a ScalarExpr: {e!r}")


class MfpBuilder:
    """Incrementally fuse Map/Filter/Project steps into one MapFilterProject.

    Tracks the current output→storage column mapping so later expressions are
    rewritten into the flat (input ++ maps) column space, mirroring the
    reference's MapFilterProject builder (src/expr/src/linear.rs:45).
    """

    def __init__(self, input_arity: int):
        self.input_arity = input_arity
        self.maps: list = []
        self.predicates: list = []
        self.proj: list[int] = list(range(input_arity))

    def add_maps(self, exprs) -> None:
        for e in exprs:
            remapped = substitute_columns(e, self.proj)
            self.maps.append(remapped)
            self.proj.append(self.input_arity + len(self.maps) - 1)

    def add_predicates(self, exprs) -> None:
        for e in exprs:
            self.predicates.append(substitute_columns(e, self.proj))

    def project(self, outputs) -> None:
        self.proj = [self.proj[i] for i in outputs]

    def absorb(self, mfp: "MapFilterProject") -> None:
        self.add_maps(mfp.map_exprs)
        self.add_predicates(mfp.predicates)
        if mfp.projection is not None:
            self.project(mfp.projection)

    def finish(self) -> "MapFilterProject":
        return MapFilterProject(
            self.input_arity,
            tuple(self.maps),
            tuple(self.predicates),
            tuple(self.proj),
        )


@dataclass(frozen=True)
class MapFilterProject:
    input_arity: int
    map_exprs: tuple = ()  # appended columns, may reference earlier maps
    predicates: tuple = ()  # conjunction; references input+map columns
    projection: tuple | None = None  # output col indices; None = identity

    @staticmethod
    def identity(arity: int) -> "MapFilterProject":
        return MapFilterProject(arity)

    @property
    def output_arity(self) -> int:
        if self.projection is not None:
            return len(self.projection)
        return self.input_arity + len(self.map_exprs)

    def is_identity(self) -> bool:
        return (
            not self.map_exprs
            and not self.predicates
            and (
                self.projection is None
                or tuple(self.projection) == tuple(range(self.input_arity))
            )
        )

    def apply(self, batch: UpdateBatch) -> tuple[UpdateBatch, UpdateBatch]:
        """Evaluate on a batch; returns (oks, errs).

        errs has vals=(err_code,) and inherits time/diff from the failing
        rows; rows without error are inert there (diff 0).
        """
        cols = list(batch.vals)
        n = batch.cap
        dev = batch.device
        map_err = torch.zeros((n,), dtype=torch.int32, device=dev)
        for e in self.map_exprs:
            v, nv, ev = eval_expr3(e, cols, n)
            map_err = torch.maximum(map_err, ev)
            cols.append(force_sentinel(v, nv))

        keep = torch.ones((n,), dtype=torch.bool, device=dev)
        pred_err = torch.zeros((n,), dtype=torch.int32, device=dev)
        for p in self.predicates:
            v, nv, ev = eval_expr3(p, cols, n)
            pred_err = torch.maximum(pred_err, ev)
            # WHERE keeps TRUE rows: NULL filters like FALSE; an erroring
            # predicate does not filter (the row errors instead)
            keep = keep & ((_truth(v) & ~nv) | (ev != 0))

        # a row only errors if it would otherwise survive the filters
        err = torch.where(keep, torch.maximum(map_err, pred_err), 0)
        live = batch.live
        err = torch.where(live, err, 0)  # padding can't error
        ok_mask = keep & (err == 0)

        out_cols = cols if self.projection is None else [cols[i] for i in self.projection]
        oks = UpdateBatch(
            hashes=_pad(ok_mask & live, batch.hashes, PAD_HASH),
            keys=(),
            vals=tuple(out_cols),
            times=_pad(ok_mask & live, batch.times, PAD_TIME),
            diffs=_pad(ok_mask, batch.diffs, 0),
        )
        err_mask = err != 0
        errs = UpdateBatch(
            hashes=torch.where(err_mask, torch.zeros_like(batch.hashes), PAD_HASH),
            keys=(),
            vals=(err.to(torch.int64),),
            times=_pad(err_mask, batch.times, PAD_TIME),
            diffs=_pad(err_mask, batch.diffs, 0),
        )
        return oks, errs
