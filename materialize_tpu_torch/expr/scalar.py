"""Scalar expressions evaluated columnwise, with SQL NULLs.

Counterpart of materialize_tpu/expr/scalar.py, for the functions that Q3
and the auction views use: `eq`, `lt`, `gt`, `sub` and `mul`. The rest of
the function library, and the string functions (`DictFunc`), come with
later slices.

NULL is in-band: a per-dtype sentinel stored in the column itself
(INT64_MIN, INT32_MIN, -128, NaN). Evaluation derives a null mask at each
Column reference, threads (value, null, err) triples through the tree and
re-materializes the sentinel at output boundaries (`force_sentinel`).
Errors never fire on NULL rows.

A Literal is materialized as a full tensor of its declared dtype (int64 by
default), never as a Python scalar: an int32 column minus an int64 literal
must give int64, as it does in the reference.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

NULL_I64 = int(np.iinfo(np.int64).min)
NULL_I32 = int(np.iinfo(np.int32).min)
NULL_I8 = -128

_TORCH_DTYPES = {
    "int64": torch.int64,
    "int32": torch.int32,
    "int8": torch.int8,
    "bool": torch.int8,  # booleans store as int8
    "float32": torch.float32,
    "float64": torch.float64,
}


def null_sentinel(dtype: torch.dtype):
    """The in-band NULL value for a storage dtype."""
    if dtype == torch.int64:
        return NULL_I64
    if dtype == torch.int32:
        return NULL_I32
    if dtype in (torch.int8, torch.bool):
        return NULL_I8
    if dtype.is_floating_point:
        return float("nan")
    raise TypeError(f"no null sentinel for {dtype}")


def derived_null(col: torch.Tensor) -> torch.Tensor:
    """Null mask derived from a stored column's sentinel values."""
    if col.dtype.is_floating_point:
        return torch.isnan(col)
    if col.dtype == torch.bool:
        return torch.zeros_like(col)
    return col == null_sentinel(col.dtype)


def force_sentinel(col: torch.Tensor, null: torch.Tensor) -> torch.Tensor:
    """Write the dtype sentinel wherever `null`."""
    if col.dtype == torch.bool:
        return col
    return torch.where(null, torch.full_like(col, null_sentinel(col.dtype)), col)


class EvalErr(enum.IntEnum):
    """Per-row evaluation error codes (0 = no error), as in the reference."""

    NONE = 0
    DIVISION_BY_ZERO = 1
    NUMERIC_OVERFLOW = 2
    HASH_COLLISION_EXHAUSTED = 3
    STRING_CODE_OOB = 4
    NEGATIVE_FUNC_ARG = 5
    STEP_ZERO = 6


@dataclass(frozen=True)
class Column:
    """Reference to input column `index` (after maps: index into input+maps)."""

    index: int


@dataclass(frozen=True)
class Literal:
    value: Any
    dtype: str = "int64"  # numpy dtype name


@dataclass(frozen=True)
class CallBinary:
    func: str  # eq | lt | gt | sub | mul
    left: Any
    right: Any


def _truth(v: torch.Tensor) -> torch.Tensor:
    """Boolean view of a stored truth value (int8 {0,1} or bool)."""
    return v.to(torch.bool)


def _as_bool_i8(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int8)


def eval_expr3(expr, cols: list, n: int):
    """Three-valued evaluation: (value[n], null[n] bool, err[n] int32).

    Values under a set null bit are unspecified until `force_sentinel`.
    Boolean results are int8 {0,1}.
    """
    dev = cols[0].device
    zero_err = torch.zeros((n,), dtype=torch.int32, device=dev)
    no_null = torch.zeros((n,), dtype=torch.bool, device=dev)
    if isinstance(expr, Column):
        v = cols[expr.index]
        return v, derived_null(v), zero_err
    if isinstance(expr, Literal):
        dt = _TORCH_DTYPES[np.dtype(expr.dtype).name]
        if expr.value is None:
            return (
                torch.full((n,), null_sentinel(dt), dtype=dt, device=dev),
                torch.ones((n,), dtype=torch.bool, device=dev),
                zero_err,
            )
        value = int(bool(expr.value)) if np.dtype(expr.dtype) == np.bool_ else expr.value
        return torch.full((n,), value, dtype=dt, device=dev), no_null, zero_err
    if isinstance(expr, CallBinary):
        f = expr.func
        lv, ln, le = eval_expr3(expr.left, cols, n)
        rv, rn, re_ = eval_expr3(expr.right, cols, n)
        null = ln | rn
        err = torch.where(null, zero_err, torch.maximum(le, re_))
        if f == "sub":
            return lv - rv, null, err
        if f == "mul":
            return lv * rv, null, err
        if f == "eq":
            return _as_bool_i8(lv == rv), null, err
        if f == "lt":
            return _as_bool_i8(lv < rv), null, err
        if f == "gt":
            return _as_bool_i8(lv > rv), null, err
        raise NotImplementedError(f"binary func {f}")
    raise NotImplementedError(f"expression {expr!r}")


def expr_has_dictfunc(expr) -> bool:
    """True if the expression tree contains a string-dictionary function
    (host-path only). The port has no such function yet (they come with
    `expr/strings.py`), so this walks the port's node types and finds none."""
    if isinstance(expr, CallBinary):
        return expr_has_dictfunc(expr.left) or expr_has_dictfunc(expr.right)
    return False
