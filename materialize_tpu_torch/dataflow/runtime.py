"""Helpers of the dataflow runtime that the fused renderer shares.

Counterpart of parts of materialize_tpu/dataflow/runtime.py: the error
stream's dtypes, the canonical peek order and its expansion
(`materialize_counts`), the peek error message, byte accounting of batches
and accumulator tables, and the static dtype of a scalar expression. The
host-orchestrated `Dataflow` and `render_dataflow` come with the host
runtime.
"""

from __future__ import annotations

import numpy as np

ERR_DTYPES = (np.dtype(np.int64),)


# -- arrangement byte accounting -----------------------------------------------


def batch_nbytes(b) -> int:
    n = 0
    for attr in ("hashes", "times", "diffs"):
        v = getattr(b, attr, None)
        if v is not None:
            n += int(getattr(v, "nbytes", 0))
    for attr in ("keys", "vals"):
        for col in getattr(b, attr, ()) or ():
            n += int(getattr(col, "nbytes", 0))
    return n


def arrangement_nbytes(arr) -> int:
    return sum(batch_nbytes(b) for b in arr.batches)


def accum_state_nbytes(st) -> int:
    n = 0
    for attr in ("hashes", "times"):
        v = getattr(st, attr, None)
        if v is not None:
            n += int(getattr(v, "nbytes", 0))
    for attr in ("keys", "accums", "vals"):
        for col in getattr(st, attr, ()) or ():
            n += int(getattr(col, "nbytes", 0))
    return n


# -- peeks -------------------------------------------------------------------------


def peek_row_key(row: tuple) -> tuple:
    """The canonical peek output order (NULLs last in each column)."""
    return tuple((v is None, 0 if v is None else v) for v in row)


def row_bytes_estimate(data: tuple) -> int:
    """Rough wire size of one result row, the unit of max_result_size
    budgets: tuple overhead + 8 B a column, plus the payload of string and
    bytes values."""
    n = 16 + 8 * len(data)
    for v in data:
        if isinstance(v, (str, bytes)):
            n += len(v)
    return n


def materialize_counts(acc: dict, label: str, byte_budget: int | None = None) -> list[tuple]:
    """Expand {row: multiplicity} into rows in peek order. A negative
    multiplicity means upstream inconsistency and raises. `byte_budget`
    bounds the expansion itself: past it, ResultSizeExceeded (53400) is
    raised mid-expansion, before the whole result exists."""
    from ..errors import ResultSizeExceeded

    rows: list[tuple] = []
    spent = 0
    for data, cnt in sorted(acc.items(), key=lambda kv: peek_row_key(kv[0])):
        if cnt < 0:
            raise RuntimeError(f"peek {label}: negative multiplicity {cnt} for {data}")
        if byte_budget is not None and cnt:
            spent += row_bytes_estimate(data) * cnt
            if spent > byte_budget:
                raise ResultSizeExceeded(
                    f"result exceeds max_result_size ({byte_budget} bytes); "
                    f"aborted after ~{len(rows)} rows"
                )
        rows.extend([data] * cnt)
    return rows


def peek_error_message(index_id: str, acc: dict) -> str:
    """Message for a non-empty error collection: the EvalErr names of the
    error rows' codes, sorted."""
    from ..expr.scalar import EvalErr

    def _msg(data):
        try:
            return EvalErr(int(data[0])).name.lower().replace("_", " ")
        except (ValueError, TypeError, IndexError):
            return str(data)

    msgs = sorted({_msg(d) for d, v in acc.items() if v > 0})
    return f"peek {index_id}: error: {'; '.join(msgs)}"


def _expr_dtype(expr, col_dtypes):
    """Static result dtype of a scalar expr given input column dtypes."""
    from ..expr import scalar as s

    if isinstance(expr, s.Column):
        return np.dtype(col_dtypes[expr.index])
    if isinstance(expr, s.Literal):
        return np.dtype(expr.dtype)
    if isinstance(expr, s.CallBinary):
        if expr.func in ("eq", "ne", "lt", "lte", "gt", "gte", "and", "or"):
            return np.dtype(np.int8)
        return np.promote_types(_expr_dtype(expr.left, col_dtypes),
                                _expr_dtype(expr.right, col_dtypes))
    raise TypeError(f"not a ScalarExpr: {expr!r}")
