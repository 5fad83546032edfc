"""Scalar expressions evaluated columnwise, with SQL NULLs.

Counterpart of materialize_tpu/expr/scalar.py: the whole scalar language
(`Column`, `Literal`, `CallUnary`, `CallBinary`, `CallVariadic` and the
string functions over dictionary codes, `DictFunc`), evaluated over torch
columns on the batch's device. Runtime errors (division by zero, a string
code outside the dictionary, ...) do not trap: they give a per-row error
code that the MFP routes into the dataflow's error stream.

NULL is in-band: a per-dtype sentinel stored in the column itself
(INT64_MIN, INT32_MIN, -128, NaN). Evaluation derives a null mask at each
Column reference, threads (value, null, err) triples through the tree and
re-materializes the sentinel at output boundaries (`force_sentinel`).
Errors never fire on NULL rows.

The reference runs with 64-bit JAX types, so every literal, sentinel and
intermediate here carries an explicit dtype (a bare Python float would make
a float32 tensor where the reference has int64, or the reverse). Integer
`//` floors as jnp's does, through `_floordiv`, which also keeps
INT_MIN // -1 from trapping (XLA defines it as INT_MIN); float `//` follows
jnp's divmod algorithm, so the sign of a zero quotient matches. Float to
integer casts saturate, and NaN casts to 0, as XLA's do. The float32
transcendental functions (exp, ln, sin, ...) are torch's: they may differ
from XLA's approximations in the last few units of precision.
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
    "uint64": torch.int64,
    "int32": torch.int32,
    "int8": torch.int8,
    "bool": torch.bool,
    "float32": torch.float32,
    "float64": torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or dtype name); torch dtypes pass."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype).name]


def null_sentinel(dtype):
    """The in-band NULL value for a storage dtype (numpy or torch)."""
    if not isinstance(dtype, torch.dtype):
        if np.dtype(dtype) == np.bool_:
            return NULL_I8
        dtype = torch_dtype(dtype)
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


def is_null_value(v, coltype=None) -> bool:
    """Host-side: is a decoded storage scalar the NULL sentinel?

    `coltype` (a planner column type) picks the sentinel width: -128 is NULL
    only for BOOL columns, INT32_MIN only for INT32. Without it only the
    unambiguous sentinels (None, NaN, INT64_MIN) are recognized.
    """
    if v is None:
        return True
    if isinstance(v, float) and v != v:  # NaN
        return True
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        if coltype is None:
            return iv == NULL_I64
        name = getattr(coltype, "name", str(coltype))
        if name == "BOOL":
            return iv == NULL_I8
        if name == "INT32":
            return iv == NULL_I32
        return iv == NULL_I64
    return False


def force_sentinel(col: torch.Tensor, null: torch.Tensor) -> torch.Tensor:
    """Write the dtype sentinel wherever `null`."""
    if col.dtype == torch.bool:
        # nullable booleans store as int8; a bool tensor here is an
        # eval-internal predicate about to be consumed, not stored
        return col
    return torch.where(null, torch.full_like(col, null_sentinel(col.dtype)), col)


class EvalErr(enum.IntEnum):
    """Per-row evaluation error codes (0 = no error), as in the reference."""

    NONE = 0
    DIVISION_BY_ZERO = 1
    NUMERIC_OVERFLOW = 2
    # a reduce lookup scanned its hash bucket without resolving the probe
    HASH_COLLISION_EXHAUSTED = 3
    # a string column held a code outside the dictionary
    STRING_CODE_OOB = 4
    NEGATIVE_FUNC_ARG = 5
    STEP_ZERO = 6  # generate_series step size cannot equal zero


@dataclass(frozen=True)
class Column:
    """Reference to input column `index` (after maps: index into input+maps)."""

    index: int


@dataclass(frozen=True)
class Literal:
    value: Any
    dtype: str = "int64"  # numpy dtype name


@dataclass(frozen=True)
class CallUnary:
    func: str  # neg | not | abs | is_true | cast_* | float and date functions
    expr: Any


@dataclass(frozen=True)
class CallBinary:
    func: str  # add sub mul div floordiv mod eq ne lt lte gt gte and or min max ...
    left: Any
    right: Any


@dataclass(frozen=True)
class CallVariadic:
    func: str  # and | or | if | coalesce | nullif | greatest | least
    exprs: tuple


@dataclass(frozen=True, eq=False)
class DictFunc:
    """A string function over dictionary codes (expr/strings.py).

    `spec` = (name, *literal_args); `args` are ScalarExprs; `argtypes` tags
    how each arg decodes for multi-arg host evaluation ("str" args are codes).
    `out` is the result kind: "string" (i64 code), "int64", or "bool" (i8).
    `tables` is the StringFuncTables registry, shared with the dictionary
    and outside eq/hash. A single-string-arg spec evaluates on the device
    as one table gather; a multi-arg spec decodes on the host.
    """

    spec: tuple
    args: tuple
    argtypes: tuple
    out: str
    tables: Any


ScalarExpr = Any  # Column | Literal | CallUnary | CallBinary | CallVariadic | DictFunc


def eval_expr(expr: ScalarExpr, cols: list, n: int):
    """Evaluate to (value[n], err_code[n] int32), NULL rows holding the
    dtype sentinel (and no error)."""
    v, null, err = eval_expr3(expr, cols, n)
    return force_sentinel(v, null), err


def _truth(v: torch.Tensor) -> torch.Tensor:
    """Boolean view of a stored truth value (int8 {0,1} or bool)."""
    return v.to(torch.bool)


def _as_bool_i8(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int8)


def _i32(code, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, int(code), dtype=torch.int32)


def _floordiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp's `a // b` (b never 0): integer floor division, or for floats
    jnp's divmod algorithm (fmod, then a rounded quotient)."""
    dt = torch.result_type(a, b)
    a, b = a.to(dt), b.to(dt)
    if dt.is_floating_point:
        mod = torch.fmod(a, b)
        div = (a - mod) / b
        ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
        div = torch.where(ind, div - 1, div)
        # lax.round: half away from zero, keeping the sign of a zero
        r = torch.trunc(div)
        return torch.where((div - r).abs() >= 0.5, r + torch.sign(div), r)
    # b == -1 is -a (INT_MIN stays INT_MIN); torch would trap on INT_MIN / -1
    neg1 = b == -1
    q = torch.div(a, torch.where(neg1, torch.ones_like(b), b), rounding_mode="floor")
    return torch.where(neg1, -a, q)


def _cast_int(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """`astype` to an integer dtype; floats saturate and NaN becomes 0."""
    if not v.dtype.is_floating_point:
        return v.to(dt)
    info = torch.iinfo(dt)
    out = v.to(dt)
    out = torch.where(v >= float(info.max) + 1.0, info.max, out)
    out = torch.where(v < float(info.min), info.min, out)
    return torch.where(torch.isnan(v), 0, out)


def _sign(v: torch.Tensor) -> torch.Tensor:
    """jnp.sign: floats keep -0.0 and NaN."""
    if not v.dtype.is_floating_point:
        return torch.sign(v)
    one = torch.ones_like(v)
    return torch.where(v > 0, one, torch.where(v < 0, -one, v))


def eval_expr3(expr: ScalarExpr, cols: list, n: int, device=None):
    """Three-valued evaluation: (value[n], null[n] bool, err[n] int32).

    Values under a set null bit are unspecified until `force_sentinel`.
    Boolean results are int8 {0,1}. `device` is that of the columns, which
    an expression over no column (a literal) needs.
    """
    dev = cols[0].device if cols else (device if device is not None else "cpu")
    zero_err = torch.zeros((n,), dtype=torch.int32, device=dev)
    no_null = torch.zeros((n,), dtype=torch.bool, device=dev)
    if isinstance(expr, Column):
        v = cols[expr.index]
        return v, derived_null(v), zero_err
    if isinstance(expr, Literal):
        # a bool literal stores as int8, as nullable booleans do
        dt = torch.int8 if np.dtype(expr.dtype) == np.bool_ else torch_dtype(expr.dtype)
        if expr.value is None:
            if np.dtype(expr.dtype) == np.bool_:
                # the reference fills its bool dtype with the int8 sentinel
                return (torch.ones((n,), dtype=torch.bool, device=dev),
                        torch.ones((n,), dtype=torch.bool, device=dev), zero_err)
            return (
                torch.full((n,), null_sentinel(dt), dtype=dt, device=dev),
                torch.ones((n,), dtype=torch.bool, device=dev),
                zero_err,
            )
        value = int(bool(expr.value)) if np.dtype(expr.dtype) == np.bool_ else expr.value
        return torch.full((n,), value, dtype=dt, device=dev), no_null, zero_err
    if isinstance(expr, CallUnary):
        return _eval_unary(expr, cols, n, dev, zero_err, no_null)
    if isinstance(expr, CallBinary):
        return _eval_binary(expr, cols, n, dev)
    if isinstance(expr, CallVariadic):
        return _eval_variadic(expr, cols, n, dev, no_null)
    if isinstance(expr, DictFunc):
        return _eval_dictfunc(expr, cols, n, dev)
    raise TypeError(f"not a ScalarExpr: {expr!r}")


def _eval_unary(expr, cols, n, dev, zero_err, no_null):
    f = expr.func
    v, null, e = eval_expr3(expr.expr, cols, n, dev)
    if f == "is_null":
        return _as_bool_i8(null), no_null, zero_err
    if f == "is_not_null":
        return _as_bool_i8(~null), no_null, zero_err
    e = torch.where(null, 0, e)
    if f == "neg":
        return -v, null, e
    if f == "not":
        return _as_bool_i8(~_truth(v)), null, e
    if f == "abs":
        return torch.abs(v), null, e
    if f == "is_true":
        # NULL is not true
        return _truth(v) & ~null, no_null, e
    if f == "cast_int64":
        return _cast_int(v, torch.int64), null, e
    if f == "cast_int32":
        return _cast_int(v, torch.int32), null, e
    if f == "cast_float":
        return v.to(torch.float32), null, e
    if f == "sqrt":
        return torch.sqrt(v.to(torch.float32)), null, e
    if f in _FLOAT_UNARY:
        return _FLOAT_UNARY[f](v.to(torch.float32)), null, e
    if f == "round_half_away":
        fv = v.to(torch.float32)
        return _sign(fv) * torch.floor(torch.abs(fv) + 0.5), null, e
    if f == "sign":
        return _sign(v), null, e
    if f in ("extract_year", "extract_month", "extract_day"):
        y, m, d = _civil_from_days(v)
        return {"extract_year": y, "extract_month": m, "extract_day": d}[f], null, e
    if f in _DATE_UNARY:
        return _DATE_UNARY[f](v), null, e
    raise NotImplementedError(f"unary func {f}")


def _eval_binary(expr, cols, n, dev):
    f = expr.func
    lv, ln, le = eval_expr3(expr.left, cols, n, dev)
    rv, rn, re_ = eval_expr3(expr.right, cols, n, dev)
    null = ln | rn
    err = torch.where(null, 0, torch.maximum(le, re_))
    if f == "and":
        lt, rt = _truth(lv) & ~ln, _truth(rv) & ~rn
        lf, rf = ~_truth(lv) & ~ln, ~_truth(rv) & ~rn
        is_false = lf | rf  # Kleene: FALSE dominates NULL
        return _as_bool_i8(lt & rt), null & ~is_false, err
    if f == "or":
        lt, rt = _truth(lv) & ~ln, _truth(rv) & ~rn
        is_true = lt | rt  # Kleene: TRUE dominates NULL
        return _as_bool_i8(is_true), null & ~is_true, err
    if f == "add":
        return lv + rv, null, err
    if f == "sub":
        return lv - rv, null, err
    if f == "mul":
        return lv * rv, null, err
    if f in ("div", "floordiv", "mod", "fdiv", "fmod"):
        zero = (rv == 0) & ~null
        safe = torch.where(rv == 0, torch.ones_like(rv), rv)
        err = torch.where(zero, _i32(EvalErr.DIVISION_BY_ZERO, err), err)
        if f == "fdiv":  # floor division (date arithmetic)
            return _floordiv(lv, safe), null, err
        if f == "fmod":  # floor modulo, not torch.fmod (which truncates)
            return lv - safe * _floordiv(lv, safe), null, err
        neg = (lv < 0) ^ (safe < 0)
        if f == "mod":
            q = _floordiv(torch.abs(lv), torch.abs(safe))
            return lv - safe * torch.where(neg, -q, q), null, err
        if torch.result_type(lv, rv).is_floating_point:
            return lv / safe, null, err
        # SQL integer division truncates toward zero: floor on magnitudes
        q = _floordiv(torch.abs(lv), torch.abs(safe))
        return torch.where(neg, -q, q), null, err
    if f == "eq":
        return _as_bool_i8(lv == rv), null, err
    if f == "ne":
        return _as_bool_i8(lv != rv), null, err
    if f == "lt":
        return _as_bool_i8(lv < rv), null, err
    if f == "lte":
        return _as_bool_i8(lv <= rv), null, err
    if f == "gt":
        return _as_bool_i8(lv > rv), null, err
    if f == "gte":
        return _as_bool_i8(lv >= rv), null, err
    if f == "min":
        return torch.minimum(lv, rv), null, err
    if f == "max":
        return torch.maximum(lv, rv), null, err
    if f == "pow":
        return torch.pow(lv.to(torch.float32), rv.to(torch.float32)), null, err
    if f == "atan2":
        return torch.atan2(lv.to(torch.float32), rv.to(torch.float32)), null, err
    if f == "add_months":
        # calendar month addition, clamped to the end of the month
        y, m, d = _civil_from_days(lv)
        t = y * 12 + (m - 1) + rv.to(torch.int64)
        y2 = _fd(t, 12)
        m2 = t - y2 * 12 + 1
        d2 = torch.minimum(d, _days_in_month(y2, m2))
        return _days_from_civil(y2, m2, d2), null, err
    raise NotImplementedError(f"binary func {f}")


def _eval_variadic(expr, cols, n, dev, no_null):
    f = expr.func
    parts = [eval_expr3(e, cols, n, dev) for e in expr.exprs]
    vals = [p[0] for p in parts]
    nulls = [p[1] for p in parts]
    any_null = nulls[0]
    for m in nulls[1:]:
        any_null = any_null | m
    err = parts[0][2]
    for p in parts[1:]:
        err = torch.maximum(err, p[2])
    if f == "and":
        is_false = no_null
        all_true = ~no_null
        for v, m in zip(vals, nulls):
            is_false = is_false | (~_truth(v) & ~m)
            all_true = all_true & (_truth(v) & ~m)
        err = torch.where(any_null & ~is_false, 0, err)
        return _as_bool_i8(all_true), any_null & ~is_false, err
    if f == "or":
        is_true = no_null
        for v, m in zip(vals, nulls):
            is_true = is_true | (_truth(v) & ~m)
        err = torch.where(any_null & ~is_true, 0, err)
        return _as_bool_i8(is_true), any_null & ~is_true, err
    if f == "if":
        (cv, cn, _), (tv, tn, _), (ev, en, _) = parts
        take = _truth(cv) & ~cn  # NULL condition selects ELSE
        return torch.where(take, tv, ev), torch.where(take, tn, en), err
    if f == "coalesce":
        out, null = vals[0], nulls[0]
        for v, m in zip(vals[1:], nulls[1:]):
            out = torch.where(null, v.to(out.dtype), out)
            null = null & m
        return out, null, err
    if f == "nullif":
        a, an = vals[0], nulls[0]
        b, bn = vals[1], nulls[1]
        eq = (a == b.to(a.dtype)) & ~an & ~bn
        return a, an | eq, err
    if f in ("greatest", "least"):
        pick = torch.maximum if f == "greatest" else torch.minimum
        out, null = vals[0], nulls[0]
        for v, m in zip(vals[1:], nulls[1:]):
            # SQL greatest/least ignore NULLs; all-NULL stays NULL
            out = torch.where(null, v, torch.where(m, out, pick(out, v)))
            null = null & m
        return out, null, err
    raise NotImplementedError(f"variadic func {f}")


def _eval_dictfunc(expr, cols, n, dev):
    parts = [eval_expr3(a, cols, n, dev) for a in expr.args]
    vals = [p[0] for p in parts]
    # concat_ws skips NULL arguments; only a NULL separator (arg 0) nulls
    # the result. Everything else is strictly NULL-propagating.
    skips_null_args = expr.spec[0] == "concat_ws"
    null = parts[0][1]
    err = parts[0][2]
    for _, nv, ev in parts[1:]:
        if not skips_null_args:
            null = null | nv
        err = torch.maximum(err, ev)
    err = torch.where(null, 0, err)
    if len(vals) == 1:
        tbl = torch.from_numpy(expr.tables.table(expr.spec)).to(dev)
        m = int(tbl.shape[0])
        code = vals[0].to(torch.int64)
        oob = (~null) & ((code < 0) | (code >= m))
        if m:
            out = tbl[code.clamp(0, m - 1)]
        else:
            out = torch.zeros((n,), dtype=tbl.dtype, device=dev)
        err = torch.where(oob, _i32(EvalErr.STRING_CODE_OOB, err), err)
    else:
        # decode, compute and re-encode on the host (one read of the args)
        res, oob = expr.tables.eval_multi(
            expr.spec,
            expr.argtypes,
            [v.cpu().numpy() for v in vals],
            null.cpu().numpy(),
            arg_nulls=[p[1].cpu().numpy() for p in parts] if skips_null_args else None,
        )
        out = torch.from_numpy(res).to(dev)
        err = torch.where(torch.from_numpy(oob).to(dev),
                          _i32(EvalErr.STRING_CODE_OOB, err), err)
    if expr.out == "bool":
        out = out.to(torch.int8)
    else:
        # table entries can hold the NULL sentinel (json key misses, bad
        # casts): fold them into the null mask
        null = null | (out == NULL_I64)
    return out, null, err


# days between 1970-01-01 and the engine's date epoch 1992-01-01
_D1992 = 8035


def _cbrt(v: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt: the f64 root of |v| with v's sign, rounded once to f32
    w = v.double()
    return torch.copysign(w.abs().pow(1.0 / 3.0), w).to(v.dtype)


# float32 elementwise math, the reference's _FLOAT_UNARY names
_FLOAT_UNARY = {
    "floor": torch.floor,
    "ceil": torch.ceil,
    "trunc": torch.trunc,
    "exp": torch.exp,
    "ln": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "cot": lambda v: 1.0 / torch.tan(v),
    "cbrt": _cbrt,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
}

_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _fd(a: torch.Tensor, k: int) -> torch.Tensor:
    """a // k for a positive constant k (floor, as jnp)."""
    return torch.div(a, k, rounding_mode="floor")


def _leap(y: torch.Tensor) -> torch.Tensor:
    return ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) | (
        torch.remainder(y, 400) == 0)


def _days_in_month(y, m):
    table = torch.tensor(_MONTH_DAYS, dtype=torch.int64, device=m.device)
    base = table[(m - 1).clamp(0, 11)]
    return base + (_leap(y) & (m == 2)).to(torch.int64)


def _days_from_civil(y, m, d):
    """Inverse of _civil_from_days: (y, m, d) -> day number since 1992-01-01."""
    y = y - (m <= 2).to(torch.int64)
    era = _fd(y, 400)  # floors, as the algorithm requires for y < 0
    yoe = y - era * 400
    doy = _fd(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _fd(yoe, 4) - _fd(yoe, 100) + doy
    return era * 146097 + doe - 719468 - _D1992


def _civil_from_days(days):
    """Exact (y, m, d) from day numbers since 1992-01-01 (Hinnant's
    civil_from_days, integer ops only)."""
    z = days.to(torch.int64) + _D1992 + 719468
    era = _fd(z, 146097)
    doe = z - era * 146097
    yoe = _fd(doe - _fd(doe, 1460) + _fd(doe, 36524) - _fd(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fd(yoe, 4) - _fd(yoe, 100))
    mp = _fd(5 * doy + 2, 153)
    d = doy - _fd(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _date_dow(v):
    """Day of week, Sunday = 0. 1970-01-01 was a Thursday."""
    return torch.remainder(v.to(torch.int64) + _D1992 + 4, 7)


def _date_isodow(v):
    """ISO day of week, Monday = 1 ... Sunday = 7."""
    return torch.remainder(v.to(torch.int64) + _D1992 + 3, 7) + 1


def _date_doy(v):
    y, _m, _d = _civil_from_days(v)
    ones = torch.ones_like(y)
    return v.to(torch.int64) - _days_from_civil(y, ones, ones) + 1


def _iso_long_year(y):
    """53-week ISO years: Jan 1 is Thursday, or leap year with Jan 1 Wednesday."""
    ones = torch.ones_like(y)
    dow = _date_isodow(_days_from_civil(y, ones, ones))
    return (dow == 4) | (_leap(y) & (dow == 3))


def _date_isoweek(v):
    y, _m, _d = _civil_from_days(v)
    w = _fd(_date_doy(v) - _date_isodow(v) + 10, 7)
    weeks_prev = torch.where(_iso_long_year(y - 1), 53, 52)
    weeks_cur = torch.where(_iso_long_year(y), 53, 52)
    # w < 1 borrows the previous year's last week; only an original w past
    # this year's count wraps to week 1
    return torch.where(w < 1, weeks_prev, torch.where(w > weeks_cur, 1, w))


def _trunc_year(v):
    y, _m, _d = _civil_from_days(v)
    ones = torch.ones_like(y)
    return _days_from_civil(y, ones, ones)


def _trunc_quarter(v):
    y, m, _d = _civil_from_days(v)
    qm = _fd(m - 1, 3) * 3 + 1
    return _days_from_civil(y, qm, torch.ones_like(y))


def _trunc_month(v):
    y, m, _d = _civil_from_days(v)
    return _days_from_civil(y, m, torch.ones_like(y))


def _trunc_week(v):
    """Monday of v's ISO week."""
    return v.to(torch.int64) - (_date_isodow(v) - 1)


_DATE_UNARY = {
    "extract_dow": _date_dow,
    "extract_isodow": _date_isodow,
    "extract_doy": _date_doy,
    "extract_quarter": lambda v: _fd(_civil_from_days(v)[1] + 2, 3),
    "extract_week": _date_isoweek,
    "extract_epoch_date": lambda v: (v.to(torch.int64) + _D1992) * 86400,
    "extract_century": lambda v: _fd(_civil_from_days(v)[0] + 99, 100),
    "extract_decade": lambda v: _fd(_civil_from_days(v)[0], 10),
    "extract_millennium": lambda v: _fd(_civil_from_days(v)[0] + 999, 1000),
    "date_trunc_year": _trunc_year,
    "date_trunc_quarter": _trunc_quarter,
    "date_trunc_month": _trunc_month,
    "date_trunc_week": _trunc_week,
    "date_trunc_day": lambda v: v,
}


def expr_columns(expr: ScalarExpr) -> set[int]:
    """Set of input column indices an expression references."""
    if isinstance(expr, Column):
        return {expr.index}
    if isinstance(expr, Literal):
        return set()
    if isinstance(expr, CallUnary):
        return expr_columns(expr.expr)
    if isinstance(expr, CallBinary):
        return expr_columns(expr.left) | expr_columns(expr.right)
    if isinstance(expr, CallVariadic):
        out: set[int] = set()
        for e in expr.exprs:
            out |= expr_columns(e)
        return out
    if isinstance(expr, DictFunc):
        out2: set[int] = set()
        for e in expr.args:
            out2 |= expr_columns(e)
        return out2
    raise TypeError(f"not a ScalarExpr: {expr!r}")


def expr_has_dictfunc(expr: ScalarExpr) -> bool:
    """True if the expression tree contains a DictFunc (host path only)."""
    if isinstance(expr, DictFunc):
        return True
    if isinstance(expr, CallUnary):
        return expr_has_dictfunc(expr.expr)
    if isinstance(expr, CallBinary):
        return expr_has_dictfunc(expr.left) or expr_has_dictfunc(expr.right)
    if isinstance(expr, CallVariadic):
        return any(expr_has_dictfunc(e) for e in expr.exprs)
    return False


# -- host mirrors of the date and float kernels ------------------------------
# (the coordinator evaluates INSERT/UPDATE expressions and fast-path peek
# MFPs row by row on the host; these give the device kernels' results)

_FLOAT_UNARY_NP = {
    "floor": np.floor,
    "ceil": np.ceil,
    "trunc": np.trunc,
    "exp": np.exp,
    "ln": np.log,
    "log10": np.log10,
    "log2": np.log2,
    "sin": np.sin,
    "cos": np.cos,
    "tan": np.tan,
    "asin": np.arcsin,
    "acos": np.arccos,
    "atan": np.arctan,
    "sinh": np.sinh,
    "cosh": np.cosh,
    "tanh": np.tanh,
    "cot": lambda v: np.float32(1.0) / np.tan(v),
    "cbrt": np.cbrt,
    "degrees": np.degrees,
    "radians": np.radians,
}


def add_months_int(v: int, n: int) -> int:
    """Host mirror of the device add_months kernel (same clamp rule)."""
    y, m, d = civil_from_days_int(int(v))
    t = y * 12 + (m - 1) + int(n)
    y2, m2 = t // 12, t % 12 + 1
    leap = (y2 % 4 == 0 and y2 % 100 != 0) or y2 % 400 == 0
    dim = [31, 29 if leap else 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m2 - 1]
    return days_from_civil_int(y2, m2, min(d, dim))


def civil_from_days_int(days: int) -> tuple:
    """Pure-int (y, m, d) from a day number since 1992-01-01 — the single
    definition both the device kernel and host fast-path interpreter use."""
    z = days + _D1992 + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (1 if m <= 2 else 0), m, d


def days_from_civil_int(y: int, m: int, d: int) -> int:
    """Pure-int inverse of civil_from_days_int (host mirror of _days_from_civil)."""
    y = y - (1 if m <= 2 else 0)
    era = y // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468 - _D1992


def date_unary_int(f: str, v: int) -> int:
    """Host mirror of _DATE_UNARY for the fast-path row interpreter —
    bit-identical to the device kernels (both are pure integer Hinnant
    calendar arithmetic)."""
    v = int(v)
    if f == "extract_dow":
        return (v + _D1992 + 4) % 7
    if f == "extract_isodow":
        return (v + _D1992 + 3) % 7 + 1
    y, m, d = civil_from_days_int(v)
    if f == "extract_doy":
        return v - days_from_civil_int(y, 1, 1) + 1
    if f == "extract_quarter":
        return (m + 2) // 3
    if f == "extract_week":
        doy = v - days_from_civil_int(y, 1, 1) + 1
        isodow = (v + _D1992 + 3) % 7 + 1
        w = (doy - isodow + 10) // 7

        def long_year(yy):
            jan1 = days_from_civil_int(yy, 1, 1)
            dw = (jan1 + _D1992 + 3) % 7 + 1
            leap = (yy % 4 == 0 and yy % 100 != 0) or yy % 400 == 0
            return dw == 4 or (leap and dw == 3)

        if w < 1:
            return 53 if long_year(y - 1) else 52
        if w > (53 if long_year(y) else 52):
            return 1
        return w
    if f == "extract_epoch_date":
        return (v + _D1992) * 86400
    if f == "extract_century":
        return (y + 99) // 100
    if f == "extract_decade":
        return y // 10
    if f == "extract_millennium":
        return (y + 999) // 1000
    if f == "date_trunc_year":
        return days_from_civil_int(y, 1, 1)
    if f == "date_trunc_quarter":
        return days_from_civil_int(y, ((m - 1) // 3) * 3 + 1, 1)
    if f == "date_trunc_month":
        return days_from_civil_int(y, m, 1)
    if f == "date_trunc_week":
        return v - ((v + _D1992 + 3) % 7)
    if f == "date_trunc_day":
        return v
    raise NotImplementedError(f"date func {f}")
