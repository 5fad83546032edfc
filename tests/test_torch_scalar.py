"""The port's scalar language against the JAX package's, function by function.

One parametrised test over every function `eval_expr3` dispatches (unary,
binary, variadic, the date functions and the string functions over
dictionary codes, `DictFunc`), on 96 seeded rows holding NULL sentinels,
zeros (division by zero), a string code outside the dictionary, a NULL
dividend over a -1 divisor (INT_MIN // -1), infinities, -0.0 and float
values past the integer range. The value column (with the NULL sentinel
written, as `eval_expr` gives it), the null mask and the error column must
be equal, and of the same dtype.

Tolerance: exact, except the float32 sqrt and transcendental functions
(exp, ln, log10, log2, the trigonometric and hyperbolic functions, cot,
cbrt, pow, atan2), which XLA's CPU code and torch approximate differently
(XLA's sqrt is 1 unit off on some rows, its cbrt 7 at 1e30): there the
values must be within 8 units in the last place, with the same infinities
and NaNs. NaN payloads (sign and mantissa bits) are not compared.
"""

import tracemalloc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from materialize_tpu.expr import scalar as JS
from materialize_tpu.expr.strings import StringFuncTables as JTables
from materialize_tpu.repr.types import StringDictionary as JDict
from materialize_tpu_torch.expr import scalar as TS
from test_torch_runtime import to_port

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    if tracemalloc.is_tracing():
        tracemalloc.stop()


N = 96
I64_MIN = int(np.iinfo(np.int64).min)
ULP_TOL = 8
_APPROX = {"sqrt", "exp", "ln", "log10", "log2", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
           "cosh", "tanh", "cot", "cbrt", "pow", "atan2"}

WORDS = ["apple", "Banana", "cherry", "", "a b", "NULL", '{"k": 1, "a": [1, 2]}', '[1, "x"]',
         "x%y", "kiwi"]


def columns() -> list:
    rng = np.random.default_rng(11)
    a = rng.integers(-20, 21, N).astype(np.int64)
    a[::9] = I64_MIN  # NULL
    a[:3] = I64_MIN + 1
    b = rng.integers(-5, 6, N).astype(np.int64)
    b[::7] = I64_MIN
    b[::9] = -1  # under a NULL a: INT_MIN // -1 in the floor functions
    c = rng.integers(-1000, 1001, N).astype(np.int32)
    c[::11] = np.iinfo(np.int32).min
    x = (rng.normal(0, 10, N)).astype(np.float32)
    x[:8] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e30, -3e9, 0.5]
    y = (rng.normal(0, 3, N)).astype(np.float32)
    y[5:9] = [0.0, -0.0, np.nan, 2.5]
    p = rng.choice(np.array([0, 1, -128], np.int8), N)
    d = rng.integers(-30000, 40000, N).astype(np.int64)
    d[::13] = I64_MIN
    d[1:6] = [0, -8035, 59, 60 + 365 * 8, -719468 - 8035]  # epochs, leap days
    m = rng.integers(-30, 31, N).astype(np.int64)
    s = rng.integers(0, len(WORDS), N).astype(np.int64)
    s[::10] = I64_MIN
    s[4] = 99  # outside the dictionary
    t = rng.integers(0, len(WORDS), N).astype(np.int64)
    t[::6] = I64_MIN
    return [a, b, c, x, y, p, d, m, s, t]


A, B, C32, X, Y, P, D, M, S, T = (JS.Column(i) for i in range(10))
L = JS.Literal


def _u(f, e):
    return JS.CallUnary(f, e)


def _b(f, l, r):
    return JS.CallBinary(f, l, r)


def _v(f, *es):
    return JS.CallVariadic(f, tuple(es))


def cases() -> dict:
    dct = JDict()
    for w in WORDS:
        dct.encode(w)
    tables = JTables(dct)

    def sf(spec, args, out, argtypes=None):
        return JS.DictFunc(spec, tuple(args), argtypes or ("str",) * len(args), out, tables)

    out = {}
    for f in ("neg", "abs", "sign"):
        out[f"{f}_i64"] = _u(f, A)
        out[f"{f}_f32"] = _u(f, X)
    out["neg_i32"] = _u("neg", C32)
    for f in ("not", "is_true", "is_null", "is_not_null"):
        out[f] = _u(f, P)
    out["is_null_f32"] = _u("is_null", X)
    for src, col in (("f32", X), ("i32", C32), ("i64", A)):
        out[f"cast_int64_{src}"] = _u("cast_int64", col)
        out[f"cast_int32_{src}"] = _u("cast_int32", col)
        out[f"cast_float_{src}"] = _u("cast_float", col)
    for f in ("sqrt", "floor", "ceil", "trunc", "exp", "ln", "log10", "log2", "sin", "cos",
              "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "cot", "cbrt", "degrees",
              "radians", "round_half_away"):
        out[f] = _u(f, X)
    out["sqrt_i64"] = _u("sqrt", A)
    for f in ("extract_year", "extract_month", "extract_day", "extract_dow", "extract_isodow",
              "extract_doy", "extract_quarter", "extract_week", "extract_epoch_date",
              "extract_century", "extract_decade", "extract_millennium", "date_trunc_year",
              "date_trunc_quarter", "date_trunc_month", "date_trunc_week", "date_trunc_day"):
        out[f] = _u(f, D)
    for f in ("add", "sub", "mul", "div", "floordiv", "mod", "fdiv", "fmod", "min", "max"):
        out[f"{f}_i64"] = _b(f, A, B)
        out[f"{f}_f32"] = _b(f, X, Y)
    for f in ("add", "div", "mod", "fdiv", "fmod"):
        out[f"{f}_i32_i64"] = _b(f, C32, B)
        out[f"{f}_i64_f32"] = _b(f, A, Y)
    out["sub_lit"] = _b("sub", L(100), C32)
    out["mul_lit_f32"] = _b("mul", X, L(0.5, "float32"))
    for f in ("eq", "ne", "lt", "lte", "gt", "gte"):
        out[f"{f}_i64"] = _b(f, A, B)
        out[f"{f}_mixed"] = _b(f, C32, Y)
    out["and"] = _b("and", P, _b("gt", A, L(0)))
    out["or"] = _b("or", P, _b("gt", A, L(0)))
    out["pow"] = _b("pow", Y, L(2.5, "float32"))
    out["pow_xy"] = _b("pow", X, Y)
    out["atan2"] = _b("atan2", X, Y)
    out["add_months"] = _b("add_months", D, M)
    out["v_and"] = _v("and", P, _b("gt", A, L(0)), _b("lt", B, L(3)))
    out["v_or"] = _v("or", P, _b("gt", A, L(0)), _b("lt", B, L(3)))
    out["if"] = _v("if", P, A, B)
    out["if_mixed"] = _v("if", _b("gt", A, B), C32, X)
    out["coalesce"] = _v("coalesce", A, B, L(7))
    out["coalesce_mixed"] = _v("coalesce", C32, A)
    out["nullif"] = _v("nullif", A, B)
    out["greatest"] = _v("greatest", A, B, L(None))
    out["least"] = _v("least", X, Y)
    out["null_literal"] = _b("add", A, L(None))
    out["null_bool_literal"] = _v("coalesce", L(None, "bool"), P)
    out["div_by_zero_literal"] = _b("div", A, L(0))
    out["dict_upper"] = sf(("upper",), [S], "string")
    out["dict_length"] = sf(("length",), [S], "int64")
    out["dict_like"] = sf(("like", "%a%", True), [S], "bool")
    out["dict_md5"] = sf(("md5",), [S], "string")
    out["dict_json_get"] = sf(("json_get", "a"), [S], "string")
    out["dict_jsonb_typeof"] = sf(("jsonb_typeof",), [S], "string")
    out["dict_concat"] = sf(("concat",), [S, T], "string")
    out["dict_concat_ws"] = sf(("concat_ws",), [T, S, T], "string")
    out["dict_strpos"] = sf(("strpos",), [S, T], "int64")
    out["dict_str_lt"] = sf(("str_lt",), [S, T], "bool")
    out["dict_like_dyn"] = sf(("like_dyn", False), [S, T], "bool")
    return out


CASES = cases()


def _ordered(bits: np.ndarray) -> np.ndarray:
    b = bits.astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


def assert_close_f32(want: np.ndarray, got: np.ndarray, what: str) -> None:
    nan_w, nan_g = np.isnan(want), np.isnan(got)
    assert (nan_w == nan_g).all(), what
    fin = ~nan_w
    assert (np.isinf(want[fin]) == np.isinf(got[fin])).all(), what
    ulps = np.abs(_ordered(want[fin].view(np.int32)) - _ordered(got[fin].view(np.int32)))
    assert ulps.max(initial=0) <= ULP_TOL, (what, int(ulps.max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_scalar_function_matches_jax(name):
    jexpr = CASES[name]
    texpr = to_port(jexpr)
    cols = columns()
    jv, jn, je = JS.eval_expr3(jexpr, [jnp.asarray(c) for c in cols], N)
    tv, tn, te = TS.eval_expr3(texpr, [torch.from_numpy(c) for c in cols], N)
    want = np.asarray(JS.force_sentinel(jv, jn))
    got = TS.force_sentinel(tv, tn).numpy()
    assert np.asarray(jn).tolist() == tn.numpy().tolist(), name
    assert np.asarray(je).dtype == te.numpy().dtype
    assert np.asarray(je).tolist() == te.numpy().tolist(), name
    assert want.dtype == got.dtype, (name, want.dtype, got.dtype)
    func = getattr(jexpr, "func", None)
    if want.dtype.kind == "f" and func in _APPROX:
        assert_close_f32(want, got, name)
    elif want.dtype.kind == "f":
        nan = np.isnan(want)
        assert (nan == np.isnan(got)).all(), name
        assert want[~nan].tobytes() == got[~nan].tobytes(), name
    else:
        assert want.tobytes() == got.tobytes(), (name, want, got)


def test_expr_columns_and_dictfunc_walk():
    for name, jexpr in CASES.items():
        texpr = to_port(jexpr)
        assert TS.expr_columns(texpr) == JS.expr_columns(jexpr), name
        assert TS.expr_has_dictfunc(texpr) == JS.expr_has_dictfunc(jexpr), name


@pytest.mark.parametrize("v, coltype", [
    (None, None), (float("nan"), None), (I64_MIN, None), (I64_MIN, "INT64"), (-128, "BOOL"),
    (-128, None), (np.iinfo(np.int32).min, "INT32"), (np.int64(5), None), ("x", None)])
def test_is_null_value(v, coltype):
    class _T:
        name = coltype

    ct = None if coltype is None else _T()
    assert TS.is_null_value(v, ct) == JS.is_null_value(v, ct)
