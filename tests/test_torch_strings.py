"""The port's string functions (expr/strings.py) against the JAX package's.

On a seeded corpus of strings (ASCII and not, JSON texts, SQL pattern
characters, empty and blank): every unary spec through `str_func_one`,
`like_to_regex` on patterns with escapes, the JSON helpers, the
dictionary-code tables of `StringFuncTables.table` (grown in two steps, as
the dictionary grows), the host evaluation of multi-argument functions
(`eval_multi`, with NULL rows, NULL arguments of concat_ws and codes
outside the dictionary) and `decode_storage_value` for every type tag. All
must be equal, exactly.
"""

import tracemalloc

import numpy as np
import pytest
import torch

from materialize_tpu.expr import strings as JS
from materialize_tpu.repr.types import StringDictionary as JDict
from materialize_tpu_torch.expr import strings as TS
from materialize_tpu_torch.repr.types import StringDictionary as TDict

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    if tracemalloc.is_tracing():
        tracemalloc.stop()


BASE = ["", " ", "apple", "Banana split", "cherry-pie", "ÄÖü straße", "a_b%c", "back\\slash",
        "  padded  ", "x,y,z", "NULL", "123", '{"k": 1, "a": [1, 2], "b": {"c": true}}',
        '[1, "two", null]', '"quoted"', "null", "not json {", "3.5", "true"]


def corpus(n: int = 60) -> list:
    rng = np.random.default_rng(5)
    alphabet = list("abcXYZ _%\\,.-é0123")
    extra = ["".join(rng.choice(alphabet, rng.integers(0, 9))) for _ in range(n)]
    return BASE + extra


UNARY_SPECS = [
    ("upper",), ("lower",), ("initcap",), ("reverse",), ("trim",), ("trim", "ab"), ("ltrim",),
    ("ltrim", " a"), ("rtrim",), ("rtrim", "z "), ("btrim", "x"), ("substr", 2, 3),
    ("substr", -1, 3), ("substr", 3, None), ("left", 2), ("left", -2), ("right", 3),
    ("right", -1), ("right", 0), ("repeat", 3), ("repeat", -1), ("lpad", 6), ("lpad", 7, "xy"),
    ("rpad", 5, "-"), ("rpad", 2), ("replace", "a", "AA"), ("split_part", ",", 2),
    ("concat_l", ">"), ("concat_r", "<"), ("md5",), ("length",), ("bit_length",),
    ("octet_length",), ("ascii",), ("strpos", "a"), ("like", "%a%", False),
    ("like", "A_%", True), ("like", "a\\_b%", False), ("starts_with", "a"), ("ends_with", "e"),
    ("json_get", "k"), ("json_get", "a"), ("json_get", 1), ("json_get", -1),
    ("json_get_text", "b"), ("json_get_text", "k"), ("json_get_text", 0), ("jsonb_typeof",),
    ("jsonb_parse",), ("jsonb_quote",), ("jsonb_array_length",),
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the same inputs must raise the same error
        return ("raises", type(e).__name__, str(e))


def test_str_func_one():
    words = corpus()
    for spec in UNARY_SPECS:
        for s in words:
            assert _outcome(TS.str_func_one, spec, s) == _outcome(JS.str_func_one, spec, s), \
                (spec, s)


@pytest.mark.parametrize("pattern", ["%", "a%", "_b_", "a\\%b", "\\\\x", "x.y*", "%(%)%", ""])
def test_like_to_regex(pattern):
    assert TS.like_to_regex(pattern) == JS.like_to_regex(pattern)


def test_json_helpers():
    for s in corpus():
        assert _outcome(TS.json_canonical, s) == _outcome(JS.json_canonical, s), s
        for key in ("k", "a", 0, -1, 5):
            for as_text in (False, True):
                assert TS._json_navigate(s, key, as_text) == JS._json_navigate(s, key, as_text)
    for spec in UNARY_SPECS:
        assert TS.out_kind(spec) == JS.out_kind(spec)


def _dicts(words):
    jd, td = JDict(), TDict()
    for w in words:
        jd.encode(w)
        td.encode(w)
    return jd, td


def test_table_grows_with_the_dictionary():
    """Each spec on a dictionary of its own (str results intern into it)."""
    words = corpus()
    for spec in UNARY_SPECS:
        if spec[0] == "split_part":
            continue
        jd, td = _dicts(words[:20])
        jt, tt = JS.StringFuncTables(jd), TS.StringFuncTables(td)
        assert np.array_equal(jt.table(spec), tt.table(spec)), spec
        for w in words[20:]:
            jd.encode(w)
            td.encode(w)
        a, b = jt.table(spec), tt.table(spec)
        assert a.dtype == b.dtype and np.array_equal(a, b), spec
        assert jd._strs == td._strs, spec


@pytest.mark.parametrize("spec, argtypes", [
    (("concat",), ("str", "str")), (("concat_ws",), ("str", "str", "str")),
    (("like_dyn", True), ("str", "str")), (("str_lt",), ("str", "str")),
    (("str_gte",), ("str", "str")), (("strpos",), ("str", "str")),
    (("starts_with",), ("str", "str")), (("ends_with",), ("str", "str")),
    (("concat",), ("str", "int")), (("concat",), ("bool", ("numeric", 2))),
])
def test_eval_multi(spec, argtypes):
    words = corpus()
    jd, td = _dicts(words)
    rng = np.random.default_rng(9)
    n = 80
    cols = []
    for at in argtypes:
        if at == "str":
            c = rng.integers(0, len(words), n).astype(np.int64)
            c[::17] = len(words) + 3  # outside the dictionary
        elif at == "bool":
            c = rng.integers(0, 2, n).astype(np.int64)
        else:
            c = rng.integers(-500, 500, n).astype(np.int64)
        cols.append(c)
    nulls = rng.random(n) < 0.1
    arg_nulls = [rng.random(n) < 0.15 for _ in cols] if spec[0] == "concat_ws" else None
    want = JS.StringFuncTables(jd).eval_multi(spec, argtypes, cols, nulls, arg_nulls)
    got = TS.StringFuncTables(td).eval_multi(spec, argtypes, cols, nulls, arg_nulls)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g), spec
    assert jd._strs == td._strs  # results interned in the same order


@pytest.mark.parametrize("argtype", ["str", "jsonb", "bool", "float", "int", "raw",
                                     ("numeric", 0), ("numeric", 3)])
def test_decode_storage_value(argtype):
    words = corpus()
    jd, td = _dicts(words)
    if argtype in ("str", "jsonb"):
        values = list(range(len(td)))
    elif argtype == "float":
        values = [0.1, -0.0, 1e30, 1e-5, 123.25, float("inf"), float("nan"), 3.0]
    elif argtype == "raw":
        values = ["x", 5]
    else:
        values = [0, 1, -7, 12345, -100001, 10**12]
    for v in values:
        for style in ("word", "tf"):
            assert TS.decode_storage_value(argtype, v, td, bool_style=style) == \
                JS.decode_storage_value(argtype, v, jd, bool_style=style), (argtype, v)
    assert _outcome(TS.decode_storage_value, "nope", 1, td)[:2] == \
        _outcome(JS.decode_storage_value, "nope", 1, jd)[:2]
