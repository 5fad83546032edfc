"""String functions over dictionary codes (NumPy only).

Counterpart of materialize_tpu/expr/strings.py, line for line. Strings live
host-side in a `StringDictionary` (repr/types.py); device columns carry i64
codes. A unary string function is a lookup table over the dictionary: f is
evaluated once per distinct string on the host, its results interned, and
the device evaluates the function as one gather `table[code]`. LIKE/ILIKE
compile the SQL pattern to a regex and become an i8 membership table.
Multi-string-argument functions (col || col, strpos(col, col)) decode,
compute and re-encode on the host, which only the host-orchestrated
renderer does (the fused renderer refuses DictFunc plans).

Tables grow with the dictionary and extend incrementally: only codes added
since the last call are evaluated.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

# spec -> output kind: "str" results are interned codes (i64), "int" are i64
# values, "bool" are i8 {0,1}
_OUT = {
    "upper": "str",
    "lower": "str",
    "initcap": "str",
    "reverse": "str",
    "trim": "str",
    "ltrim": "str",
    "rtrim": "str",
    "btrim": "str",
    "substr": "str",
    "left": "str",
    "right": "str",
    "repeat": "str",
    "lpad": "str",
    "rpad": "str",
    "replace": "str",
    "split_part": "str",
    "concat_l": "str",
    "concat_r": "str",
    "md5": "str",
    "concat": "str",
    "concat_ws": "str",
    "length": "int",
    "bit_length": "int",
    "octet_length": "int",
    "ascii": "int",
    "strpos": "int",
    "like": "bool",
    "like_dyn": "bool",
    "starts_with": "bool",
    "ends_with": "bool",
    # lexicographic string comparison over DECODED strings — dictionary
    # codes are insertion-ordered, so code comparison would be silently
    # wrong; these evaluate host-side on both columns
    "str_lt": "bool",
    "str_lte": "bool",
    "str_gt": "bool",
    "str_gte": "bool",
    # jsonb operators over canonical JSON text (repr/types.py ColType.JSONB):
    # json_get = `->` (jsonb result), json_get_text = `->>` (text result);
    # missing keys / type mismatches yield SQL NULL (pg semantics)
    "json_get": "str",
    "json_get_text": "str",
    "jsonb_typeof": "str",
    "jsonb_parse": "str",
    "jsonb_quote": "str",
    "jsonb_array_length": "int",
}


def json_canonical(text: str) -> str:
    """Canonical jsonb text: sorted keys, compact separators — equality of
    canonical text == jsonb equality (the dictionary-code equality rule)."""
    import json as _json

    return _json.dumps(
        _json.loads(text), sort_keys=True, separators=(",", ":")
    )


def _json_navigate(s: str, key, as_text: bool):
    import json as _json

    try:
        v = _json.loads(s)
    except ValueError:
        return None
    if isinstance(key, int):
        if not isinstance(v, list) or not (-len(v) <= key < len(v)):
            return None
        r = v[key]
    else:
        if not isinstance(v, dict) or key not in v:
            return None
        r = v[key]
    if as_text:
        if r is None:
            return None
        if isinstance(r, bool):
            return "true" if r else "false"
        if isinstance(r, (dict, list)):
            return _json.dumps(r, sort_keys=True, separators=(",", ":"))
        return str(r)
    return _json.dumps(r, sort_keys=True, separators=(",", ":"))


def out_kind(spec: tuple) -> str:
    return _OUT[spec[0]]


def like_to_regex(pattern: str) -> str:
    """SQL LIKE pattern → anchored Python regex (% = .*, _ = ., \\ escapes)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out)


def _initcap(s: str) -> str:
    # postgres initcap: uppercase the first alphanumeric of each word,
    # lowercase the rest; word boundaries are non-alphanumeric characters
    out = []
    start = True
    for ch in s:
        if ch.isalnum():
            out.append(ch.upper() if start else ch.lower())
            start = False
        else:
            out.append(ch)
            start = True
    return "".join(out)


def str_func_one(spec: tuple, s: str):
    """Python semantics of one unary-over-string spec applied to `s`."""
    f = spec[0]
    if f == "upper":
        return s.upper()
    if f == "lower":
        return s.lower()
    if f == "initcap":
        return _initcap(s)
    if f == "reverse":
        return s[::-1]
    if f in ("trim", "btrim"):
        return s.strip(spec[1]) if len(spec) > 1 else s.strip()
    if f == "ltrim":
        return s.lstrip(spec[1]) if len(spec) > 1 else s.lstrip()
    if f == "rtrim":
        return s.rstrip(spec[1]) if len(spec) > 1 else s.rstrip()
    if f == "substr":
        # SQL substring(s FROM start [FOR len]): 1-based, negative start
        # extends the window leftward (pg semantics)
        start, ln = spec[1], spec[2]
        begin = start - 1
        end = None if ln is None else begin + ln
        if ln is not None and ln < 0:
            raise ValueError("negative substring length not allowed")
        if begin < 0:
            if end is not None:
                end = max(end, 0)
            begin = 0
        return s[begin:end]
    if f == "left":
        k = spec[1]
        return s[:k] if k >= 0 else s[:k] if len(s) + k > 0 else ""
    if f == "right":
        k = spec[1]
        if k >= 0:
            return s[-k:] if k else ""
        return s[-k:]
    if f == "repeat":
        return s * max(spec[1], 0)
    if f == "lpad":
        ln, fill = spec[1], (spec[2] if len(spec) > 2 else " ")
        if ln <= len(s):
            return s[:ln]
        pad = (fill * ln)[: ln - len(s)] if fill else ""
        return pad + s
    if f == "rpad":
        ln, fill = spec[1], (spec[2] if len(spec) > 2 else " ")
        if ln <= len(s):
            return s[:ln]
        pad = (fill * ln)[: ln - len(s)] if fill else ""
        return s + pad
    if f == "replace":
        return s.replace(spec[1], spec[2])
    if f == "split_part":
        parts = s.split(spec[1])
        idx = spec[2]
        if idx <= 0:
            raise ValueError("field position must be greater than zero")
        return parts[idx - 1] if idx <= len(parts) else ""
    if f == "concat_l":  # literal || s
        return spec[1] + s
    if f == "concat_r":  # s || literal
        return s + spec[1]
    if f == "md5":
        return hashlib.md5(s.encode()).hexdigest()
    if f == "length":
        return len(s)
    if f == "bit_length":
        return 8 * len(s.encode())
    if f == "octet_length":
        return len(s.encode())
    if f == "ascii":
        return ord(s[0]) if s else 0
    if f == "strpos":
        return s.find(spec[1]) + 1
    if f == "like":
        pat, ci = spec[1], spec[2]
        flags = (re.IGNORECASE | re.DOTALL) if ci else re.DOTALL
        return re.compile(like_to_regex(pat), flags).fullmatch(s) is not None
    if f == "starts_with":
        return s.startswith(spec[1])
    if f == "ends_with":
        return s.endswith(spec[1])
    if f in ("json_get", "json_get_text"):
        return _json_navigate(s, spec[1], f == "json_get_text")
    if f == "jsonb_typeof":
        import json as _json

        try:
            v = _json.loads(s)
        except ValueError:
            return None
        return {
            type(None): "null", bool: "boolean", int: "number",
            float: "number", str: "string", list: "array", dict: "object",
        }[type(v)]
    if f == "jsonb_parse":
        # cast text → jsonb; invalid JSON yields SQL NULL (divergence: pg
        # errors — the engine's table path has no per-row error channel)
        try:
            return json_canonical(s)
        except ValueError:
            return None
    if f == "jsonb_quote":
        import json as _json

        return _json.dumps(s)
    if f == "jsonb_array_length":
        import json as _json

        try:
            v = _json.loads(s)
        except ValueError:
            return None
        return len(v) if isinstance(v, list) else None
    raise NotImplementedError(f"string func {spec!r}")


class StringFuncTables:
    """Per-dictionary registry of code→result tables (see module docstring)."""

    def __init__(self, dct) -> None:
        self.dct = dct
        self._tables: dict[tuple, np.ndarray] = {}

    def table(self, spec: tuple) -> np.ndarray:
        """The code-indexed result table for `spec`, extended to the current
        dictionary size. str results are interned into the same dictionary."""
        kind = out_kind(spec)
        cur = self._tables.get(spec)
        start = 0 if cur is None else len(cur)
        n = len(self.dct)
        if start < n:
            # snapshot the strings first: interning str results grows the
            # dictionary, and those new strings get entries on a later call
            src = list(self.dct._strs[start:n])
            vals = []
            from .scalar import NULL_I64

            for s in src:
                r = str_func_one(spec, s)
                if r is None:  # SQL NULL result (json misses, bad casts)
                    vals.append(int(NULL_I64) if kind != "bool" else 0)
                elif kind == "str":
                    vals.append(self.dct.encode(r))
                elif kind == "bool":
                    vals.append(1 if r else 0)
                else:
                    vals.append(int(r))
            dt = np.int8 if kind == "bool" else np.int64
            ext = np.asarray(vals, dtype=dt)
            cur = ext if cur is None else np.concatenate([cur, ext])
            self._tables[spec] = cur
        if cur is None:
            dt = np.int8 if kind == "bool" else np.int64
            cur = np.zeros((0,), dtype=dt)
            self._tables[spec] = cur
        return cur

    def eval_one(self, spec: tuple, args: list):
        """Host row-interpreter entry: args are decoded Python values
        (strings for str-typed args); returns the Python result (string for
        str-kind, int, or bool). NULL handling is the caller's job."""
        f = spec[0]
        if f == "concat":
            return "".join(args)
        if f == "concat_ws":
            # pg: NULL args are skipped entirely (no phantom separators);
            # a NULL separator makes the whole result NULL
            sep = args[0]
            if sep is None:
                return None
            return sep.join(a for a in args[1:] if a is not None)
        if f == "like_dyn":
            s, pat = args[0], args[1]
            flags = (re.IGNORECASE | re.DOTALL) if spec[1] else re.DOTALL
            return re.compile(like_to_regex(pat), flags).fullmatch(s) is not None
        if f == "str_lt":
            return args[0] < args[1]
        if f == "str_lte":
            return args[0] <= args[1]
        if f == "str_gt":
            return args[0] > args[1]
        if f == "str_gte":
            return args[0] >= args[1]
        if f == "strpos" and len(args) == 2:
            return args[0].find(args[1]) + 1
        if f == "starts_with" and len(args) == 2:
            return args[0].startswith(args[1])
        if f == "ends_with" and len(args) == 2:
            return args[0].endswith(args[1])
        return str_func_one(spec, args[0])

    def eval_multi(
        self,
        spec: tuple,
        argtypes: tuple,
        cols: list[np.ndarray],
        nulls,
        arg_nulls=None,
    ):
        """Vectorized host evaluation for multi-string-arg functions.

        `cols` are encoded value columns (codes for "str" argtypes), `nulls`
        a bool mask of rows where the RESULT is NULL (skipped). For strictly
        NULL-propagating functions that is "any arg NULL"; null-skipping
        functions (concat_ws) instead pass `arg_nulls` — one bool mask per
        argument — and NULL args reach `eval_one` as Python None (to be
        skipped), with only the separator's nullness in `nulls`. Returns
        (encoded result column, oob mask): rows whose string codes fall
        outside the dictionary (padding slots in a fixed-capacity batch, or
        corrupt data) get a zero result and a set oob bit — the caller turns
        non-padding oob rows into STRING_CODE_OOB errors.

        Work is deduplicated over unique argument combinations, so a
        static-capacity batch with few live rows (and all-zero padding) costs
        O(distinct combos), not O(capacity)."""
        kind = out_kind(spec)
        n = len(cols[0]) if cols else 0
        dt = np.int8 if kind == "bool" else np.int64
        out = np.zeros((n,), dtype=dt)
        oob = np.zeros((n,), dtype=bool)
        nulls = np.asarray(nulls)
        ndict = len(self.dct)
        for i, (at, c) in enumerate(zip(argtypes, cols)):
            if at in ("str", "jsonb"):
                bad = ~nulls & ((np.asarray(c) < 0) | (np.asarray(c) >= ndict))
                if arg_nulls is not None:
                    # a NULL arg's code is unspecified storage, not corrupt
                    bad &= ~np.asarray(arg_nulls[i])
                oob |= bad
        todo = ~nulls & ~oob
        if not todo.any():
            return out, oob
        nargs = len(cols)
        if arg_nulls is None:
            stacked = np.stack([np.asarray(c)[todo] for c in cols], axis=1)
        else:
            # zero NULL args' (unspecified) values so combos dedupe cleanly,
            # and carry per-arg nullness as extra combo columns
            stacked = np.stack(
                [
                    np.where(np.asarray(an)[todo], 0, np.asarray(c)[todo])
                    for an, c in zip(arg_nulls, cols)
                ]
                + [np.asarray(an)[todo].astype(np.int64) for an in arg_nulls],
                axis=1,
            )
        combos, inv = np.unique(stacked, axis=0, return_inverse=True)
        from .scalar import NULL_I64

        results = np.zeros((len(combos),), dtype=dt)
        for j, combo in enumerate(combos):
            args = [
                None
                if arg_nulls is not None and combo[nargs + i]
                else self._decode_arg(at, combo[i])
                for i, at in enumerate(argtypes)
            ]
            r = self.eval_one(spec, args)
            if r is None:
                results[j] = NULL_I64 if kind != "bool" else 0
            elif kind == "str":
                results[j] = self.dct.encode(r)
            elif kind == "bool":
                results[j] = 1 if r else 0
            else:
                results[j] = int(r)
        out[todo] = results[inv]
        return out, oob

    def _decode_arg(self, argtype, v):
        return decode_storage_value(argtype, v, self.dct)


def decode_storage_value(argtype, v, dct, bool_style: str = "word"):
    """Text form of one encoded storage scalar per its planner type tag.

    The single decode shared by multi-arg string evaluation and basic
    aggregates. `bool_style`: "word" → true/false (cast form), "tf" → t/f
    (pg array-element form)."""
    if isinstance(argtype, tuple) and argtype[0] == "numeric":
        scale = argtype[1]
        iv = int(v)
        sign = "-" if iv < 0 else ""
        iv = abs(iv)
        if scale:
            return f"{sign}{iv // 10**scale}.{iv % 10**scale:0{scale}d}"
        return f"{sign}{iv}"
    if argtype in ("str", "jsonb"):  # jsonb stores canonical text codes
        return dct.decode(int(v))
    if argtype == "bool":
        if bool_style == "tf":
            return "t" if v else "f"
        return "true" if v else "false"
    if argtype == "float":
        f = np.float32(v)
        if not np.isfinite(f):
            return repr(float(f))  # 'inf' / '-inf' / 'nan'
        # shortest round-trip text of the FLOAT32 value: '0.1', not the
        # f64-repr of the widened value ('0.10000000149011612'); extreme
        # magnitudes switch to scientific notation (pg prints 1e+30, not a
        # 31-digit positional string)
        a = abs(float(f))
        if a != 0.0 and not (1e-4 <= a < 1e16):
            return np.format_float_scientific(f, unique=True, trim="-")
        return np.format_float_positional(f, unique=True, trim="0")
    if argtype == "int":
        return str(int(v))
    if argtype == "raw":  # already a Python value (host interpreter)
        return v
    raise TypeError(f"bad argtype {argtype!r}")
