"""sqllogictest runner: the query-correctness test tier.

Counterpart of materialize_tpu/sqllogictest/ (its runner.py): host Python, kept as a copy in the
port (which never imports the JAX package) and held to the same
behaviour by the port's tests.

The analogue of the reference's in-repo sqllogictest runner
(src/sqllogictest/src/runner.rs; methodology doc
doc/developer/guide-testing.md:121-196). Supported directives:

  statement ok
  statement error [regex]
  query <types> [rowsort|valuesort|colnames]
  ----
  <expected rows, tab- or space-separated>
  hash-threshold N            (ignored)
  halt / skipif / onlyif      (skipif/onlyif respected for 'materialize')
  $ advance [N]               (testdrive-style action: tick generator
                               sources N rows forward)

Types string: T=text, I=integer, R=float (per sqllogictest convention).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from .adapter import Coordinator


@dataclass
class SltResult:
    passed: int = 0
    failed: int = 0
    errors: list = field(default_factory=list)

    def ok(self) -> bool:
        return self.failed == 0


def _format_value(v, t: str) -> str:
    if v is None:
        return "NULL"
    if t == "I":
        return str(int(v))
    if t == "R":
        return f"{float(v):.3f}"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and t == "T":
        return str(v)
    return str(v)


def run_slt_text(text: str, coordinator: Coordinator | None = None) -> SltResult:
    coord = coordinator or Coordinator()
    res = SltResult()
    lines = text.splitlines()
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        if line.startswith("hash-threshold"):
            i += 1
            continue
        if line == "halt":
            break
        if line.startswith("$"):
            parts = line[1:].split()
            if parts and parts[0] == "advance":
                rows = int(parts[1]) if len(parts) > 1 else 100
                coord.advance(rows)
                res.passed += 1
            else:
                res.failed += 1
                res.errors.append(f"unknown action: {line}")
            i += 1
            continue
        if line.startswith("skipif"):
            target = line.split()[1] if len(line.split()) > 1 else ""
            if target in ("materialize", "materialize_tpu"):
                i = _skip_record(lines, i + 1)
                continue
            i += 1
            continue
        if line.startswith("onlyif"):
            target = line.split()[1] if len(line.split()) > 1 else ""
            if target not in ("materialize", "materialize_tpu"):
                i = _skip_record(lines, i + 1)
                continue
            i += 1
            continue
        if line.startswith("statement"):
            expect_err = "error" in line.split()[1:2]
            err_re = line.split(None, 2)[2] if expect_err and len(line.split(None, 2)) > 2 else None
            sql, i = _collect_sql(lines, i + 1)
            try:
                coord.execute(sql)
                if expect_err:
                    res.failed += 1
                    res.errors.append(f"expected error for: {sql}")
                else:
                    res.passed += 1
            except Exception as e:
                if expect_err and (err_re is None or re.search(err_re, str(e))):
                    res.passed += 1
                else:
                    res.failed += 1
                    res.errors.append(f"{sql}: {e}")
            continue
        if line.startswith("query"):
            parts = line.split()
            types = parts[1] if len(parts) > 1 else "T"
            modes = parts[2:] if len(parts) > 2 else []
            sql, i = _collect_sql(lines, i + 1)
            expected, i = _collect_expected(lines, i)
            try:
                r = coord.execute(sql)
                got = []
                for row in r.rows:
                    got.append([
                        _format_value(v, types[j] if j < len(types) else "T")
                        for j, v in enumerate(row)
                    ])
                if "rowsort" in modes:
                    got.sort()
                    expected = sorted(expected)
                elif "valuesort" in modes:
                    got = sorted([[v] for row in got for v in row])
                    expected = sorted([[v] for row in expected for v in row])
                flat_got = [v for row in got for v in row]
                flat_exp = [v for row in expected for v in row]
                if flat_got == flat_exp:
                    res.passed += 1
                else:
                    res.failed += 1
                    res.errors.append(
                        f"{sql}\n  got:      {flat_got}\n  expected: {flat_exp}"
                    )
            except Exception as e:
                res.failed += 1
                res.errors.append(f"{sql}: {e}")
            continue
        i += 1
    return res


def _collect_sql(lines: list, i: int) -> tuple[str, int]:
    sql_lines = []
    n = len(lines)
    while i < n:
        s = lines[i]
        if s.strip() == "----" or not s.strip():
            break
        sql_lines.append(s)
        i += 1
    return "\n".join(sql_lines).strip(), i


def _collect_expected(lines: list, i: int) -> tuple[list, int]:
    n = len(lines)
    expected: list = []
    if i < n and lines[i].strip() == "----":
        i += 1
        while i < n and lines[i].strip() != "":
            # values may be tab- or multi-space-separated
            row = re.split(r"\t| {2,}", lines[i].rstrip())
            if len(row) == 1:
                row = lines[i].split()
            expected.append([c for c in row])
            i += 1
    return expected, i


def run_slt_file(path: str, coordinator: Coordinator | None = None) -> SltResult:
    with open(path) as f:
        return run_slt_text(f.read(), coordinator)
