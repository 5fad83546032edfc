"""The port's SQL front end against the JAX package's, structure for
structure, with no device work.

Every statement of the 17 files under test/sqllogictest/ and the Q3 text of
tests/test_models.py goes through a catalog-only harness in each package:
DDL changes the catalog as the coordinator does (load generators intern
their strings, INSERT encodes its literals), and every statement is lexed
and parsed; a query (SELECT, a view, a materialized view, EXPLAIN, the
read half of UPDATE and DELETE) is planned, optimized and lowered. The
lexer tokens, the parser AST, the planned MIR and `PlannedQuery`
finishing, the optimized MIR, the lowered LIR (`DataflowDescription`),
INSERT's encoded literals and UPDATE's planned assignments are compared
as structural dumps (class name and fields, recursively; numpy dtypes by
name; a numpy scalar as its Python value, since the column or the
Literal's dtype types it), exactly. A statement that fails must fail in both packages with
the same exception class and message.
"""

import dataclasses
import enum
import glob
import importlib
import os
import tracemalloc

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


SLT_DIR = os.path.join(os.path.dirname(__file__), "..", "test", "sqllogictest")
FILES = sorted(glob.glob(os.path.join(SLT_DIR, "*.slt")))
Q3 = """CREATE MATERIALIZED VIEW q3 AS
           SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
                  o_orderdate, o_shippriority
           FROM customer, orders, lineitem
           WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
             AND l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15'
             AND l_shipdate > DATE '1995-03-15'
           GROUP BY l_orderkey, o_orderdate, o_shippriority"""
SCRIPTS = [("q3", ["CREATE SOURCE tp FROM LOAD GENERATOR TPCH (SCALE FACTOR 0.001)", Q3,
                   "SELECT * FROM q3", "EXPLAIN PHYSICAL PLAN FOR SELECT * FROM q3"])]


def dump(o):
    """Class name and fields, recursively; numpy dtypes and scalars by value."""
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return (type(o).__name__,) + tuple((f.name, dump(getattr(o, f.name)))
                                           for f in dataclasses.fields(o))
    if isinstance(o, enum.Enum):
        return (type(o).__name__, o.name)
    if isinstance(o, np.dtype):
        return ("dtype", o.name)
    if isinstance(o, type):
        return ("type", o.__name__)
    if isinstance(o, np.generic):  # a value: the column or Literal dtype types it
        return dump(o.item())
    if isinstance(o, np.ndarray):
        return ("ndarray", o.dtype.name, dump(o.tolist()))
    if isinstance(o, float) and o != o:
        return ("nan",)
    if o is None or isinstance(o, (str, int, float, bool, bytes)):
        return o
    if isinstance(o, (tuple, list, set, frozenset)):
        items = sorted(o, key=repr) if isinstance(o, (set, frozenset)) else o
        return (type(o).__name__,) + tuple(dump(x) for x in items)
    if isinstance(o, dict):
        return ("dict",) + tuple((dump(k), dump(v)) for k, v in o.items())
    if type(o).__name__ == "StringFuncTables":
        return ("StringFuncTables", tuple(o.dct._strs))
    if type(o).__name__ == "StringDictionary":
        return ("StringDictionary", tuple(o._strs))
    if hasattr(o, "__dict__"):
        return (type(o).__name__, dump(vars(o)))
    raise TypeError(f"cannot dump {type(o).__name__}")


class PlanHarness:
    """A coordinator's catalog bookkeeping and planning pipeline, without
    storage or dataflows, in the package `pkg`."""

    def __init__(self, pkg: str):
        def m(name):
            return importlib.import_module(f"{pkg}.{name}")

        self.ast, self.cat, self.plan = m("sql.ast"), m("adapter.catalog"), m("sql.plan")
        self.lex, self.parse = m("sql").lex, m("sql").parse_statement
        self.optimize, self.lower = m("transform").optimize, m("sql.lower")
        self.gen = m("storage.generator")
        self.Coord = m("adapter.coordinator").Coordinator
        self.configs = m("adapter.dyncfg").default_configs()
        self.catalog = self.cat.Catalog()
        self.planner = self.plan.Planner(self.catalog)
        # the coordinator's literal encoding, bound to this catalog
        self.coord = self.Coord.__new__(self.Coord)
        self.coord.catalog, self.coord.planner = self.catalog, self.planner

    def _dtypes(self):
        return {i.global_id: i.desc.dtypes for i in self.catalog.items.values()
                if i.kind in ("table", "source", "materialized_view")}

    def _mono(self):
        return {i.global_id for i in self.catalog.items.values() if i.append_only}

    def _query(self, q, obj_id, topk=False):
        pq = self.planner.plan_query(q)
        rel = pq.mir
        if topk and pq.finishing.limit is not None:
            rel = self.plan._apply_finishing_as_topk(pq)
        opt = self.optimize(rel, self.configs)
        src = sorted(self.lower.mir.collect_get_ids(opt))
        env = {g: self._dtypes()[g] for g in src}
        desc = self.lower.lower_to_dataflow(obj_id, opt, env, src, as_of=0,
                                            mono_ids=self._mono(), until=1)
        return pq, {"mir": pq.mir, "finishing": pq.finishing, "desc": pq.desc,
                    "scope": pq.scope, "optimized": opt, "lir": desc}

    def run(self, sql: str) -> dict:
        a, C = self.ast, self.cat.CatalogItem
        out = {"tokens": self.lex(sql)}
        stmt = self.parse(sql)
        out["ast"] = stmt
        if isinstance(stmt, a.CreateTable):
            cols = tuple(self.plan.ColumnDesc(c.name, self.cat.coltype_of(c.typ),
                                              nullable=not c.not_null) for c in stmt.columns)
            self.catalog.create(C(stmt.name, "table", desc=self.plan.RelationDesc(cols)))
        elif isinstance(stmt, a.CreateSource):
            tables = {"auction": self.Coord._AUCTION_TABLES, "tpch": self.Coord._TPCH_TABLES,
                      "counter": {"counter": self.plan.RelationDesc.of(
                          ("counter", self.plan.ColType.INT64))}}[stmt.generator]
            opts = dict(stmt.options)
            if stmt.generator == "auction":
                self.gen.AuctionGenerator(seed=0, dict_=self.catalog.dict).static_tables()
            elif stmt.generator == "tpch":
                out["codes"] = [self.catalog.dict.encode(s) for s in self.gen._SEGMENTS]
            append_only = stmt.generator == "auction" or (
                stmt.generator == "counter" and not opts.get("max cardinality"))
            for name, desc in tables.items():
                self.catalog.create(C(name, "source", desc=desc, append_only=append_only))
            self.catalog.create(C(stmt.name, "source_parent", generator=stmt.generator))
        elif isinstance(stmt, a.CreateView):
            pq, out["plan"] = self._query(stmt.query, "view")
            self.catalog.create(C(stmt.name, "view", desc=pq.desc, query_ast=stmt.query, mir=pq))
        elif isinstance(stmt, a.CreateMaterializedView):
            gid = f"u{self.catalog._next_id}"
            pq, out["plan"] = self._query(stmt.query, gid, topk=True)
            self.catalog.create(C(stmt.name, "materialized_view", desc=pq.desc,
                                  query_ast=stmt.query))
        elif isinstance(stmt, a.CreateIndex):
            on = self.catalog.get(stmt.on)
            key = (tuple(on.desc.index_of(c) for c in stmt.key_columns) if stmt.key_columns
                   else tuple(on.desc.key))
            self.catalog.create(C(stmt.name or f"{stmt.on}_idx", "index", index_on=stmt.on,
                                  index_key=key))
        elif isinstance(stmt, a.DropObject):
            self.catalog.drop(stmt.name, stmt.if_exists)
        elif isinstance(stmt, a.SelectStatement):
            out["plan"] = self._query(stmt.query, "peek")[1]
        elif isinstance(stmt, a.Explain) and isinstance(stmt.statement, a.SelectStatement):
            out["plan"] = self._query(stmt.statement.query, "peek")[1]
        elif isinstance(stmt, a.Insert):
            desc = self.catalog.get(stmt.table).desc
            pos = ([desc.index_of(c) for c in stmt.columns] if stmt.columns
                   else list(range(desc.arity)))
            out["values"] = [[self.coord._literal_value(e, desc.columns[p])
                              for p, e in zip(pos, row)] for row in stmt.rows]
        elif isinstance(stmt, (a.Update, a.Delete)):
            q = a.Query(a.Select(items=(a.SelectItem(a.Star()),),
                                 from_=(a.TableRef(stmt.table),), where=stmt.where))
            out["plan"] = self._query(q, "peek")[1]
            if isinstance(stmt, a.Update):
                desc = self.catalog.get(stmt.table).desc
                scope = self.plan.Scope([self.plan.ScopeCol(
                    stmt.table, c.name, self.plan.PType(
                        c.typ, c.scale if c.typ == self.plan.ColType.NUMERIC else 0))
                    for c in desc.columns])
                out["assign"] = [self.planner.plan_scalar(e, scope)
                                 for _c, e in stmt.assignments]
        out["catalog"] = [(i.name, i.kind, i.desc, i.global_id, i.append_only, i.index_key)
                          for i in self.catalog.items.values()]
        out["dict"] = tuple(self.catalog.dict._strs)
        return out


def slt_statements(path: str) -> list[str]:
    """The SQL of every statement and query record of an .slt file (the
    records the runner would run for this engine)."""
    import materialize_tpu_torch.sqllogictest as R

    lines = open(path).read().splitlines()
    out, i = [], 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith(("skipif", "onlyif")):
            target = line.split()[1] if len(line.split()) > 1 else ""
            mine = target in ("materialize", "materialize_tpu")
            if mine == line.startswith("skipif"):
                i = R._skip_record(lines, i + 1)
                continue
        if line.startswith(("statement", "query")):
            sql, i = R._collect_sql(lines, i + 1)
            out.append(sql)
            if line.startswith("query"):
                _exp, i = R._collect_expected(lines, i)
            continue
        i += 1
    return out


def _outcome(harness: PlanHarness, sql: str) -> dict:
    try:
        return {k: dump(v) for k, v in harness.run(sql).items()}
    except Exception as e:  # noqa: BLE001 - compared across packages
        return {"error": (type(e).__name__, str(e))}


STAGES = {
    "lexer and parser": ("tokens", "ast", "error"),
    "catalog and literals": ("catalog", "dict", "codes", "values", "assign", "error"),
    "planner": ("plan",),
}


def test_front_end_matches_reference():
    """Every script once through each package's harness, then every stage's
    structures compared statement by statement."""
    scripts = [(os.path.basename(f), slt_statements(f)) for f in FILES] + SCRIPTS
    assert len(scripts) == 18
    outcomes = {}
    for name, stmts in scripts:
        jd, td = PlanHarness("materialize_tpu"), PlanHarness("materialize_tpu_torch")
        outcomes[name] = [(sql, _outcome(jd, sql), _outcome(td, sql)) for sql in stmts]
    for stage, keys in STAGES.items():
        n = 0
        for name, cases in outcomes.items():
            for sql, jo, to in cases:
                for k in keys:
                    if k == "plan" and k in jo:
                        for part in jo[k][1:]:  # ("dict", (field, dump), ...)
                            tpart = dict(to[k][1:])[part[0]] if k in to else None
                            assert tpart == part[1], (stage, name, sql, part[0])
                    else:
                        assert to.get(k) == jo.get(k), (stage, name, sql, k)
                    n += k in jo
        assert n > 0, stage
    for name, cases in outcomes.items():
        assert cases, name
        assert any("plan" in jo for _s, jo, _t in cases), name
    q3 = dict((sql, jo) for sql, jo, _t in outcomes["q3"])[Q3]
    assert "DeltaJoinPlan" in repr(q3["plan"])  # the planner picks the delta join
