"""The port's in-memory Coordinator against the JAX package's, statement by
statement, on the CPU.

One seeded script runs through both coordinators: tables with INSERT,
UPDATE and DELETE; a grouped-SUM materialized view with an index and views
that import its arrangement; a window-function view and a LIMIT (top-k)
view; a one-shot join SELECT; a division by zero (the error stream); the
auction source with two views that share the `bids` arrangement; Q3 as SQL
text over the TPC-H source with three `advance()` ticks; EXPLAIN, SHOW and
SET. After every statement both must give the same ExecResult (kind,
columns, rows, status) or raise the same exception class and message,
hold the same consolidated contents in every storage collection, and
report the same `trace_manager.sharing_rows()`, exactly. Q3's view is also
held against `q3_oracle` over the generator's host rows, as
tests/test_models.py does for the JAX package. The statements the port
does not serve yet must raise NotImplementedError naming their module.

A second script runs a Q3-shaped view through the fused renderer on a
4-worker mesh (`Coordinator(mesh=...)`: the port's on 4 CPU workers, the
JAX package's over 4 of the conftest's 8 CPU devices) with churn, and flips
`exchange_backend` from device to host between two views: the first
renders on 4 workers, the second on one.
"""

import tracemalloc

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from materialize_tpu.adapter import Coordinator as JCoord
from materialize_tpu.dataflow import fused as JF
from materialize_tpu.parallel import make_mesh as jax_mesh
from materialize_tpu_torch.adapter import Coordinator as TCoord
from materialize_tpu_torch.dataflow.fused import FusedDataflow
from materialize_tpu_torch.parallel.mesh import make_mesh
from materialize_tpu_torch.models import tpch as TT

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


Q3 = """CREATE MATERIALIZED VIEW q3 AS
           SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
                  o_orderdate, o_shippriority
           FROM customer, orders, lineitem
           WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
             AND l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15'
             AND l_shipdate > DATE '1995-03-15'
           GROUP BY l_orderkey, o_orderdate, o_shippriority"""


def _inserts(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        rows = ", ".join(
            f"({int(rng.integers(0, 5))}, {int(rng.integers(-20, 40))}, "
            f"'{['x', 'y', 'zz', 'w'][int(rng.integers(0, 4))]}', "
            f"{'NULL' if rng.random() < 0.2 else int(rng.integers(0, 3))})"
            for _ in range(6))
        out.append(f"INSERT INTO t VALUES {rows}")
    return out


ins = _inserts(11)
TABLES = [
    "CREATE TABLE t (a int, b int, s text, d int)",
    "CREATE TABLE u (k int, label text)",
    ins[0],
    "INSERT INTO u VALUES (0, 'zero'), (1, 'one'), (2, 'two'), (3, 'three')",
    "CREATE MATERIALIZED VIEW sums AS SELECT a, sum(b) AS total, count(*) AS n FROM t GROUP BY a",
    "CREATE INDEX sums_idx ON sums (a)",
    "CREATE MATERIALIZED VIEW labelled AS SELECT sums.a, u.label, sums.total "
    "FROM sums, u WHERE sums.a = u.k",
    "CREATE MATERIALIZED VIEW big AS SELECT sums.a, sums.n FROM sums, u "
    "WHERE sums.a = u.k AND sums.total > 0",
    "CREATE MATERIALIZED VIEW ranked AS SELECT a, b, "
    "row_number() OVER (PARTITION BY a ORDER BY b DESC) AS rn FROM t",
    "CREATE MATERIALIZED VIEW top3 AS SELECT a, b FROM t ORDER BY b DESC, a LIMIT 3",
    "CREATE MATERIALIZED VIEW ratio AS SELECT a, b / d AS q FROM t",
    ins[1],
    "SELECT * FROM sums",
    "SELECT * FROM labelled",
    "SELECT * FROM ranked",
    "SELECT * FROM top3",
    "SELECT t.a, t.s, u.label FROM t, u WHERE t.a = u.k AND t.b > 5",
    "SELECT * FROM ratio",
    "UPDATE t SET b = b + 100 WHERE a = 1",
    "DELETE FROM t WHERE d = 0",
    "SELECT a, total FROM sums WHERE total > 10",
    "SELECT * FROM big",
    "DROP MATERIALIZED VIEW big",
    "SELECT * FROM labelled",
    "CREATE SOURCE auction_house FROM LOAD GENERATOR AUCTION",
    "$advance 40",
    "CREATE MATERIALIZED VIEW bid_items AS SELECT auctions.id, auctions.item, bids.amount "
    "FROM auctions, bids WHERE auctions.id = bids.auction_id",
    "CREATE MATERIALIZED VIEW bid_max AS SELECT auctions.id, max(bids.amount) AS top "
    "FROM auctions, bids WHERE auctions.id = bids.auction_id GROUP BY auctions.id",
    "$advance 40",
    "SELECT * FROM bid_max ORDER BY top DESC LIMIT 3",
    "EXPLAIN SELECT * FROM sums",
    "EXPLAIN PHYSICAL PLAN FOR SELECT sums.a, u.label FROM sums, u WHERE sums.a = u.k",
    "SHOW TABLES",
    "SHOW VIEWS",
    "SHOW SOURCES",
    "SET statement_timeout = 0",
    "SHOW statement_timeout",
    "ALTER SYSTEM SET compaction_window = 8",
]
TPCH = [
    "CREATE SOURCE tp FROM LOAD GENERATOR TPCH (SCALE FACTOR 0.001)",
    Q3,
    "$advance",
    "$advance",
    "$advance",
    "SELECT * FROM q3",
]
SCRIPTS = {"tables": TABLES, "tpch": TPCH}


def _mesh_script(seed: int = 23) -> list[str]:
    """A Q3-shaped view (tests/test_parallel.py's) rendered on the mesh,
    seeded inserts with three churn DELETEs, then a second view rendered
    after the flip to the host exchange."""
    rng = np.random.default_rng(seed)
    out = [
        "ALTER SYSTEM SET enable_fused_render = true",
        "ALTER SYSTEM SET exchange_backend = device",
        "CREATE TABLE c (ck int, seg int)",
        "CREATE TABLE o (ok int, ck int, od int)",
        "CREATE TABLE l (lk int, price int)",
        "CREATE MATERIALIZED VIEW q3 AS SELECT o.ok, sum(l.price), count(*) "
        "FROM c, o, l WHERE c.ck = o.ck AND o.ok = l.lk AND c.seg = 1 "
        "AND o.od < 50 GROUP BY o.ok",
    ]
    for i in range(5):
        out += [
            f"INSERT INTO c VALUES ({i}, {int(rng.integers(2))})",
            f"INSERT INTO o VALUES ({i * 10}, {int(rng.integers(5))}, {int(rng.integers(100))})",
            f"INSERT INTO l VALUES ({int(rng.integers(5)) * 10}, {int(rng.integers(500))}), "
            f"({int(rng.integers(5)) * 10}, {int(rng.integers(500))})",
        ]
        if i >= 2:
            out.append(f"DELETE FROM l WHERE lk = {int(rng.integers(5)) * 10}")
        out.append("SELECT * FROM q3")
    return out + [
        "ALTER SYSTEM SET exchange_backend = host",
        "CREATE MATERIALIZED VIEW per_ck AS SELECT ck, count(*) FROM o GROUP BY ck",
        "DELETE FROM o WHERE ck = 1",
        "INSERT INTO o VALUES (70, 2, 10)",
        "SELECT * FROM q3",
        "SELECT * FROM per_ck",
    ]


def _storage(c) -> dict:
    ts = c.oracle.read_ts()
    out = {}
    for gid, st in c.storage.items():
        if gid.startswith("si_"):  # the JAX package's mz_* relations
            continue
        acc: dict = {}
        for data, _t, d in st.arr.rows_host(ts):
            acc[data] = acc.get(data, 0) + d
        out[gid] = sorted((k, v) for k, v in acc.items() if v)
    return out


def _run(c, stmt: str):
    if stmt.startswith("$advance"):
        parts = stmt.split()
        return ("advance", c.advance(int(parts[1])) if len(parts) > 1 else c.advance())
    try:
        r = c.execute(stmt)
        return (r.kind, r.columns, r.rows, r.status)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("error", type(e).__name__, str(e))


def _trace(c, script) -> list:
    """Per statement: (statement, result, storage contents, sharing rows)."""
    out = []
    for stmt in script:
        res = _run(c, stmt)
        out.append((stmt, res, _storage(c), c.trace_manager.sharing_rows()))
    return out


def test_mesh_script_matches_reference(monkeypatch):
    """The mesh script through both packages' coordinators on a 4-worker
    mesh: every statement's result, storage contents and sharing rows
    equal; the first view's dataflow a FusedDataflow on 4 workers in both,
    the second's (rendered after the flip to host) on one."""
    # the JAX view's state placed as its tick's outputs are, from the start,
    # so that the mesh tick compiles once, not once more at the first write
    # (test time; placement only)
    init = JF.FusedDataflow.__init__

    def placed_init(self, *a, **k):
        init(self, *a, **k)
        if self.mesh is not None:
            self.state = jax.device_put(
                self.state, NamedSharding(self.mesh, PartitionSpec(self.axis_name)))

    monkeypatch.setattr(JF.FusedDataflow, "__init__", placed_init)
    script = _mesh_script()
    j = JCoord(mesh=jax_mesh(4))
    jt = _trace(j, script)
    t = TCoord(mesh=make_mesh(4, "cpu"), device="cpu")
    tt = _trace(t, script)
    for n, (jrow, trow) in enumerate(zip(jt, tt)):
        assert trow[1:] == jrow[1:], (n, jrow[0], jrow[1], trow[1])
    assert not [r for _s, r, _x, _y in tt if r[0] == "error"]
    assert [r for s, r, _x, _y in tt if s == "SELECT * FROM q3"][-1][2]
    for c in (j, t):
        dfs = [df for _g, df, _s in c.dataflows]
        assert [type(df).__name__ for df in dfs] == ["FusedDataflow"] * 2
        assert [df.n_shards for df in dfs] == [4, 1]
    assert isinstance(t.dataflows[0][1], FusedDataflow)


def test_script_matches_reference():
    """Each script once through each package's coordinator; then every
    statement's result, storage contents and sharing rows compared, the
    slice's features checked, and Q3 held against its oracle."""
    runs = {}
    for name, script in SCRIPTS.items():
        j, t = JCoord(), TCoord(device="cpu")
        runs[name] = (_trace(j, script), t, _trace(t, script))
    for name, (jt, _t, tt) in runs.items():
        assert len(jt) == len(tt) == len(SCRIPTS[name])
        for what, i in (("result", 1), ("storage", 2), ("sharing", 3)):
            for n, (jrow, trow) in enumerate(zip(jt, tt)):
                assert trow[i] == jrow[i], (name, what, n, jrow[0])

    _jt, t, tt = runs["tables"]
    ratio = [res for stmt, res, _s, _sh in tt if stmt == "SELECT * FROM ratio"][0]
    assert ratio[0] == "error" and "division by zero" in ratio[2]
    errors = [(s, r) for s, r, _x, _y in tt if r[0] == "error" and s != "SELECT * FROM ratio"]
    assert not errors, errors
    assert t.trace_manager.stats["imports"] > 0
    # big imports the arrangement of sums that labelled exported
    sums = t.catalog.get("sums").global_id
    after_big = next(sh for stmt, _r, _s, sh in tt
                     if stmt.startswith("CREATE MATERIALIZED VIEW big"))
    assert any(r[0].startswith(f"{sums}/arrange") and r[2] == 2 for r in after_big)
    bids = t.catalog.get("bids").global_id  # bid_items and bid_max share its arrangement
    assert any(r[0].startswith(f"{bids}/arrange") and r[2] >= 2
               for r in t.trace_manager.sharing_rows())
    assert t.slow_path_peeks > 0

    # Q3 through SQL equals the oracle over the generator's host rows
    _jt, t, tt = runs["tpch"]
    assert not [r for _s, r, _x, _y in tt if r[0] == "error"]
    rows = [res for stmt, res, _s, _sh in tt if stmt == "SELECT * FROM q3"][0][2]
    gen = next(g for g, gids in t.generators if "lineitem" in gids)
    want = TT.q3_oracle(gen._customer_cols(), tuple(gen._orders_store),
                        tuple(gen._lineitem_store),
                        building_code=t.catalog.dict.lookup("BUILDING"))
    got = {(lk, od, sp): round(rev * 10_000) for lk, rev, od, sp in rows}
    assert rows and got == {k: v for k, v in want.items() if v != 0}

    # what the port does not serve yet raises, naming the module
    c = TCoord(device="cpu")
    c.execute("CREATE TABLE t (a int)")
    c.execute("CREATE MATERIALIZED VIEW m AS SELECT a FROM t")
    cases = [
        (lambda: TCoord(data_dir="x", device="cpu"), "persist/"),
        (lambda: c.execute("SUBSCRIBE m"), "egress/"),
        (lambda: c.execute("CREATE SINK k FROM m INTO FILE 'p' FORMAT JSON"), "egress/"),
        (lambda: c.execute("CREATE SOURCE f (a int) FROM FILE 'p' (FORMAT JSON)"),
         "storage/file_source.py"),
        (lambda: c.execute("CREATE SOURCE kv FROM LOAD GENERATOR KEY VALUE"),
         "storage/upsert.py"),
        (lambda: c.execute("SELECT * FROM mz_tables"), "adapter/introspection.py"),
        (lambda: c.execute("SET kernel_backend = 'pallas'"), "kernel registry"),
        (lambda: c.execute("SET enable_jax_profiler = true"), "profiler"),
        (lambda: c.checkpoint(), "persist/"),
        (lambda: c.catch_up(), "persist/"),
        (lambda: c.promote(), "persist/"),
        (lambda: c.create_compute_replica("r", "2x2"), "cluster/"),
        (lambda: c.replica_peek("d", "i"), "cluster/"),
        (lambda: c.replica_stats(), "cluster/"),
    ]
    for fn, module in cases:
        with pytest.raises(NotImplementedError, match=module.replace(".", r"\.")):
            fn()
    # the mesh mode is served: a mesh is kept and the device exchange is a
    # valid setting (the mesh script above runs both)
    assert TCoord(mesh=make_mesh(2, "cpu"), device="cpu").mesh == make_mesh(2, "cpu")
    assert c.execute("SET exchange_backend = 'device'").status == "SET"
    assert c.execute("SET kernel_backend = 'auto'").status == "SET"
