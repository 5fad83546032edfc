"""The port's FusedDataflow against the JAX package's, byte for byte.

Configs 1, 2 and 4 of the auction workload (`models/auction.py`) run
through both packages' `FusedDataflow` on the same seeded input: six ticks
of 50 bids and 4 auctions, and from tick 3 on the retraction of 10 bids of
two ticks before, so counts go down, groups empty out and top-1 winners are
retracted. After every tick each object's oks and errs batches, `retries`,
`_scale`, every state leaf, the peek rows, `operator_rates` and every
column of `arrangement_info` but bytes must be equal (u32 columns widened to
int64 in the port). The LSM merge ratio is 2, so level merges run within
the six ticks.

Config 2 runs at caps small enough that tick 1 takes one overflow retry on
both sides; config 4 calls `compact(4)` after tick 4, so later merges
cancel +/- pairs; every case then carries the JAX state after tick 3 (the
state dict, the index spines and the scale) into a fresh port dataflow,
which continues identically. Each case runs its own JAX reference: under
xdist a module-scoped fixture would be rebuilt in every worker.

Each config also runs on a 4-worker mesh: the port's `FusedDataflow(mesh=
make_mesh(4, "cpu"))` against the JAX one over 4 of the conftest's 8 CPU
devices, at the same per-worker caps. Every worker's state leaves must equal
its part of the JAX global arrays. Config 1 runs there with exchange buckets
of 16 rows: a tick's rows all sit on worker 0 (deltas split by position), so
it sends more than 16 to some worker and the tick reruns once, with doubled
caps; the retries and `mzt_device_exchange_retries_total` must agree.
"""

import importlib

import tracemalloc

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec

from materialize_tpu.dataflow import fused as JF
from materialize_tpu.dataflow import plan as jlir
from materialize_tpu.expr import Column as JColumn
from materialize_tpu.models import auction as JA
from materialize_tpu.ops.reduce import AggregateExpr as JAgg
from materialize_tpu.parallel import make_mesh as jax_mesh
from materialize_tpu.repr import UpdateBatch as JB
from materialize_tpu.storage.generator import AuctionGenerator as JGen
from materialize_tpu_torch import interop
from materialize_tpu_torch.dataflow import fused as TF
from materialize_tpu_torch.dataflow import plan as tlir
from materialize_tpu_torch.expr import Column as TColumn
from materialize_tpu_torch.models import auction as TA
from materialize_tpu_torch.ops.reduce import AggregateExpr as TAgg
from materialize_tpu_torch.parallel.devicemesh import overflow_retries
from materialize_tpu_torch.parallel.mesh import make_mesh
from materialize_tpu_torch.repr.batch import UpdateBatch as TB
from materialize_tpu_torch.storage import AuctionGenerator as TGen

# One intra-op thread: the suite runs in several test processes at once, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


TICKS = range(1, 7)
N_BIDS, N_AUCTIONS, N_RETRACT = 50, 4, 10
CARRY_AFTER = 3  # the JAX state after this tick is carried into the port
COMPACT = {"max_bid_per_auction": (4, 4)}  # config: (after tick, since)
SMALL = dict(delta=64, arrangement=1024, groups=512, join_out=256, gather=256, ratio=2)
CAPS = {
    "bids_sum_count": SMALL,
    # join_out 32 < the 50 matches of tick 1: one retry, then 64 fits
    "auctions_join_bids": {**SMALL, "join_out": 32},
    "max_bid_per_auction": SMALL,
}
N_MESH = 4
# on the mesh config 1's buckets hold 16 rows: the exchange overflows once
# (32 rows fit after the retry)
MESH_CAPS = {"bids_sum_count": {"bucket": 16}}


@pytest.fixture
def jax_mesh_state_placed(monkeypatch):
    """Place a JAX mesh dataflow's state as its tick's outputs are placed,
    when it is made and after every growth, so that the tick compiles once a
    scale and not once more at the next tick (test time; placement only)."""
    init, migrate = JF.FusedDataflow.__init__, JF.FusedDataflow._migrate_state

    def place(df):
        if df.mesh is not None:
            df.state = jax.device_put(df.state,
                                      NamedSharding(df.mesh, PartitionSpec(df.axis_name)))

    def placed_init(self, *a, **k):
        init(self, *a, **k)
        place(self)

    def placed_migrate(self):
        migrate(self)
        place(self)

    monkeypatch.setattr(JF.FusedDataflow, "__init__", placed_init)
    monkeypatch.setattr(JF.FusedDataflow, "_migrate_state", placed_migrate)


def auction_inputs(seed: int = 3) -> list:
    """Per tick: {source: (host columns, times, diffs)}; from tick 3 on the
    bids batch also retracts N_RETRACT bids of two ticks before."""
    gen = TGen(seed, N_AUCTIONS, device="cpu", keep_host=True)
    ticks = []
    for tick in TICKS:
        gen.next_tick(tick, N_BIDS)
        bids = gen.host["bids"][-1]
        diffs = np.ones(N_BIDS, dtype=np.int64)
        if tick >= 3:
            old = tuple(c[:N_RETRACT] for c in gen.host["bids"][tick - 3])
            bids = tuple(np.concatenate([c, o]) for c, o in zip(bids, old))
            diffs = np.concatenate([diffs, -np.ones(N_RETRACT, dtype=np.int64)])
        auctions = gen.host["auctions"][-1]
        ticks.append({
            "bids": (bids, np.full(len(diffs), tick), diffs),
            "auctions": (auctions, np.full(N_AUCTIONS, tick), np.ones(N_AUCTIONS, np.int64)),
        })
    return ticks


def _batches(inputs: dict, sources, build) -> dict:
    return {s: build((), *inputs[s]) for s in sources}


def _jleaves(obj) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(obj)]


def _assert_leaves(want: list, tobj, what: str) -> None:
    got = interop.to_numpy(tobj)
    assert len(got) == len(want), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, (what, i, w.dtype, g.dtype)
        assert w.tobytes() == g.tobytes(), (what, i)


def _results(results: dict, leaves) -> dict:
    return {k: None if v is None else tuple(None if b is None else leaves(b) for b in v)
            for k, v in results.items()}


def _index_id(desc) -> str:
    return next(iter(desc.index_exports))


def _jax_retries() -> float:
    """mzt_device_exchange_retries_total of the JAX package."""
    jx = importlib.import_module("materialize_tpu.parallel.devicemesh.exchange")
    return jx._RETRIES.value()


def run_jax(desc, caps: dict, inputs: list, compact=None, n_shards: int = 1) -> list:
    """The JAX dataflow's ticks; per tick what the port is held against."""
    mesh = jax_mesh(n_shards) if n_shards > 1 else None
    df = JF.FusedDataflow(desc, JF.FusedCaps(**caps), mesh=mesh, operator_logging=True)
    sources = list(desc.source_imports)
    run = []
    for tick, inp in zip(TICKS, inputs):
        res = df.step(tick, _batches(inp, sources, JB.build))
        if compact and tick == compact[0]:
            df.compact(compact[1])
        run.append({
            "results": _results(res, _jleaves),
            "retries": df.retries, "scale": df._scale,
            "state": _jleaves(df.state),
            "peek": {i: df.peek(i) for i in df.index_traces},
            "rates": df.operator_rates(),
            "info": [r[:-1] for r in df.arrangement_info()],
            "frontier": df.frontier, "since": df.since,
            "spines": {i: [(_jleaves(b), b.cap, [k.dtype for k in b.keys],
                            [v.dtype for v in b.vals]) for b in a.batches]
                       for i, a in df.index_traces.items()}
            if tick == CARRY_AFTER else None,
            "errs_spines": {i: [(_jleaves(b), b.cap, [v.dtype for v in b.vals])
                                for b in a.batches] for i, a in df.index_errs.items()}
            if tick == CARRY_AFTER else None,
        })
    return run


def check_tick(df, res: dict, want: dict, what: str) -> None:
    got = {k: None if v is None else tuple(b for b in v) for k, v in res.items()}
    assert set(got) == set(want["results"]), what
    for k, v in want["results"].items():
        if v is None:
            assert got[k] is None, (what, k)
            continue
        for part, (w, g) in enumerate(zip(v, got[k])):
            if w is None:
                assert g is None, (what, k, part)
            else:
                _assert_leaves(w, g, f"{what} {k} {'oks' if part == 0 else 'errs'}")
    assert (df.retries, df._scale) == (want["retries"], want["scale"]), what
    if df.mesh is None:
        _assert_leaves(want["state"], df.state, f"{what} state")
    else:
        for w, part in enumerate(interop.split_leaves(want["state"], df.n_shards)):
            _assert_leaves(part, df.state[w], f"{what} state of worker {w}")
    assert {i: df.peek(i) for i in df.index_traces} == want["peek"], what
    assert df.operator_rates() == want["rates"], what
    assert [r[:-1] for r in df.arrangement_info()] == want["info"], what


def port_dataflow(desc, caps: dict, n_shards: int):
    mesh = make_mesh(n_shards, "cpu") if n_shards > 1 else None
    return TF.FusedDataflow(desc, TF.FusedCaps(**caps), mesh=mesh, operator_logging=True,
                            device="cpu")


def carry_from_jax(desc, caps: dict, want: dict, n_shards: int):
    """A fresh port dataflow holding the JAX dataflow's state after a tick:
    the scale, the state (split over the workers on a mesh), the index
    spines, the frontier, since and the operator counters."""
    df = port_dataflow(desc, caps, n_shards)
    (_f, _o, _n, df._rows_in, df._rows_out, df.retries), = want["rates"]
    df._scale = want["scale"]
    df._build()
    interop.load_fused_state(df, want["state"])
    for idx_id, arr in df.index_traces.items():
        arr.batches = [
            interop.from_numpy(
                TB.empty(cap, TF.torch_dtypes(kd), TF.torch_dtypes(vd), device="cpu"),
                leaves, device="cpu")
            for leaves, cap, kd, vd in want["spines"][idx_id]
        ]
    for idx_id, arr in df.index_errs.items():
        arr.batches = [
            interop.from_numpy(TB.empty(cap, (), TF.torch_dtypes(vd), device="cpu"),
                               leaves, device="cpu")
            for leaves, cap, vd in want["errs_spines"][idx_id]
        ]
    df.frontier, df.since = want["frontier"], want["since"]
    for arr in (*df.index_traces.values(), *df.index_errs.values()):
        arr.compact(df.since)
    return df


@pytest.mark.parametrize("n_shards", [1, N_MESH])
@pytest.mark.parametrize("config", ["bids_sum_count", "auctions_join_bids",
                                    "max_bid_per_auction"])
def test_auction_config_byte_identical_to_jax(config, n_shards, jax_mesh_state_placed):
    inputs = auction_inputs()
    what = f"{config} on {n_shards} workers,"
    caps = {**CAPS[config], **(MESH_CAPS.get(config, {}) if n_shards > 1 else {})}
    compact = COMPACT.get(config)
    jax_retries0, retries0 = _jax_retries(), overflow_retries()
    want = run_jax(getattr(JA, config)(), caps, inputs, compact, n_shards)
    jax_retries = _jax_retries() - jax_retries0

    desc = getattr(TA, config)()
    sources = list(desc.source_imports)
    df = port_dataflow(desc, caps, n_shards)
    for i, (tick, inp) in enumerate(zip(TICKS, inputs)):
        res = df.step(tick, _batches(inp, sources, lambda *a: TB.build(*a, device="cpu")))
        if compact and tick == compact[0]:
            df.compact(compact[1])
        check_tick(df, res, want[i], f"{what} tick {tick}")

    # the view is right, not only equal: a NumPy oracle over the input
    assert df.peek(_index_id(desc)) == oracle(config, inputs)
    if config == "auctions_join_bids" and n_shards == 1:
        assert want[0]["retries"] == 1 and want[-1]["scale"] == 2
    # on the mesh every retry is an overflow retry, counted in both metrics
    assert overflow_retries() - retries0 == (df.retries if n_shards > 1 else 0) == jax_retries
    if n_shards > 1 and "bucket" in caps:
        assert want[0]["retries"] == 1
    if compact:
        # +/- pairs of a bid at two times cancel only once a merge advanced
        # both times to `since`: the topk arrangement holds fewer rows than
        # were ever inserted and retracted
        (n_rows,) = [r[5] for r in df.arrangement_info() if r[0] == "fused"]
        assert n_rows < sum(len(inp["bids"][2]) for inp in inputs)

    # the JAX state after CARRY_AFTER, carried across, continues identically
    df = carry_from_jax(desc, caps, want[CARRY_AFTER - 1], n_shards)
    for i, (tick, inp) in enumerate(zip(TICKS, inputs)):
        if tick <= CARRY_AFTER:
            continue
        res = df.step(tick, _batches(inp, sources, lambda *a: TB.build(*a, device="cpu")))
        if compact and tick == compact[0]:
            df.compact(compact[1])
        check_tick(df, res, want[i], f"{what} carried, tick {tick}")


def oracle(config: str, inputs: list) -> list:
    """The view from scratch over the consolidated input, in peek order."""
    live: dict = {"bids": {}, "auctions": {}}
    for inp in inputs:
        for src, (cols, _t, diffs) in inp.items():
            for row, d in zip(zip(*(c.tolist() for c in cols)), diffs.tolist()):
                live[src][row] = live[src].get(row, 0) + d
    bids = [r for r, d in live["bids"].items() for _ in range(d)]
    auctions = [r for r, d in live["auctions"].items() for _ in range(d)]
    if config == "bids_sum_count":
        agg: dict = {}
        for b in bids:
            s, n = agg.get(b[2], (0, 0))
            agg[b[2]] = (s + b[3], n + 1)
        return sorted((k, s, n) for k, (s, n) in agg.items())
    if config == "auctions_join_bids":
        return sorted(a + b for a in auctions for b in bids if a[0] == b[2])
    best: dict = {}
    for b in bids:  # largest amount, ties to the smallest bid id
        cur = best.get(b[2])
        if cur is None or (-b[3], b) < (-cur[3], cur):
            best[b[2]] = b
    return sorted(best.values())


def test_auction_generator_matches_jax():
    jg, tg = JGen(5, 3), TGen(5, 3, device="cpu")
    for tick in range(1, 4):
        jb, tb = jg.next_tick(tick, 40), tg.next_tick(tick, 40)
        for src in ("auctions", "bids"):
            _assert_leaves(_jleaves(jb[src]), tb[src], f"tick {tick} {src}")


def _unsupported(lir, col, agg):
    get = lir.Get("bids")
    return {
        "LetRec": lir.LetRec(bindings=(("r", get, ()),), body=lir.Get("r"), body_dtypes=(),
                             external_ids=("bids",), ext_dtypes=()),
        "TemporalFilter": lir.TemporalFilter(get, lowers=(col(4),), uppers=()),
        "BasicAgg": lir.BasicAgg(get, key_cols=(2,), func="string_agg", extra=(None, 0, None)),
        # the JAX package renders only generate_series through the fused path
        "FlatMap": lir.FlatMap(get, "unnest_list", (col(0),)),
        "Reduce over them": lir.Reduce(lir.FlatMap(get, "unnest_list", (col(0),)), (0,),
                                       (agg("count", col(0)),)),
    }


@pytest.mark.parametrize("node", ["LetRec", "TemporalFilter", "BasicAgg", "FlatMap",
                                  "Reduce over them"])
def test_unsupported_nodes_raise_in_both(node):
    for lir, fused, col, agg, auction, kw in (
        (jlir, JF, JColumn, JAgg, JA, {}),
        (tlir, TF, TColumn, TAgg, TA, {"device": "cpu"}),
    ):
        plan = _unsupported(lir, col, agg)[node]
        desc = lir.DataflowDescription(
            source_imports={"bids": auction.BIDS_DTYPES},
            objects_to_build=[lir.BuildDesc("mv", plan, auction.BIDS_DTYPES)],
            index_exports={"idx": ("mv", (0,))},
        )
        with pytest.raises(fused.FusedUnsupported):
            fused.FusedDataflow(desc, **kw)
