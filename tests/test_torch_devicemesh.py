"""The port's device exchange plane: policy, metrics and fixed-capacity steps.

The checks of tests/test_devicemesh.py's fast tier, on the port: the
`exchange_backend` modes of `resolve_exchange_mesh` (against the JAX
package's where both decide alike; on the CPU the port forms no mesh of its
own and never falls back to the CPU), the `mz_device_mesh` rows, the
setting's validation in the Coordinator, the host mode's force-disable with
a mesh on offer, and `mesh_tick`'s `mzt_device_exchange_*` metrics over an
exchange on 2 CPU workers. Then one seeded differential of
parallel/fused.py's three steps against the JAX package's, byte for byte,
and a stress test of the workers' turns (more workers than cores, a short
switch interval).
"""

import importlib
import sys
import time
import tracemalloc

import numpy as np
import pytest
import torch

from materialize_tpu.parallel import make_mesh as jax_mesh
from materialize_tpu.repr import UpdateBatch as JB
from materialize_tpu_torch import interop
from materialize_tpu_torch.adapter import Coordinator as TCoord
from materialize_tpu_torch.arrangement.spine import arrange_batch
from materialize_tpu_torch.dataflow.fused import FusedDataflow
from materialize_tpu_torch.obs import REGISTRY
from materialize_tpu_torch.ops.reduce import AccumState, AggregateExpr
from materialize_tpu_torch.parallel import devicemesh as DM
from materialize_tpu_torch.parallel import fused as PF
from materialize_tpu_torch.parallel.devicemesh import mesh as DMM
from materialize_tpu_torch.parallel.mesh import make_mesh
from materialize_tpu_torch.repr.batch import UpdateBatch as TB
from materialize_tpu_torch.repr.hashing import PAD_HASH

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


def test_resolve_exchange_mesh_modes():
    jdm = importlib.import_module("materialize_tpu.parallel.devicemesh")
    assert DM.EXCHANGE_MODES == jdm.EXCHANGE_MODES == ("auto", "host", "device")
    m, jm = make_mesh(4, "cpu"), jax_mesh(4)
    # host: force-disable, even with a mesh on offer
    assert DM.resolve_exchange_mesh("host") is None is jdm.resolve_exchange_mesh("host")
    assert DM.resolve_exchange_mesh("host", m) is None is jdm.resolve_exchange_mesh("host", jm)
    # device and auto: the mesh given, as it is
    assert DM.resolve_exchange_mesh("device", m) is m
    assert DM.resolve_exchange_mesh("auto", m) is m
    # auto without a mesh: none on the CPU, in both packages
    assert DM.resolve_exchange_mesh("auto") is None is jdm.resolve_exchange_mesh("auto")
    assert DM.resolve_exchange_mesh("auto", device="cpu") is None
    # device without a mesh: one over every CUDA device, none here; never the CPU
    assert DM.local_device_count() == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DM.resolve_exchange_mesh("device")
    for bad in ("chip", "HOST"):
        with pytest.raises(ValueError, match="exchange_backend"):
            DM.resolve_exchange_mesh(bad)
        with pytest.raises(ValueError, match="exchange_backend"):
            jdm.resolve_exchange_mesh(bad)


def test_auto_forms_a_mesh_only_for_cuda_with_several_devices(monkeypatch):
    """The auto rule's device side, without a card: the CUDA device count
    and make_mesh stand in for two visible devices."""
    two = (torch.device("cuda", 0), torch.device("cuda", 1))
    monkeypatch.setattr(DMM, "local_device_count", lambda: 2)
    monkeypatch.setattr(DMM, "make_mesh", lambda n: two[:n])
    assert DM.resolve_exchange_mesh("auto") == two
    assert DM.resolve_exchange_mesh("device") == two
    assert DM.resolve_exchange_mesh("auto", device="cpu") is None
    monkeypatch.setattr(DMM, "local_device_count", lambda: 1)
    assert DM.resolve_exchange_mesh("auto") is None
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        DM.form_device_mesh(2)


def test_device_mesh_rows(monkeypatch):
    jdm = importlib.import_module("materialize_tpu.parallel.devicemesh")
    want_types = [type(v) for v in jdm.device_mesh_rows(jax_mesh(4), "device")[0]]
    # a CPU mesh lists its device, a member
    rows = DM.device_mesh_rows(make_mesh(4, "cpu"), "device")
    assert rows == [(0, "cpu:0", "cpu", "workers", 4, True, "device")]
    assert [type(v) for v in rows[0]] == want_types
    assert DM.device_mesh_rows(None, "host") == []
    # two visible CUDA devices, the mesh on one of them: both listed, one a member
    monkeypatch.setattr(DMM, "local_device_count", lambda: 2)
    rows = DM.device_mesh_rows((torch.device("cuda", 1),) * 3, "auto")
    assert rows == [(0, "gpu:0", "gpu", "workers", 3, False, "auto"),
                    (1, "gpu:1", "gpu", "workers", 3, True, "auto")]
    assert [r[3:5] for r in DM.device_mesh_rows(None, "host")] == [("", 0)] * 2


def test_exchange_backend_setting_validated():
    from materialize_tpu_torch.sql.plan import PlanError

    c = TCoord(device="cpu")
    assert c.execute("SHOW exchange_backend").rows == [("auto",)]
    for mode in DM.EXCHANGE_MODES:
        c.execute(f"ALTER SYSTEM SET exchange_backend = {mode}")
        assert c.execute("SHOW exchange_backend").rows == [(mode,)]
    with pytest.raises(PlanError, match="exchange_backend"):
        c.execute("ALTER SYSTEM SET exchange_backend = chip")
    assert c.execute("SHOW exchange_backend").rows == [("device",)]


def test_exchange_backend_host_is_inert_with_mesh():
    """A coordinator holding a mesh renders single-worker fused dataflows
    under exchange_backend = host, with the results of a plain one."""
    host = TCoord(device="cpu")
    c = TCoord(mesh=make_mesh(4, "cpu"), device="cpu")
    c.execute("ALTER SYSTEM SET enable_fused_render = true")
    c.execute("ALTER SYSTEM SET exchange_backend = host")
    for cc in (host, c):
        cc.execute("CREATE TABLE t (a int, b int)")
        cc.execute("INSERT INTO t VALUES (1, 2), (3, 4), (1, 6)")
        cc.execute("CREATE MATERIALIZED VIEW mv AS SELECT a, sum(b) FROM t GROUP BY a")
    (df,) = [df for _g, df, _s in c.dataflows]
    assert isinstance(df, FusedDataflow) and df.n_shards == 1 and df.mesh is None
    for cc in (host, c):
        cc.execute("DELETE FROM t WHERE a = 3")
    a, b = (sorted(cc.execute("SELECT * FROM mv").rows) for cc in (host, c))
    assert a == b == [(1, 8)]


def test_mesh_tick_exchange_roundtrip_and_metrics():
    """mesh_tick is where a mesh tick is built: it counts the build and the
    mesh's width, once; the exchange delivers every live row to the worker
    owning its hash, and a worker's send past its bucket raises the flag."""
    def samples(name):
        return {labels: v for fam in REGISTRY.families() if fam.name == name
                for labels, v in fam.samples}

    axis = (("axis", "workers"),)
    programs0 = samples("mzt_device_exchange_programs_total").get(axis, 0)
    k = np.arange(32, dtype=np.int64)
    keyed = arrange_batch(TB.build((), (k, k * 3), np.zeros(32), np.ones(32, np.int64),
                                   device="cpu"), (0,))
    mesh = make_mesh(2, "cpu")
    parts = [keyed, TB.empty(32, keyed_dtypes(keyed), (torch.int64, torch.int64), "cpu")]

    def go(comm, b, bucket):
        return DM.exchange(b, comm, 2, bucket)

    run = DM.mesh_tick(go, mesh)
    assert samples("mzt_device_exchange_programs_total")[axis] == programs0 + 1
    assert samples("mzt_device_exchange_mesh_devices")[axis] == 2
    out = run(parts, (32, 32))
    assert samples("mzt_device_exchange_programs_total")[axis] == programs0 + 1
    assert not any(bool(f) for _b, f in out)
    n_live = 0
    for w, (b, _f) in enumerate(out):
        live = b.live
        n_live += int(live.sum())
        assert bool(((b.hashes[live] % 2) == w).all())
        assert bool((b.hashes[~live] == PAD_HASH).all())
    assert n_live == 32  # nothing lost
    # 32 rows from worker 0 into buckets of 8: its send overflows, 1's does not
    assert [bool(f) for _b, f in run(parts, (8, 8))] == [True, False]


def keyed_dtypes(b) -> tuple:
    return tuple(c.dtype for c in b.keys)


def _jleaves(obj) -> list:
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(obj)]


def _same(want, got, what: str) -> None:
    want, got = _jleaves(want), interop.to_numpy(got)
    assert len(want) == len(got), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes(), (what, i)


def test_parallel_fused_steps_byte_identical_to_jax():
    """arrangement_insert, fused_accumulable_step and fused_join_delta on one
    seeded input each, with an overflow and without, against the JAX
    package's parallel/fused.py."""
    jpf = importlib.import_module("materialize_tpu.parallel.fused")
    jre = importlib.import_module("materialize_tpu.ops.reduce")
    jspine = importlib.import_module("materialize_tpu.arrangement.spine")
    from materialize_tpu.expr import Column as JColumn
    from materialize_tpu_torch.expr import Column as TColumn

    rng = np.random.default_rng(10)

    def batch(n, cap, t):
        cols = (rng.integers(0, 6, n).astype(np.int64), rng.integers(-50, 50, n).astype(np.int64))
        diffs = rng.choice([1, 1, 2, -1], n).astype(np.int64)
        times = np.full(n, t)
        return (arrange_batch(TB.build((), cols, times, diffs, cap=cap, device="cpu"), (0,)),
                jspine.arrange_batch(JB.build((), cols, times, diffs, cap=cap), (0,)))

    (ta, ja), (td, jd) = batch(20, 32, 1), batch(12, 16, 2)
    for cap in (32, 8):  # 8: the merge holds more live rows than fit
        t_arr, t_over = PF.arrangement_insert(ta.with_capacity(cap) if cap < 32 else ta, td)
        j_arr, j_over = jpf.arrangement_insert(ja.with_capacity(cap) if cap < 32 else ja, jd)
        _same(j_arr, t_arr, f"arrangement_insert at {cap}")
        assert bool(t_over) == bool(j_over) == (cap == 8)

    aggs_t = (AggregateExpr("sum", TColumn(1)), AggregateExpr("count", TColumn(1)))
    aggs_j = (jre.AggregateExpr("sum", JColumn(1)), jre.AggregateExpr("count", JColumn(1)))
    for cap in (16, 2):  # 2: fewer slots than groups
        t_state = AccumState.empty(cap, (torch.int64,), (torch.int64, torch.int64), "cpu")
        j_state = jre.AccumState.empty(cap, (np.dtype(np.int64),), (np.dtype(np.int64),) * 2)
        t_out = PF.fused_accumulable_step(t_state, ta, (0,), aggs_t, 3)
        j_out = jpf.fused_accumulable_step(j_state, ja, (0,), aggs_j, 3)
        for what, w, g in zip(("state", "out", "errs"), j_out[:3], t_out[:3]):
            _same(w, g, f"fused_accumulable_step at {cap}: {what}")
        assert bool(t_out[3]) == bool(j_out[3]) == (cap == 2)

    for out_cap, swap in ((64, False), (16, True)):  # 16: fewer than the matches
        t_j, t_over = PF.fused_join_delta(td, ta, out_cap, swap)
        j_j, j_over = jpf.fused_join_delta(jd, ja, out_cap, swap)
        _same(j_j, t_j, f"fused_join_delta at {out_cap}")
        assert bool(t_over) == bool(j_over) == (out_cap == 16)


def test_turns_deliver_every_row_under_a_short_switch_interval():
    """More workers than cores, a short switch interval and many exchanges
    in a row: every worker must receive exactly what each other worker sent
    it in that exchange (the workers take turns and reuse each exchange's
    buffers two exchanges later), within a time bound."""
    n, rounds = 16, 24
    mesh = make_mesh(n, "cpu")

    def go(comm):
        got = []
        for k in range(rounds):
            # row d of what worker r sends in exchange k: (k, r, d)
            sent = torch.tensor([[k, comm.rank, d] for d in range(n)])
            (recv,) = comm.all_to_all([sent])
            got.append(recv.tolist())
        return got

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        out = DM.mesh_run(go, mesh)
        elapsed = time.perf_counter() - t0
    finally:
        sys.setswitchinterval(before)
    for r, got in enumerate(out):
        assert got == [[[k, s, r] for s in range(n)] for k in range(rounds)], r
    assert elapsed < 60.0
