"""The port's mesh-sharded Q3 tick against the JAX package's, byte for byte.

At the caps and generator of tests/test_parallel.py's 4-shard case
(`test_fused_q3_matches_oracle[4-int32]`): tick 1 hydrates from the initial
tables, then 2 churn ticks. After every tick, every worker's state leaves,
`out`, `errs` and `overflow` must equal the JAX global arrays split on axis
0 (u32 columns widened to int64). Every delta is padded to the tick-1
capacities, so the JAX tick compiles once, in a module-scoped fixture.

Also here, without JAX: a 1-worker mesh equals `q3_tick_single`; a
hydrated state partitioned over 4 workers (`shard_state`, as chip_smoke.py
hydrates at SF1) keeps the view equal to `q3_oracle`; a worker that raises
ends the sharded call within seconds; the launch counters lose no count
under threads.
"""

import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from materialize_tpu.models import fused_q3 as J
from materialize_tpu.parallel import make_mesh as jax_mesh
from materialize_tpu.repr import UpdateBatch as JB
from materialize_tpu.storage import TpchGenerator as JGen
from materialize_tpu_torch import interop
from materialize_tpu_torch.models import fused_q3 as T
from materialize_tpu_torch.models.tpch import q3_oracle
from materialize_tpu_torch.ops.kernels import registry
from materialize_tpu_torch.parallel.devicemesh import exchange, mesh_run
from materialize_tpu_torch.parallel.mesh import make_mesh
from materialize_tpu_torch.repr.batch import UpdateBatch as TB
from materialize_tpu_torch.storage import TpchGenerator as TGen

# One intra-op thread: the suite runs in several test processes at once, and
# torch's default of one thread per core oversubscribes the CPU, which slows
# the many small operators of a tick by orders of magnitude.
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    """An earlier test in this process may have left tracemalloc tracing (the
    /prof/heap endpoint starts it), which makes every allocation ~10x slower."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()

N = 4
TICKS = (1, 2, 3)  # tick 1 hydrates; 2 and 3 are churn ticks
CAPS = dict(cust=1 << 10, orders=1 << 10, lineitem=1 << 12, delta=1 << 8, bucket=1 << 9,
            join_out=1 << 12, groups=1 << 11, val_dtype="int32")


def _deltas(gen, init, tick, empty_c):
    """(customer, orders, lineitem) deltas of `tick`, at the tick-1 capacities."""
    if tick == TICKS[0]:
        return init["customer"], init["orders"], init["lineitem"]
    r = gen.refresh(tick, frac=0.02)
    return (empty_c, r["orders"].with_capacity(init["orders"].cap),
            r["lineitem"].with_capacity(init["lineitem"].cap))


def _leaves(jobj):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jobj)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's 4-shard ticks, as numpy leaves."""
    caps = J.Q3Caps(**CAPS)
    mesh = jax_mesh(N)
    step = J.q3_tick_sharded(mesh, caps)
    # laid out as the tick's outputs are, so every tick reuses one compile
    state = jax.device_put(J.q3_state_global(caps, N), NamedSharding(mesh, P("workers")))
    gen = JGen(sf=0.0005, seed=11, val_dtype=np.dtype("int32"))
    init = gen.initial_batches(1)
    empty_c = JB.empty(init["customer"].cap, (), (np.dtype("int32"),) * 3)
    ticks = []
    for tick in TICKS:
        state, out, errs, over = step(state, *_deltas(gen, init, tick, empty_c), tick)
        ticks.append({"state": _leaves(state), "out": _leaves(out), "errs": _leaves(errs),
                      "over": np.asarray(over)})
    return ticks


def _assert_same(want: list, tobj, what: str):
    got = interop.to_numpy(tobj)
    assert len(got) == len(want), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, (what, i, w.dtype, g.dtype)
        assert w.tobytes() == g.tobytes(), (what, i)


def test_four_worker_tick_byte_identical_to_jax(jax_run):
    caps = T.Q3Caps(**CAPS)
    mesh = make_mesh(N, "cpu")
    step = T.q3_tick_sharded(mesh, caps)
    states = T.q3_state_global(caps, mesh)
    gen = TGen(sf=0.0005, seed=11, val_dtype=np.int32, device="cpu")
    init = gen.initial_batches(1)
    empty_c = TB.empty(init["customer"].cap, (), (torch.int32,) * 3, device="cpu")
    for tick, want in zip(TICKS, jax_run):
        deltas = [T.split_batch(d, mesh) for d in _deltas(gen, init, tick, empty_c)]
        res = step(states, *deltas, tick)
        states = [r[0] for r in res]
        for part, name in enumerate(("state", "out", "errs")):
            per_worker = interop.split_leaves(want[name], N)
            for w in range(N):
                _assert_same(per_worker[w], res[w][part], f"tick {tick} {name} worker {w}")
        over = np.concatenate([r[3].numpy() for r in res])
        assert over.tobytes() == want["over"].tobytes() and not over.any()
    # the global state carried back equals the JAX one
    joined = interop.join_leaves([interop.to_numpy(s) for s in states])
    assert all(a.tobytes() == b.tobytes() for a, b in zip(joined, jax_run[-1]["state"]))
    view = {}
    for s in states:
        part = T.read_view(s)
        assert not set(part) & set(view)  # every group has one owner
        view.update(part)
    assert view == q3_oracle(gen._customer, gen._orders_store, gen._lineitem_store)


def _tpch(sf=0.0005):
    gen = TGen(sf=sf, seed=11, val_dtype=np.int32, device="cpu")
    return gen, gen.initial_batches(1)


def test_one_worker_mesh_equals_single_tick():
    # a bucket as large as the largest delta: one worker receives every row
    caps = T.Q3Caps(**{**CAPS, "delta": 1 << 10, "bucket": 1 << 12})
    mesh = make_mesh(1, "cpu")
    runs = []
    for sharded in (False, True):
        gen, init = _tpch()
        empty_c = TB.empty(8, (), (torch.int32,) * 3, device="cpu")
        state, got = T.Q3State.empty(caps, device="cpu"), []
        for tick in TICKS:
            deltas = _deltas(gen, init, tick, empty_c)
            if sharded:
                ((state, out, errs, over),) = T.q3_tick_sharded(mesh, caps)(
                    [state], *([d] for d in deltas), tick)
            else:
                state, out, errs, over = T.q3_tick_single(caps)(state, *deltas, tick)
            got.append([interop.to_numpy(x) for x in (state, out, errs)] + [over.numpy()])
        runs.append(got)
    for single, sharded in zip(*runs):
        for a, b in zip(single[:3], sharded[:3]):
            assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
        assert single[3].tobytes() == sharded[3].tobytes()


def test_partitioned_hydration_keeps_the_view_exact():
    one = T.Q3Caps(cust=256, orders=1024, lineitem=2048, delta=512, join_out=2048,
                   groups=2048, val_dtype="int32")
    per_worker = T.Q3Caps(cust=64, orders=256, lineitem=512, delta=128, bucket=256,
                          join_out=512, groups=512, val_dtype="int32")
    gen, init = _tpch(sf=0.0002)
    state = T.hydrate(T.Q3State.empty(one, device="cpu"), init["customer"], init["orders"],
                      init["lineitem"], 1)
    mesh = make_mesh(N, "cpu")
    states = T.shard_state(state, per_worker, mesh)
    for w, s in enumerate(states):
        for lvl in s.li_by_ok.levels:
            assert bool(((lvl.hashes % N == w) | ~lvl.live).all())
    assert sum(len(T.read_view(s)) for s in states) == len(T.read_view(state))
    step = T.q3_tick_sharded(mesh, per_worker, with_cust=False)
    empty_c = TB.empty(8, (), (torch.int32,) * 3, device="cpu")
    for tick in (2, 3, 4):
        r = gen.refresh(tick, frac=0.05)
        res = step(states, T.split_batch(empty_c, mesh), T.split_batch(r["orders"], mesh),
                   T.split_batch(r["lineitem"], mesh), tick)
        states = [x[0] for x in res]
        assert not any(bool(x[3].any()) for x in res)
        assert all(int(x[2].count()) == 0 for x in res)
    view = {}
    for s in states:
        view.update(T.read_view(s))
    assert view == q3_oracle(gen._customer, gen._orders_store, gen._lineitem_store)


@pytest.mark.parametrize("when", ["before_the_first_exchange", "between_exchanges"])
def test_a_failing_worker_ends_the_sharded_call_within_seconds(when):
    mesh = make_mesh(N, "cpu")
    batch = TB.build((np.arange(64),), (np.arange(64),), np.zeros(64), np.ones(64),
                     device="cpu")

    def fn(comm, b):
        if when == "between_exchanges":
            b, _ = exchange(b, comm, N, 64)
        if comm.rank == 2:
            raise RuntimeError("worker 2 failed")
        exchange(b, comm, N, 64)
        return comm.rank

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker 2 failed"):
        mesh_run(fn, mesh, T.split_batch(batch, mesh))
    assert time.monotonic() - t0 < 5.0
    assert not [t for t in threading.enumerate() if t.name.startswith("mesh-worker")]


def test_launch_counters_lose_no_count_under_threads():
    registry.reset_launches()
    registry.SAMPLES = {}
    n_threads, per_thread = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(per_thread):
                registry.launch("route_dest", (), (8, 4))

        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        samples, registry.SAMPLES = registry.SAMPLES, None
    assert registry.LAUNCHES["route_dest"] == n_threads * per_thread
    assert samples["route_dest"]["shapes"][(8, 4)] == n_threads * per_thread
    registry.reset_launches()


def test_make_mesh_puts_workers_round_robin_and_never_falls_back():
    assert make_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert make_mesh(2, torch.device("meta")) == (torch.device("meta"),) * 2
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh(4))
    else:
        with pytest.raises(RuntimeError):
            make_mesh(4)
