"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: without a CUDA device every test here skips. This file
imports neither jax nor the JAX package, so it runs on a machine without
them; tests/conftest.py imports jax, hence `--noconftest` there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from materialize_tpu_torch.ops.kernels import permute, probe, registry, route, segsum


def _chip_smoke():
    """chip_smoke.py, whose kernel cases these tests share."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _take_cols(rng, n):
    return (
        rng.integers(-(2**50), 2**50, n).astype(np.int64),
        rng.integers(-(2**31), 2**31, n).astype(np.int32),
        rng.random(n) < 0.5,
        rng.integers(-128, 128, n).astype(np.int8),
        rng.random(n).astype(np.float32),
    )


def _run_sum_case(rng, n, layout):
    flags = {
        "one_run": np.arange(n) == 0,
        "singletons": np.ones(n, dtype=bool),
        "no_start_at_0": (rng.random(n) < 0.3) & (np.arange(n) > 0),
        "random": (rng.random(n) < 0.3) | (np.arange(n) == 0),
    }[layout]
    cols = (
        rng.integers(-(2**62), 2**62, n).astype(np.int64),
        rng.integers(-(2**31), 2**31, n).astype(np.int32),
    )
    return flags, cols


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions(cuda_device):
    rng = np.random.default_rng(0)
    registry.reset_launches()
    for n, m in ((1, 3), (100, 1000), (70_000, 5000), (3_000_000, 1 << 20)):
        a = torch.from_numpy(np.sort(rng.integers(0, 50, n))).to(cuda_device)
        q = torch.from_numpy(rng.integers(-2, 55, m)).to(cuda_device)
        for side in ("left", "right"):
            assert torch.equal(probe.probe(a, q, side), probe.plain_searchsorted(a, q, side))
            assert torch.equal(probe.probe2(a, a, q, q, side),
                               probe.plain_searchsorted2(a, a, q, q, side))
        cols = tuple(torch.from_numpy(c).to(cuda_device) for c in _take_cols(rng, n))
        idx = torch.from_numpy(rng.integers(-5, n + 5, m)).to(cuda_device)
        for g, w in zip(permute.multi_take(cols, idx), permute.plain_multi_take(cols, idx)):
            assert torch.equal(g, w)
        for layout in ("one_run", "singletons", "no_start_at_0", "random"):
            flags, ints = _run_sum_case(rng, n, layout)
            rs = torch.from_numpy(flags).to(cuda_device)
            ints = tuple(torch.from_numpy(c).to(cuda_device) for c in ints)
            for g, w in zip(segsum.run_sum(rs, ints), segsum.plain_run_sum(rs, ints)):
                assert torch.equal(g, w)
        h = torch.from_numpy(rng.integers(0, 1 << 32, n)).to(cuda_device)
        for n_dest in (1, 3, 4, 8):
            assert torch.equal(route.route_dest(h, n_dest), route.plain_route_dest(h, n_dest))
            keys = torch.from_numpy(rng.integers(0, n_dest + 1, n).astype(np.int32))
            for k in (keys, keys.sort().values):  # unsorted and sorted
                k = k.to(cuda_device)
                assert torch.equal(route.bucket_rank(k), route.plain_bucket_rank(k))
    torch.cuda.synchronize()
    assert all(registry.LAUNCHES[k] > 0 for k in registry.KERNELS)


@pytest.mark.cuda
def test_cuda_multi_take_of_more_columns_than_one_launch_takes(cuda_device):
    cols, idx = _chip_smoke().wide_take_case(np.random.default_rng(2))
    cols = tuple(torch.from_numpy(c).to(cuda_device) for c in cols)
    idx = torch.from_numpy(idx).to(cuda_device)
    for g, w in zip(permute.multi_take(cols, idx), permute.plain_multi_take(cols, idx)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_run_sum_refuses_float_columns(cuda_device):
    rs = torch.ones(4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(NotImplementedError):
        segsum.run_sum(rs, (torch.ones(4, device=cuda_device),))


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_device_from_another_thread():
    """Each kernel on cuda:1, called from a thread whose current device is
    cuda:0, runs on cuda:1's stream and equals its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(1)
    n = 100_000
    a = torch.from_numpy(np.sort(rng.integers(0, 1 << 32, n))).to(dev)
    q = torch.from_numpy(rng.integers(0, 1 << 32, n)).to(dev)
    rs = torch.from_numpy(rng.random(n) < 0.3).to(dev)
    keys = torch.from_numpy(np.sort(rng.integers(0, 5, n)).astype(np.int32)).to(dev)
    calls = {
        "probe": (lambda: probe.probe(a, q), lambda: probe.plain_searchsorted(a, q)),
        "probe2": (lambda: probe.probe2(a, a, q, q), lambda: probe.plain_searchsorted2(a, a, q, q)),
        "multi_take": (lambda: permute.multi_take((a, q), q % n),
                       lambda: permute.plain_multi_take((a, q), q % n)),
        "run_sum": (lambda: segsum.run_sum(rs, (q,)), lambda: segsum.plain_run_sum(rs, (q,))),
        "route_dest": (lambda: route.route_dest(q, 4), lambda: route.plain_route_dest(q, 4)),
        "bucket_rank": (lambda: route.bucket_rank(keys), lambda: route.plain_bucket_rank(keys)),
    }
    errors = []

    def body():
        try:
            torch.cuda.set_device(0)
            for name, (kernel, plain) in calls.items():
                got, want = kernel(), plain()
                torch.cuda.synchronize(dev)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    errors.append(name)
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(repr(e))

    registry.reset_launches()
    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert not errors, errors
    assert all(registry.LAUNCHES[k] > 0 for k in registry.KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
def test_cuda_probe2_every_branch_equals_plain(cuda_device, side):
    """The staged probe2 at chip_smoke.py's cases for every branch of its
    kernel: a window that fits, one too large, a dense wide one, all-equal
    padding tiles,
    unsorted tiles, ties on hi broken on lo, a ragged last tile, n = 1,
    m = 1, m below a tile below n, and negative queries."""
    smoke = _chip_smoke()
    cases = smoke.probe2_cases(np.random.default_rng(3), *smoke.kernel_shapes()["probe2"])
    for name, arrays in cases.items():
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device) for x in arrays]
        got = probe.probe2(*t, side)
        torch.cuda.synchronize()
        assert torch.equal(got, probe.plain_searchsorted2(*t, side)), name


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
def test_cuda_probe_every_branch_equals_plain(cuda_device, side):
    """The tile-staged probe at chip_smoke.py's cases for every branch of its
    kernel, at the kernel's own tile and window: all-equal padding tiles, a
    window that fits, wide windows searched through a staged sample (dense,
    with one sparse warp, sparse), unsorted tiles, duplicate runs across
    warps, a prefix sum searched by `arange`, a ragged last tile, n = 1,
    m = 1, m below a tile below n, and negative queries."""
    smoke = _chip_smoke()
    cases = smoke.probe_cases(np.random.default_rng(4), *smoke.kernel_shapes()["probe"])
    for name, (a, q) in cases.items():
        a, q = (torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device) for x in (a, q))
        got = probe.probe(a, q, side)
        torch.cuda.synchronize()
        assert torch.equal(got, probe.plain_searchsorted(a, q, side)), name


@pytest.mark.cuda
def test_cuda_run_sum_edge_cases_equal_plain(cuda_device):
    """The one-pass run_sum at chip_smoke.py's cases: a run over 5 tiles, runs
    ending at tile edges, rows before the first run start, n = tile - 1,
    tile, tile + 1 and 1, mixed int32/int64 columns, more columns than one
    launch takes, wrapping sums, and a trailing padding run of 1.5 M rows."""
    smoke = _chip_smoke()
    cases = smoke.run_sum_cases(np.random.default_rng(5), *smoke.kernel_shapes()["run_sum"])
    for name, (rs, cols) in cases.items():
        rs = torch.from_numpy(rs).to(cuda_device)
        cols = tuple(torch.from_numpy(c).to(cuda_device) for c in cols)
        got = segsum.run_sum(rs, cols)
        torch.cuda.synchronize()
        for g, w in zip(got, segsum.plain_run_sum(rs, cols)):
            assert torch.equal(g, w), name


@pytest.mark.cuda
def test_cuda_run_sum_from_four_streams_at_once(cuda_device):
    """Four threads call run_sum at once on one device, each on its own
    stream: each result equals the plain version, so no call shares another's
    look-back scratch."""
    results = _chip_smoke().run_sum_concurrent(cuda_device)
    assert len(results) == 4 and all(results.values()), results


@pytest.mark.cuda
def test_cuda_bucket_rank_edge_cases_equal_plain(cuda_device):
    """The one-pass bucket_rank at chip_smoke.py's cases: n = 1, tile - 1,
    tile, tile + 1, run starts on a tile's first or last row, a dead tail
    after short runs, long runs, unsorted keys, a run start at every row, and
    one run over 2,048 tiles."""
    smoke = _chip_smoke()
    cases = smoke.bucket_rank_cases(np.random.default_rng(6),
                                    *smoke.kernel_shapes()["bucket_rank"])
    for name, k in cases.items():
        k = torch.from_numpy(k).to(cuda_device)
        got = route.bucket_rank(k)
        torch.cuda.synchronize()
        assert torch.equal(got, route.plain_bucket_rank(k)), name


@pytest.mark.cuda
def test_cuda_bucket_rank_from_four_streams_at_once(cuda_device):
    """Four threads call bucket_rank at once on one device, each on its own
    stream, as the mesh's workers do: each result equals the plain version."""
    results = _chip_smoke().bucket_rank_concurrent(cuda_device)
    assert len(results) == 4 and all(results.values()), results


@pytest.mark.cuda
def test_cuda_launch_runs_on_the_current_stream(cuda_device):
    """A kernel launched inside `torch.cuda.stream(s)` runs on `s`: it sees a
    write queued on `s` behind a long sleep, which it would race on another
    stream. The raw handle the launch path takes is the stream's own."""
    dev = torch.cuda.current_device()
    h = torch.zeros(1 << 20, dtype=torch.int64, device=cuda_device)
    new = torch.arange(1 << 20, dtype=torch.int64, device=cuda_device) * 4093  # below 2^32
    s = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s):
        assert torch._C._cuda_getCurrentRawStream(dev) == torch.cuda.current_stream(dev).cuda_stream
        assert torch.cuda.current_stream(dev).cuda_stream == s.cuda_stream
        torch.cuda._sleep(200_000_000)  # ~0.1 s of device cycles
        h.copy_(new)
        got = route.route_dest(h, 7)
    torch.cuda.synchronize()
    assert torch.equal(got, route.plain_route_dest(new, 7))


@pytest.mark.cuda
def test_cuda_launch_path_still_refuses_bad_input(cuda_device):
    h = torch.arange(8, device=cuda_device)
    with pytest.raises(ValueError):
        route.route_dest(h.to(torch.int32), 4)  # wrong dtype
    with pytest.raises(ValueError):
        probe.probe(h, h.cpu())  # mixed devices
    with pytest.raises(ValueError):
        probe.probe(h, h[::2])  # not contiguous
    with pytest.raises(RuntimeError):  # an error the C side returns
        registry.run("mz_multi_take", h.get_device(), None, None, 0, 8, h.data_ptr(), 8, 8)
    with pytest.raises(RuntimeError):  # ranks are int32: the C side refuses n >= 2^31
        registry.run("mz_bucket_rank", h.get_device(), h.data_ptr(), 2**31, h.data_ptr(), None, 0)
    n = route.bucket_rank_shape()[0] + 1  # two tiles: a ticket and two status words
    with pytest.raises(RuntimeError):  # the C side refuses scratch smaller than that
        registry.run("mz_bucket_rank", h.get_device(), h.data_ptr(), n, h.data_ptr(), h.data_ptr(),
                     route.bucket_rank_scratch_words(n) - 1)


@pytest.mark.cuda
def test_cuda_fused_max_bid_per_auction_equals_cpu(cuda_device):
    """Config 4 (max bid per auction) through FusedDataflow on the card and
    on the CPU, with retractions from tick 3 on and a merge ratio of 2:
    every tick's outputs and state leaves must be equal, and the card's
    ticks must have launched probe, probe2, multi_take and run_sum."""
    from materialize_tpu_torch import interop
    from materialize_tpu_torch.dataflow.fused import FusedCaps, FusedDataflow
    from materialize_tpu_torch.models.auction import max_bid_per_auction
    from materialize_tpu_torch.repr.batch import UpdateBatch
    from materialize_tpu_torch.storage import AuctionGenerator

    caps = FusedCaps(delta=512, arrangement=1 << 13, groups=1 << 12, join_out=1 << 11,
                     gather=1 << 11, ratio=2)
    gen = AuctionGenerator(7, 16, device="cpu", keep_host=True)
    dfs = {d: FusedDataflow(max_bid_per_auction(), caps, device=d) for d in ("cpu", cuda_device)}
    registry.reset_launches()
    for tick in range(1, 9):
        gen.next_tick(tick, 300)
        bids, diffs = gen.host["bids"][-1], np.ones(300, dtype=np.int64)
        if tick >= 3:  # retract 60 bids of two ticks before
            old = tuple(c[:60] for c in gen.host["bids"][tick - 3])
            bids = tuple(np.concatenate([c, o]) for c, o in zip(bids, old))
            diffs = np.concatenate([diffs, -np.ones(60, dtype=np.int64)])
        times = np.full(len(diffs), tick)
        res = {d: df.step(tick, {"bids": UpdateBatch.build((), bids, times, diffs, device=d)})
               for d, df in dfs.items()}
        want, got = res["cpu"]["mv_topk"], res[cuda_device]["mv_topk"]
        assert (want is None) == (got is None), tick
        for w, g in zip(want or (), got or ()):
            assert (w is None) == (g is None), tick
            if w is not None:
                for a, b in zip(interop.to_numpy(w), interop.to_numpy(g)):
                    assert a.tobytes() == b.tobytes(), tick
        for a, b in zip(interop.to_numpy(dfs["cpu"].state),
                        interop.to_numpy(dfs[cuda_device].state)):
            assert a.tobytes() == b.tobytes(), tick
        assert dfs["cpu"].retries == dfs[cuda_device].retries
    assert dfs["cpu"].peek("idx_topk") == dfs[cuda_device].peek("idx_topk")
    for k in ("probe", "probe2", "multi_take", "run_sum"):
        assert registry.LAUNCHES[k] > 0, k


@pytest.mark.cuda
def test_cuda_host_renderer_every_node_kind_equals_cpu(cuda_device):
    """chip_smoke's phase 11: every node kind of runtime.Dataflow (the
    cases of models/operators.py, Q3 at sf 0.001, generate_series through
    FusedDataflow) on the card against the CPU, byte for byte after every
    tick, with probe, probe2, multi_take and run_sum launched."""
    out = _chip_smoke().run_node_cases(cuda_device)
    assert "LetRecNode" in out["node_kinds"] and "DeltaJoinNode" in out["node_kinds"]


@pytest.mark.cuda
def test_cuda_fused_mesh_equals_cpu_mesh(cuda_device):
    """Config 2 (auctions join bids) through FusedDataflow on a 2-worker mesh
    on `cuda:0` and on a 2-worker CPU mesh, with retractions from tick 3 on:
    every tick's outputs, each worker's state leaves and the retries must be
    equal, and the card's ticks must have launched route_dest and
    bucket_rank (the exchange) beside the four kernels of the operators."""
    from materialize_tpu_torch import interop
    from materialize_tpu_torch.dataflow.fused import FusedCaps, FusedDataflow
    from materialize_tpu_torch.models.auction import auctions_join_bids
    from materialize_tpu_torch.parallel.mesh import make_mesh
    from materialize_tpu_torch.repr.batch import UpdateBatch
    from materialize_tpu_torch.storage import AuctionGenerator

    caps = FusedCaps(delta=256, arrangement=1 << 13, groups=1 << 12, join_out=1 << 10,
                     gather=1 << 11, ratio=2)
    gen = AuctionGenerator(7, 16, device="cpu", keep_host=True)
    meshes = {"cpu": make_mesh(2, "cpu"), "cuda": make_mesh(2, torch.device("cuda", 0))}
    dfs = {d: FusedDataflow(auctions_join_bids(), caps, mesh=m, device=m[0])
           for d, m in meshes.items()}
    registry.reset_launches()
    for tick in range(1, 9):
        gen.next_tick(tick, 300)
        bids, diffs = gen.host["bids"][-1], np.ones(300, dtype=np.int64)
        if tick >= 3:  # retract 60 bids of two ticks before
            old = tuple(c[:60] for c in gen.host["bids"][tick - 3])
            bids = tuple(np.concatenate([c, o]) for c, o in zip(bids, old))
            diffs = np.concatenate([diffs, -np.ones(60, dtype=np.int64)])
        auctions = gen.host["auctions"][-1]
        res = {}
        for d, df in dfs.items():
            dev = meshes[d][0]
            res[d] = df.step(tick, {
                "bids": UpdateBatch.build((), bids, np.full(len(diffs), tick), diffs, device=dev),
                "auctions": UpdateBatch.build((), auctions, np.full(16, tick), np.ones(16, np.int64),
                                              device=dev),
            })
        assert set(res["cpu"]) == set(res["cuda"])
        for obj, want in res["cpu"].items():
            got = res["cuda"][obj]
            assert (want is None) == (got is None), (tick, obj)
            for w, g in zip(want or (), got or ()):
                assert (w is None) == (g is None), (tick, obj)
                if w is not None:
                    for a, b in zip(interop.to_numpy(w), interop.to_numpy(g)):
                        assert a.tobytes() == b.tobytes(), (tick, obj)
        for a, b in zip(interop.fused_state_leaves(dfs["cpu"]),
                        interop.fused_state_leaves(dfs["cuda"])):
            assert a.tobytes() == b.tobytes(), tick
        assert dfs["cpu"].retries == dfs["cuda"].retries
    assert dfs["cpu"].peek("idx_join") == dfs["cuda"].peek("idx_join")
    for k in registry.KERNELS:
        assert registry.LAUNCHES[k] > 0, k
