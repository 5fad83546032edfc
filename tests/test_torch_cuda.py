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
