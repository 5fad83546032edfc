"""The port's exchange against the JAX package's, exactly.

- `route_dest` and `bucket_rank`: each plain PyTorch version (the one CPU
  tensors take) equals the JAX XLA oracle and the Pallas kernel in
  interpret mode, at the edge cases chip_smoke.py gives the CUDA kernels;
- `route_to_buckets`: the buckets and the overflow flag, called directly;
- `exchange`: a 4-worker CPU mesh against the JAX `exchange` under
  `shard_map` on 4 of the conftest's 8 CPU devices.

These are integer functions: the tolerance is 0. The JAX exchange is
imported by its module path: once `materialize_tpu.models.fused_q3` is
imported, `materialize_tpu.parallel.exchange` names the submodule.
"""

import importlib
import tracemalloc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from materialize_tpu.ops.kernels.route import (
    _pallas_bucket_rank,
    _pallas_route_dest,
    _xla_bucket_rank,
    _xla_route_dest,
)
from materialize_tpu.parallel import make_mesh as jax_mesh
from materialize_tpu.repr import UpdateBatch as JB
from materialize_tpu_torch import interop
from materialize_tpu_torch.models.fused_q3 import split_batch
from materialize_tpu_torch.ops.kernels import registry, route
from materialize_tpu_torch.parallel.devicemesh import exchange, mesh_run, route_to_buckets
from materialize_tpu_torch.parallel.mesh import make_mesh
from materialize_tpu_torch.repr.batch import UpdateBatch as TB

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

JX = importlib.import_module("materialize_tpu.parallel.devicemesh.exchange")
PAD = 0xFFFFFFFF

try:
    _shard_map = jax.shard_map
except AttributeError:  # older jax spelling
    from jax.experimental.shard_map import shard_map as _shard_map


def _same(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    got = port.cpu().numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes(), (got, ref)


@pytest.mark.parametrize("n_dest", [1, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 2, 7, 4099])
def test_route_dest_plain_equals_jax(n, n_dest):
    rng = np.random.default_rng(n * 10 + n_dest)
    h = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    h[: min(n, 3)] = np.array([0, 1 << 31, PAD], dtype=np.uint32)[: min(n, 3)]
    got = route.plain_route_dest(torch.from_numpy(h.astype(np.int64)), n_dest)
    _same(got, _xla_route_dest(jnp.asarray(h), n_dest))
    _same(got, _pallas_route_dest(jnp.asarray(h), n_dest))


def _keys(rng, kind: str, n: int, n_dest: int = 4) -> np.ndarray:
    if kind == "sorted":  # destinations in order, dead rows keyed n_dest last
        k = np.sort(rng.integers(0, n_dest + 1, n))
    elif kind == "all_dead":
        k = np.full(n, n_dest)
    elif kind == "one_run":
        k = np.zeros(n)
    else:  # unsorted: the function is defined on every input
        k = rng.integers(0, n_dest + 1, n)
    return k.astype(np.int32)


@pytest.mark.parametrize("kind", ["sorted", "all_dead", "one_run", "unsorted"])
@pytest.mark.parametrize("n", [1, 2, 7, 5000])
def test_bucket_rank_plain_equals_jax(n, kind):
    k = _keys(np.random.default_rng(n + len(kind)), kind, n)
    got = route.plain_bucket_rank(torch.from_numpy(k))
    _same(got, _xla_bucket_rank(jnp.asarray(k)))
    _same(got, _pallas_bucket_rank(jnp.asarray(k)))


@pytest.mark.parametrize("n, words", [(1, 0), (7, 0), (8, 0), (9, 3 * 4), (17, 4 * 4)])
def test_bucket_rank_scratch_words(n, words):
    """A ticket and a status word a tile, 4 words apart at tiles of 8 rows;
    none for a call of one tile."""
    assert route.bucket_rank_scratch_words(n, (8, 4)) == words


def test_route_wrappers_on_empty_and_bad_input():
    registry.reset_launches()
    empty = torch.empty(0, dtype=torch.int64)
    assert route.route_dest(empty, 4).dtype == torch.int32
    assert route.route_dest(empty, 4).shape == (0,)
    assert route.bucket_rank(empty.to(torch.int32)).shape == (0,)
    assert route.bucket_rank(empty.to(torch.int32)).dtype == torch.int32
    with pytest.raises(ValueError):
        route.route_dest(torch.arange(3), 0)
    assert registry.LAUNCHES == {k: 0 for k in registry.KERNELS}


def _columns(seed: int, n: int):
    """Key and value columns, times and diffs with dead and padded rows."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1000, n).astype(np.int64)
    v = rng.integers(-(2**40), 2**40, n).astype(np.int64)
    times = rng.integers(0, 9, n)
    diffs = rng.integers(-2, 3, n).astype(np.int64)  # some 0: dead rows
    return (k,), (k, v), times, diffs


def _batches(seed: int, n: int, cap: int):
    cols = _columns(seed, n)
    return JB.build(*cols, cap=cap), TB.build(*cols, cap=cap, device="cpu")


@pytest.mark.parametrize("n_dest,bucket", [(1, 64), (3, 32), (4, 32), (4, 4)])
def test_route_to_buckets_equals_jax(n_dest, bucket):
    jb, tb = _batches(n_dest * 100 + bucket, 50, 64)
    jbuckets, jover = JX.route_to_buckets(jb, n_dest, bucket)
    tbuckets, tover = route_to_buckets(tb, n_dest, bucket)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jbuckets)]
    got = interop.to_numpy(tbuckets)
    assert [w.shape for w in want] == [g.shape for g in got] and len(want) == len(got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
    assert bool(tover) == bool(jover) == (bucket == 4)


@pytest.mark.parametrize("bucket", [32, 4])
def test_exchange_on_four_workers_equals_jax_shard_map(bucket):
    n = 4
    jb, tb = _batches(bucket, 200, 256)

    def go(b):
        out, over = JX.exchange(b, "workers", n, bucket)
        return out, over.reshape((1,))

    f = jax.jit(_shard_map(go, mesh=jax_mesh(n), in_specs=(P("workers"),),
                           out_specs=(P("workers"), P("workers"))))
    jout, jover = f(jb)
    want = interop.split_leaves(jax.tree_util.tree_leaves(jout), n)

    mesh = make_mesh(n, "cpu")
    res = mesh_run(lambda comm, b: exchange(b, comm, n, bucket), mesh, split_batch(tb, mesh))
    for w, (out, over) in enumerate(res):
        got = interop.to_numpy(out)
        assert len(got) == len(want[w])
        for a, b in zip(want[w], got):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        assert bool(over) == bool(np.asarray(jover)[w])
    assert bool(np.asarray(jover).any()) == (bucket == 4)
    # every live row arrived at its owner, none lost while nothing overflowed
    if bucket == 32:
        live = sum(int(out.count()) for out, _ in res)
        assert live == int(tb.count())
        for w, (out, _) in enumerate(res):
            assert bool(((out.hashes % n == w) | ~out.live).all())
