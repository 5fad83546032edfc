"""The port's representation layer against the JAX package's, exactly.

Hashes are u32 in JAX and int64 holding the same value in the port;
splitmix64 runs in wrapping int64 there. Every case compares bytes after
that widening.
"""

import tracemalloc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from materialize_tpu.models.fused_q3 import Q3State as JQ3State
from materialize_tpu.ops.reduce import AccumState as JAccumState
from materialize_tpu.repr import batch as jbatch
from materialize_tpu.repr import hashing as jhash
from materialize_tpu_torch import interop
from materialize_tpu_torch.models.fused_q3 import Q3Caps, Q3State
from materialize_tpu_torch.ops.reduce import AccumState
from materialize_tpu_torch.repr import batch as tbatch
from materialize_tpu_torch.repr import hashing as thash

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

I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max
I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _columns():
    rng = np.random.default_rng(0)
    return {
        "int64": np.concatenate([
            np.array([0, -1, 1, I64_MIN, I64_MAX, I32_MIN, -(2**40)], dtype=np.int64),
            rng.integers(I64_MIN, I64_MAX, 25, dtype=np.int64),
        ]),
        "int32": np.concatenate([
            np.array([0, -1, 1, I32_MIN, I32_MAX, -7, 2**30], dtype=np.int32),
            rng.integers(I32_MIN, I32_MAX, 25, dtype=np.int32),
        ]),
        "int8": np.concatenate([
            np.array([0, -1, 1, -128, 127, -7, 5], dtype=np.int8),
            rng.integers(-128, 128, 25).astype(np.int8),
        ]),
        "bool": rng.random(32) < 0.5,
        "float32": np.concatenate([
            np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5], dtype=np.float32),
            np.array([np.uint32(0x7FC00001), np.uint32(0xFFC12345)], dtype=np.uint32)
            .view(np.float32),  # NaNs with other payloads
            rng.standard_normal(23).astype(np.float32),
        ]),
    }


def _same(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    want = ref.astype(np.int64) if ref.dtype == np.uint32 else ref
    got = port.numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (got, want)


@pytest.mark.parametrize("dtype", ["int64", "int32", "int8", "bool", "float32"])
def test_value_view_matches_jax(dtype):
    col = _columns()[dtype]
    _same(thash.value_view(torch.from_numpy(col)), jhash.value_view(jnp.asarray(col)))


@pytest.mark.parametrize("dtypes", [
    ("int64",), ("int32",), ("int8",), ("bool",), ("float32",),
    ("int32", "int64"), ("int64", "float32", "bool"), ("int32", "int8", "int32", "int64"),
])
def test_hash_and_mix_columns_match_jax(dtypes):
    cols = _columns()
    rng = np.random.default_rng(len(dtypes))
    np_cols = [cols[d][rng.permutation(32)] for d in dtypes]
    t_cols = tuple(torch.from_numpy(c) for c in np_cols)
    j_cols = tuple(jnp.asarray(c) for c in np_cols)
    _same(thash.hash_columns(t_cols), jhash.hash_columns(j_cols))
    _same(thash.mix_columns(t_cols), jhash.mix_columns(j_cols))


def test_splitmix64_matches_jax_on_u64_bits():
    x = _columns()["int64"]
    got = thash.splitmix64(torch.from_numpy(x)).numpy()
    want = np.asarray(jhash.splitmix64(jnp.asarray(x.view(np.uint64))))
    assert got.view(np.uint64).tobytes() == want.tobytes()


@pytest.mark.parametrize("times", [
    np.array([0, 5, -3, 2**32 - 1, 2**32 + 7, 2**40], dtype=np.int64),
    np.array([0, 7, 2**32 - 2, 2**33, 2**64 - 1], dtype=np.uint64),
    np.array([0, 9, 2**32 - 1], dtype=np.uint32),
])
def test_to_device_time_clamps_like_jax(times):
    _same(tbatch.to_device_time(times), jbatch.to_device_time(times))


def test_update_batch_build_matches_jax():
    rng = np.random.default_rng(3)
    k = rng.integers(-5, 5, 13).astype(np.int32)
    v = rng.integers(-(2**40), 2**40, 13)
    times = rng.integers(0, 9, 13)
    diffs = rng.choice([-1, 1, 2], 13)
    jb = jbatch.UpdateBatch.build((k,), (k, v), times, diffs)
    tb = tbatch.UpdateBatch.build((k,), (k, v), times, diffs, device="cpu")
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jb)]
    tl = interop.to_numpy(tb)
    assert [a.dtype for a in jl] == [a.dtype for a in tl]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(jl, tl))
    assert int(tb.count()) == int(jb.count())


def test_interop_round_trips_both_directions():
    rng = np.random.default_rng(4)
    # JAX -> port -> numpy reproduces the JAX leaves
    k = rng.integers(0, 50, 10)
    jb = jbatch.UpdateBatch.build((k,), (k, k * 3), np.full(10, 2), np.ones(10, dtype=np.int64))
    js = JAccumState(
        jnp.asarray(rng.integers(0, 2**32, 16, dtype=np.uint64).astype(np.uint32)),
        (jnp.asarray(rng.integers(0, 9, 16)),),
        (jnp.asarray(rng.integers(-99, 99, 16)),),
        jnp.asarray(rng.integers(0, 3, 16)),
    )
    for jobj, template in (
        (jb, tbatch.UpdateBatch.empty(16, (torch.int64,), (torch.int64,) * 2, device="cpu")),
        (js, AccumState.empty(16, (torch.int64,), (torch.int64,), device="cpu")),
    ):
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jobj)]
        port = interop.from_numpy(template, leaves, device="cpu")
        back = interop.to_numpy(port)
        assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                   for a, b in zip(leaves, back))
    # a whole (empty) Q3 state, in the JAX leaf order
    caps = Q3Caps(cust=16, orders=32, lineitem=64, delta=8, join_out=32, groups=32)
    jstate = JQ3State.empty(caps)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    port = interop.from_numpy(Q3State.empty(caps, device="cpu"), leaves, device="cpu")
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
               for a, b in zip(leaves, interop.to_numpy(port)))
    with pytest.raises(ValueError):
        interop.from_numpy(Q3State.empty(caps, device="cpu"), leaves[:-1], device="cpu")
