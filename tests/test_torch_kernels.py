"""The port's four kernels against the JAX package's, exactly.

Each plain PyTorch version (the one CPU tensors take) must equal both the
JAX XLA oracle and the Pallas kernel in interpret mode, value for value,
after the port's dtype mapping (u32 and i32 positions carried as int64).
The CUDA kernels are held against the plain versions on the card in
tests/test_torch_cuda.py and in chip_smoke.py.
"""

import tracemalloc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from materialize_tpu.ops.kernels.permute import _pallas_multi_take, _xla_multi_take
from materialize_tpu.ops.kernels.probe import (
    _pallas_searchsorted,
    _pallas_searchsorted2,
    _xla_searchsorted,
    _xla_searchsorted2,
)
from materialize_tpu.ops.kernels.segsum import _pallas_run_sum, _xla_run_sum
from materialize_tpu_torch.ops.kernels import permute, probe, registry, segsum

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

PAD = 0xFFFFFFFF


def _same(port, ref):
    """A port tensor equals a JAX array after widening the JAX dtype."""
    ref = np.asarray(ref)
    got = port.cpu().numpy()
    want = ref.astype(np.int64) if ref.dtype in (np.uint32, np.int32) and got.dtype == np.int64 \
        else ref
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes(), (got, want)


def _sorted_keys(rng, kind, n):
    if kind == "dups":
        return np.sort(rng.integers(0, 6, n)).astype(np.uint32)
    if kind == "all_pad":
        return np.full(n, PAD, dtype=np.uint32)
    a = np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32))
    a[-max(n // 4, 1):] = PAD  # trailing padding, as in every batch
    return a


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", ["dups", "all_pad", "spread"])
@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_probe_plain_equals_jax(n, kind, side):
    rng = np.random.default_rng(n * 31 + len(kind))
    a = _sorted_keys(rng, kind, n)
    q = np.concatenate([a[rng.integers(0, n, 9)], rng.integers(0, 8, 9).astype(np.uint32),
                        np.full(3, PAD, dtype=np.uint32)])
    got = probe.plain_searchsorted(torch.from_numpy(a.astype(np.int64)),
                                   torch.from_numpy(q.astype(np.int64)), side)
    _same(got, _xla_searchsorted(jnp.asarray(a), jnp.asarray(q), side))
    _same(got, _pallas_searchsorted(jnp.asarray(a), jnp.asarray(q), side))


@pytest.mark.parametrize("side", ["left", "right"])
def test_probe_plain_equals_jax_on_i32_prefix_sums(side):
    # the join searches its running match counts, an i32 array in JAX
    rng = np.random.default_rng(5)
    cum = np.cumsum(rng.integers(0, 3, 40)).astype(np.int32)
    j = np.arange(128, dtype=np.int32)
    got = probe.plain_searchsorted(torch.from_numpy(cum.astype(np.int64)),
                                   torch.from_numpy(j.astype(np.int64)), side)
    _same(got, _xla_searchsorted(jnp.asarray(cum), jnp.asarray(j), side))
    _same(got, _pallas_searchsorted(jnp.asarray(cum), jnp.asarray(j), side))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n", [1, 5, 64])
def test_probe2_plain_equals_jax(n, side):
    rng = np.random.default_rng(100 + n)
    hi = rng.integers(0, 4, n).astype(np.uint32)
    lo = rng.integers(0, 3, n).astype(np.uint32)
    hi[-1] = PAD
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    qh = np.concatenate([hi, rng.integers(0, 5, 8).astype(np.uint32), [PAD]]).astype(np.uint32)
    ql = np.concatenate([lo, rng.integers(0, 4, 8).astype(np.uint32), [0]]).astype(np.uint32)
    t = [torch.from_numpy(x.astype(np.int64)) for x in (hi, lo, qh, ql)]
    got = probe.plain_searchsorted2(*t, side)
    j = [jnp.asarray(x) for x in (hi, lo, qh, ql)]
    _same(got, _xla_searchsorted2(*j, side))
    _same(got, _pallas_searchsorted2(*j, side))


def _take_cols(rng, n):
    # two columns of every dtype, so the XLA oracle gathers each group in
    # clip mode (a single-column group indexes, which wraps negatives)
    return (
        rng.integers(-(2**50), 2**50, n).astype(np.int64),
        rng.integers(-(2**50), 2**50, n).astype(np.int64),
        rng.integers(-(2**31), 2**31, n).astype(np.int32),
        rng.integers(-(2**31), 2**31, n).astype(np.int32),
        rng.random(n) < 0.5,
        rng.random(n) < 0.5,
        rng.random(n).astype(np.float32),
        rng.random(n).astype(np.float32),
    )


@pytest.mark.parametrize("n,m", [(1, 4), (8, 8), (33, 100)])
def test_multi_take_plain_equals_jax_with_clipped_indices(n, m):
    rng = np.random.default_rng(n + m)
    cols = _take_cols(rng, n)
    idx = rng.integers(-5, n + 5, m).astype(np.int32)  # out of range both ways
    got = permute.plain_multi_take(tuple(torch.from_numpy(c) for c in cols),
                                   torch.from_numpy(idx.astype(np.int64)))
    jcols, jidx = tuple(jnp.asarray(c) for c in cols), jnp.asarray(idx)
    for ref in (_xla_multi_take(jcols, jidx), _pallas_multi_take(jcols, jidx)):
        for g, w in zip(got, ref):
            _same(g, w)


def _run_sum_case(rng, n, layout):
    if layout == "one_run":
        flags = np.zeros(n, dtype=bool)
        flags[0] = True
    elif layout == "singletons":
        flags = np.ones(n, dtype=bool)
    elif layout == "no_start_at_0":
        flags = rng.random(n) < 0.3
        flags[0] = False
    else:
        flags = rng.random(n) < 0.3
        flags[0] = True
    cols = (
        rng.integers(-(2**62), 2**62, n).astype(np.int64),
        rng.integers(-(2**31), 2**31, n).astype(np.int32),  # wraps in int32
    )
    return flags, cols


@pytest.mark.parametrize("layout", ["one_run", "singletons", "no_start_at_0", "random"])
@pytest.mark.parametrize("n", [1, 2, 17, 64])
def test_run_sum_plain_equals_jax(n, layout):
    rng = np.random.default_rng(7 * n + len(layout))
    flags, cols = _run_sum_case(rng, n, layout)
    got = segsum.plain_run_sum(torch.from_numpy(flags), tuple(torch.from_numpy(c) for c in cols))
    jf, jc = jnp.asarray(flags), tuple(jnp.asarray(c) for c in cols)
    for ref in (_xla_run_sum(jf, jc), _pallas_run_sum(jf, jc)):
        for g, w in zip(got, ref):
            _same(g, w)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    registry.reset_launches()
    a = torch.arange(16, dtype=torch.int64)
    q = torch.tensor([3, 20, -1], dtype=torch.int64)
    probe.probe(a, q, "left")
    probe.probe2(a, a, q, q, "right")
    permute.multi_take((a, a.to(torch.int32)), q)
    segsum.run_sum(a % 3 == 0, (a,))
    assert registry.LAUNCHES == {k: 0 for k in registry.KERNELS}


def test_wrappers_reject_mixed_or_unsupported_devices():
    a = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        probe.probe(a, torch.empty(2, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        probe.probe(a, a, side="middle")
