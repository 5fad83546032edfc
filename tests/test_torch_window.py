"""Window functions (ops/window.py) in the port against the JAX package.

- `_seg_scan_min`, the reference's `jax.lax.associative_scan` of a
  segmented running min/max, here a log-step scan: equal on seeded int64
  and float32 views (with infinities) and reset masks, at a length that
  is not a power of two.
- `window_step` over three ticks against an arrangement keyed by two
  partition columns: every function, multiplicities up to 3 (the expansion
  into instances), NULLs in the order and argument columns, a descending
  order with NULLS LAST, retractions. Each tick's output must be equal,
  byte for byte, and so must the arrangement's batches.
"""

import tracemalloc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from materialize_tpu.arrangement.spine import Arrangement as JArr
from materialize_tpu.arrangement.spine import arrange_batch as j_arrange
from materialize_tpu.ops import window as JW
from materialize_tpu.repr import UpdateBatch as JB
from materialize_tpu_torch.arrangement.spine import Arrangement as TArr
from materialize_tpu_torch.arrangement.spine import arrange_batch as t_arrange
from materialize_tpu_torch.ops import window as TW
from materialize_tpu_torch.repr.batch import UpdateBatch as TB
from test_torch_runtime import assert_batch, to_port

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    if tracemalloc.is_tracing():
        tracemalloc.stop()


NULL = int(np.iinfo(np.int64).min)


@pytest.mark.parametrize("n", [100])
@pytest.mark.parametrize("dtype", ["int64", "float32"])
@pytest.mark.parametrize("take_max", [False, True])
def test_seg_scan_min_matches_associative_scan(n, dtype, take_max):
    rng = np.random.default_rng(n)
    view = rng.integers(-50, 50, n).astype(dtype)
    if dtype == "float32" and n > 4:
        view[:3] = [np.inf, -np.inf, 0.5]
    reset = rng.random(n) < 0.2
    reset[0] = True
    want = np.asarray(JW._seg_scan_min(jnp.asarray(view), jnp.asarray(reset), take_max))
    got = TW._seg_scan_min(torch.from_numpy(view), torch.from_numpy(reset), take_max).numpy()
    assert want.dtype == got.dtype and want.tobytes() == got.tobytes()


F = JW.WindowFuncSpec
PLAN = JW.WindowPlan(
    partition_cols=(0, 1),
    order_by=((2, True), (3, False)),
    funcs=(F("row_number"), F("rank"), F("dense_rank"), F("ntile", offset=2),
           F("lag", arg=3, offset=2), F("lead", arg=2), F("first_value", arg=3),
           F("last_value", arg=2), F("sum", arg=3), F("count"), F("count", arg=2),
           F("min", arg=3), F("max", arg=2)),
    nulls_last=(True, False),
)


def ticks(n_ticks: int = 3, n: int = 14) -> list:
    rng = np.random.default_rng(21)
    out, hist = [], []
    for t in range(n_ticks):
        cols = (rng.integers(0, 2, n).astype(np.int64), rng.integers(0, 2, n).astype(np.int64),
                rng.integers(0, 4, n).astype(np.int64), rng.integers(-5, 5, n).astype(np.int64))
        cols[2][rng.random(n) < 0.15] = NULL
        cols[3][rng.random(n) < 0.15] = NULL
        diffs = rng.integers(1, 4, n).astype(np.int64)
        hist.append((cols, diffs))
        if t >= 1:
            old, od = hist[t - 1]
            cols = tuple(np.concatenate([c, o[:4]]) for c, o in zip(cols, old))
            diffs = np.concatenate([diffs, -od[:4]])
        out.append((cols, diffs))
    return out


def test_window_step_matches_over_ticks():
    tplan = to_port(PLAN)
    jarr = JArr(key_cols=PLAN.partition_cols)
    tarr = TArr(key_cols=tplan.partition_cols, device="cpu")
    for tick, (cols, diffs) in enumerate(ticks(), start=1):
        times = np.full(len(diffs), tick, np.uint64)
        jk = j_arrange(JB.build((), cols, times, diffs), PLAN.partition_cols)
        tk = t_arrange(TB.build((), cols, times, diffs, device="cpu"), tplan.partition_cols)
        assert_batch(JW.window_step(jarr, jk, PLAN, tick), TW.window_step(tarr, tk, tplan, tick),
                     f"tick {tick}")
        assert len(jarr.batches) == len(tarr.batches)
        for i, (jb, tb) in enumerate(zip(jarr.batches, tarr.batches)):
            assert_batch(jb, tb, f"tick {tick} arrangement batch {i}")
