"""generate_series (ops/flat_map.py) in the port against the JAX package.

- `flat_map_total` and `flat_map_materialize` over seeded batches (NULL
  bounds, zero steps, descending series) at an output capacity that fits
  and one that does not: the overflow flag, the truncated output and the
  error batch must be equal.
- The repaired fused path: a generate_series plan goes through
  `render_dataflow(fused=True)` in both packages, both pick their
  `FusedDataflow`, and three ticks (the first one past the fan-out bound of
  the caps, so one overflow retry) give equal outputs, state leaves,
  retries, scales and peeks (the peek's error message where a zero step
  errs).
"""

import tracemalloc

import numpy as np
import pytest
import torch

from materialize_tpu.dataflow import fused as JF
from materialize_tpu.dataflow import runtime as JR
from materialize_tpu.expr import scalar as JS
from materialize_tpu.ops import flat_map as JFM
from materialize_tpu.repr import UpdateBatch as JB
from materialize_tpu_torch import interop
from materialize_tpu_torch.dataflow import fused as TF
from materialize_tpu_torch.dataflow import runtime as TR
from materialize_tpu_torch.models import operators as OPS
from materialize_tpu_torch.ops import flat_map as TFM
from materialize_tpu_torch.repr.batch import UpdateBatch as TB
from test_torch_runtime import _peeks, assert_batch, assert_results, jleaves, to_jax, to_port

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tracemalloc_off():
    if tracemalloc.is_tracing():
        tracemalloc.stop()


EXPRS = (JS.Column(0), JS.Column(1), JS.Column(2))


@pytest.mark.parametrize("out_cap", ["fits", 8])
def test_flat_map_materialize_matches(out_cap):
    cols, diffs = OPS.series_rows(1)
    times = np.full(len(diffs), 3, np.uint64)
    jb = JB.build((), cols, times, diffs)
    tb = TB.build((), cols, times, diffs, device="cpu")
    total = int(JFM.flat_map_total(jb, EXPRS))
    assert int(TFM.flat_map_total(tb, to_port(EXPRS))) == total
    cap = 1 << max(total - 1, 1).bit_length() if out_cap == "fits" else out_cap
    jo, je, jover = JFM.flat_map_materialize(jb, EXPRS, cap)
    to, te, tover = TFM.flat_map_materialize(tb, to_port(EXPRS), cap)
    assert bool(jover) == bool(tover) == (total > cap)
    assert_batch(jo, to, "out")
    assert_batch(je, te, "errs")


CAPS = dict(delta=32, arrangement=256, groups=128, join_out=16, gather=64, ratio=2)


def test_fused_generate_series_renders_in_both_and_matches():
    tdesc = OPS.series_desc()
    jdesc = to_jax(tdesc)
    jdf = JR.render_dataflow(jdesc, fused=True, caps=JF.FusedCaps(**CAPS))
    tdf = TR.render_dataflow(tdesc, fused=True, caps=TF.FusedCaps(**CAPS), device="cpu")
    assert isinstance(jdf, JF.FusedDataflow) and isinstance(tdf, TF.FusedDataflow)
    for tick, inputs in enumerate(OPS.series_ticks(), start=1):
        cols, diffs = inputs["s"]
        times = np.full(len(diffs), tick, np.uint64)
        jres = jdf.step(tick, {"s": JB.build((), cols, times, diffs)})
        tres = tdf.step(tick, {"s": TB.build((), cols, times, diffs, device="cpu")})
        assert_results(jres, tres, f"tick {tick}")
        assert (tdf.retries, tdf._scale) == (jdf.retries, jdf._scale), tick
        want, got = jleaves(jdf.state), interop.to_numpy(tdf.state)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and w.tobytes() == g.tobytes(), tick
        assert _peeks(tdf) == _peeks(jdf), tick  # zero steps: the error message
    assert jdf.retries >= 1  # tick 1's fan-out passed join_out
