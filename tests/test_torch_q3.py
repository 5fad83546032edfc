"""The port's single-GPU Q3 tick against the JAX package's, byte for byte.

At `__graft_entry__._tiny_caps()` with `TpchGenerator(sf=0.0002, seed=1)`:
hydrate, one tick with the customer path (retracting some customers), then
churn ticks without it. After hydration and after every tick, every output,
error batch, overflow flag and state leaf must be byte-identical (u32
columns widened to int64). A second run carries the JAX-hydrated state
across and continues in the port. The final view must equal `q3_oracle`.

The JAX reference runs once per module, in a module-scoped fixture
(compiling its two tick variants dominates this file's time).
"""

import tracemalloc

import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import _tiny_caps
from materialize_tpu.models import fused_q3 as J
from materialize_tpu.repr import UpdateBatch as JB
from materialize_tpu.storage import TpchGenerator as JGen
from materialize_tpu_torch import interop
from materialize_tpu_torch.models import fused_q3 as T
from materialize_tpu_torch.models.tpch import q3_oracle
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

TICKS = range(2, 8)  # tick 2 runs the customer path; 3..7 are churn ticks
N_CUST_RETRACT = 7
FRAC = 0.05


def _leaves(jobj):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jobj)]


def _assert_same(want: list, tobj, what: str):
    got = interop.to_numpy(tobj)
    assert len(got) == len(want), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, (what, i, w.dtype, g.dtype)
        assert w.tobytes() == g.tobytes(), (what, i)


def _customer_retraction(gen, tick, build):
    cc = tuple(c[:N_CUST_RETRACT] for c in gen._customer)
    gen._customer = tuple(c[N_CUST_RETRACT:] for c in gen._customer)
    return build((), cc, np.full(N_CUST_RETRACT, tick), -np.ones(N_CUST_RETRACT, dtype=np.int64))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's hydrate and ticks, as numpy leaves."""
    caps = _tiny_caps()
    gen = JGen(sf=0.0002, seed=1)
    init = gen.initial_batches(1)
    state = J.hydrate(J.Q3State.empty(caps), init["customer"], init["orders"],
                      init["lineitem"], 1)
    run = {"hydrated": _leaves(state), "ticks": []}
    steps = {wc: jax.jit(J.q3_tick_single(caps, with_cust=wc)) for wc in (True, False)}
    empty_c = JB.empty(8, (), (np.dtype(np.int64),) * 3)
    for tick in TICKS:
        r = gen.refresh(tick, frac=FRAC)
        with_cust = tick == TICKS[0]
        d_cust = _customer_retraction(gen, tick, JB.build) if with_cust else empty_c
        state, out, errs, over = steps[with_cust](state, d_cust, r["orders"], r["lineitem"],
                                                  np.uint64(tick))
        run["ticks"].append({"state": _leaves(state), "out": _leaves(out),
                             "errs": _leaves(errs), "over": np.asarray(over)})
    return run


def _port_caps():
    c = _tiny_caps()
    return T.Q3Caps(**{f: getattr(c, f) for f in T.Q3Caps.__dataclass_fields__})


def _port_ticks(state, gen, caps, check):
    """Run the port's ticks from `state`, calling check(i, results) after each."""
    def build(*a):
        return TB.build(*a, device="cpu")

    empty_c = TB.empty(8, (), (torch.int64,) * 3, device="cpu")
    for i, tick in enumerate(TICKS):
        r = gen.refresh(tick, frac=FRAC)
        with_cust = tick == TICKS[0]
        d_cust = _customer_retraction(gen, tick, build) if with_cust else empty_c
        state, out, errs, over = T.q3_tick(state, d_cust, r["orders"], r["lineitem"], tick,
                                           caps=caps, with_cust=with_cust)
        check(i, state, out, errs, over)
    return state


def _check_against(run):
    def check(i, state, out, errs, over):
        want = run["ticks"][i]
        _assert_same(want["state"], state, f"tick {i} state")
        _assert_same(want["out"], out, f"tick {i} out")
        _assert_same(want["errs"], errs, f"tick {i} errs")
        assert over.numpy().tobytes() == want["over"].tobytes()
        assert not over.any()
    return check


def test_hydrate_and_ticks_byte_identical_to_jax(jax_run):
    # one test for both cases: under xdist's load scheduling two tests of
    # one module may land on two workers, and each would rebuild the fixture
    caps = _port_caps()
    gen = TGen(sf=0.0002, seed=1, device="cpu")
    init = gen.initial_batches(1)
    state = T.hydrate(T.Q3State.empty(caps, device="cpu"), init["customer"], init["orders"],
                      init["lineitem"], 1)
    _assert_same(jax_run["hydrated"], state, "hydrate")
    state = _port_ticks(state, gen, caps, _check_against(jax_run))
    assert T.read_view(state) == q3_oracle(gen._customer, gen._orders_store, gen._lineitem_store)

    # the JAX-hydrated state, carried across, continues identically
    gen = TGen(sf=0.0002, seed=1, device="cpu")
    gen.initial()  # the host mirrors the refreshes draw on
    state = interop.from_numpy(T.Q3State.empty(caps, device="cpu"), jax_run["hydrated"],
                               device="cpu")
    _port_ticks(state, gen, caps, _check_against(jax_run))


def test_hydration_output_lists_every_group_once():
    caps = _port_caps()
    gen = TGen(sf=0.0002, seed=1, device="cpu")
    init = gen.initial_batches(1)
    state = T.hydrate(T.Q3State.empty(caps, device="cpu"), init["customer"], init["orders"],
                      init["lineitem"], 1)
    h = T.hydration_output(state, 1).to_host()
    got = {tuple(int(c[i]) for c in h["vals"][:3]): int(h["vals"][3][i])
           for i in range(len(h["diffs"]))}
    assert (h["diffs"] == 1).all() and (h["times"] == 1).all()
    assert got == T.read_view(state) == q3_oracle(gen._customer, gen._orders_store,
                                                  gen._lineitem_store)
