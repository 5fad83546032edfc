"""Antichain frontiers over the engine's u64 timestamps (the port's copy).

The host-side analogue of timely's `Antichain`/`MutableAntichain` and the
reference's frontier plumbing (src/compute-types/src/dataflows.rs:54-74,
timely progress tracking). Engine time is a single u64 dimension, so a
normalized antichain holds at most one element — but the TYPE carries what a
scalar tick cannot:

- the EMPTY antichain: as a frontier it means "complete, no more updates"
  (a scalar has no such value); as an `until` bound it means "unbounded".
- the frontier algebra (`less_than` / `less_equal` / meet / join) that the
  reference names as the main source of subtle correctness bugs
  (src/adapter/src/coord.rs:22-66) — encoding it once beats re-deriving
  `<=` vs `<` at every call site.

Multi-element antichains (partial-order product timestamps) would extend
this type without changing its callers; the normalization hook is where
dominated elements drop.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Antichain:
    """A minimal set of mutually-incomparable times (normalized)."""

    elements: tuple = ()

    @staticmethod
    def of(*times: int) -> "Antichain":
        """Antichain of the given times (normalized: total order keeps min)."""
        if not times:
            return EMPTY
        return Antichain((min(int(t) for t in times),))

    def is_empty(self) -> bool:
        return not self.elements

    def __bool__(self) -> bool:  # truthy = has elements (not complete)
        return bool(self.elements)

    def less_equal(self, t: int) -> bool:
        """Some element ≤ t — i.e. time `t` is NOT yet complete/covered."""
        return any(e <= t for e in self.elements)

    def less_than(self, t: int) -> bool:
        return any(e < t for e in self.elements)

    def dominates(self, other: "Antichain") -> bool:
        """self ⪰ other: every `other` element is ≤ some element path —
        for totally ordered times, min(self) ≥ min(other); the empty
        frontier dominates everything (it is the top)."""
        if not self.elements:
            return True
        if not other.elements:
            return False
        return self.elements[0] >= other.elements[0]

    def meet(self, other: "Antichain") -> "Antichain":
        """Greatest lower bound (pointwise min; empty is the identity)."""
        if not self.elements:
            return other
        if not other.elements:
            return self
        return Antichain.of(min(self.elements[0], other.elements[0]))

    def join(self, other: "Antichain") -> "Antichain":
        """Least upper bound (max; empty absorbs)."""
        if not self.elements or not other.elements:
            return EMPTY
        return Antichain.of(max(self.elements[0], other.elements[0]))

    def as_scalar(self, default: int) -> int:
        """The single frontier time, or `default` when complete/unbounded."""
        return int(self.elements[0]) if self.elements else default


EMPTY = Antichain(())
