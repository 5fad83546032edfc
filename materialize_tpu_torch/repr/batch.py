"""UpdateBatch: the engine's device currency, as a dataclass of torch tensors.

A batch is a fixed-capacity structure-of-arrays of update triples
``(key_cols, val_cols, time, diff)`` plus a precomputed 32-bit key hash.
Unused rows are padding with ``hash == PAD_HASH`` (sorts last),
``diff == 0`` and ``time == PAD_TIME``; every operator is linear in diff, so
padding flows through joins, reduces and consolidation without masks.
Capacities are powers of two (`bucket_cap`).

**Unsigned columns are carried as int64.** The JAX package keeps hashes and
device times as u32. torch's uint32 supports no comparison, addition, shift
or remainder, so this package carries every u32 column as int64 holding a
value in [0, 2^32): padding (0xFFFFFFFF) still sorts last, and sorts,
searches, comparisons and the kernels all work on it. Narrowing these
columns back to 32 bits is later work. Positions and indices are int64,
torch's index type (the JAX package's are i32).

Diffs are int64; value columns keep the dtype they were built with (the
benchmark path uses int32, the SQL path int64).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .hashing import PAD_HASH, hash_columns

HASH_DTYPE = torch.int64  # u32 values
TIME_DTYPE = torch.int64  # u32 device-time values
DIFF_DTYPE = torch.int64

PAD_TIME = 0xFFFFFFFF
# Largest real (non-padding) device time; boundary conversions clamp here so
# no live row can collide with the PAD_TIME sentinel.
MAX_DEVICE_TIME = PAD_TIME - 1
_PAD_TIME_U64 = 0xFFFFFFFFFFFFFFFF
MIN_CAP = 8


def device_time_scalar(t) -> int:
    """One logical (u64-domain) time -> its device view, saturating below PAD_TIME."""
    return min(max(int(t), 0), MAX_DEVICE_TIME)


def to_device_time(times, device=None) -> torch.Tensor:
    """Logical times -> device-time views (int64 holding u32 values).

    Accepts host values (a sequence or numpy array). The u64 all-ones padding
    sentinel maps to PAD_TIME; every other value saturates into
    [0, MAX_DEVICE_TIME]. u32 inputs are already device views.
    """
    a = np.asarray(times)
    if a.dtype == np.uint32:
        out = a.astype(np.int64)
    elif a.dtype == np.uint64:
        out = np.where(a == np.uint64(_PAD_TIME_U64), PAD_TIME,
                       np.minimum(a, np.uint64(MAX_DEVICE_TIME)).astype(np.int64))
    else:
        out = np.clip(a.astype(np.int64), 0, MAX_DEVICE_TIME)
    return torch.tensor(np.asarray(out, dtype=np.int64), device=device)


def bucket_cap(n: int, minimum: int = MIN_CAP) -> int:
    """Round `n` up to the next power of two (at least `minimum`)."""
    c = minimum
    while c < n:
        c <<= 1
    return c


def _ext(a: torch.Tensor, pad: int, fill) -> torch.Tensor:
    return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype, device=a.device)])


@dataclass
class UpdateBatch:
    hashes: torch.Tensor  # int64 [cap], u32 values (PAD_HASH = padding)
    keys: tuple  # tuple of [cap] tensors (possibly empty)
    vals: tuple  # tuple of [cap] tensors
    times: torch.Tensor  # int64 [cap], u32 device-time values (PAD_TIME = padding)
    diffs: torch.Tensor  # int64 [cap]

    # -- construction ------------------------------------------------------
    @staticmethod
    def empty(cap: int, key_dtypes=(), val_dtypes=(), device="cuda") -> "UpdateBatch":
        return UpdateBatch(
            hashes=torch.full((cap,), PAD_HASH, dtype=HASH_DTYPE, device=device),
            keys=tuple(torch.zeros((cap,), dtype=dt, device=device) for dt in key_dtypes),
            vals=tuple(torch.zeros((cap,), dtype=dt, device=device) for dt in val_dtypes),
            times=torch.full((cap,), PAD_TIME, dtype=TIME_DTYPE, device=device),
            diffs=torch.zeros((cap,), dtype=DIFF_DTYPE, device=device),
        )

    @staticmethod
    def build(key_cols, val_cols, times, diffs, cap: int | None = None,
              device="cuda") -> "UpdateBatch":
        """Build a padded device batch from host (numpy) columns."""

        def dev(c):
            return torch.tensor(np.asarray(c), device=device)

        key_cols = tuple(dev(c) for c in key_cols)
        val_cols = tuple(dev(c) for c in val_cols)
        times = to_device_time(times, device=device)
        diffs = torch.tensor(np.asarray(diffs, dtype=np.int64), device=device)
        n = int(times.shape[0])
        if cap is None:
            cap = bucket_cap(n)
        if key_cols:
            hashes = hash_columns(key_cols)
        else:
            hashes = torch.zeros((n,), dtype=HASH_DTYPE, device=device)
        return UpdateBatch(hashes, key_cols, val_cols, times, diffs).with_capacity(cap)

    # -- shape management --------------------------------------------------
    @property
    def cap(self) -> int:
        return int(self.times.shape[0])

    @property
    def device(self) -> torch.device:
        return self.times.device

    def with_capacity(self, cap: int) -> "UpdateBatch":
        cur = self.cap
        if cap == cur:
            return self
        if cap > cur:
            pad = cap - cur
            return UpdateBatch(
                _ext(self.hashes, pad, PAD_HASH),
                tuple(_ext(k, pad, 0) for k in self.keys),
                tuple(_ext(v, pad, 0) for v in self.vals),
                _ext(self.times, pad, PAD_TIME),
                _ext(self.diffs, pad, 0),
            )
        # Shrink: only sound if rows beyond `cap` are padding; callers check.
        return UpdateBatch(
            self.hashes[:cap],
            tuple(k[:cap] for k in self.keys),
            tuple(v[:cap] for v in self.vals),
            self.times[:cap],
            self.diffs[:cap],
        )

    @staticmethod
    def concat(a: "UpdateBatch", b: "UpdateBatch") -> "UpdateBatch":
        return UpdateBatch(
            torch.cat([a.hashes, b.hashes]),
            tuple(torch.cat([x, y]) for x, y in zip(a.keys, b.keys)),
            tuple(torch.cat([x, y]) for x, y in zip(a.vals, b.vals)),
            torch.cat([a.times, b.times]),
            torch.cat([a.diffs, b.diffs]),
        )

    # -- inspection --------------------------------------------------------
    @property
    def live(self) -> torch.Tensor:
        """Mask of rows that carry information (non-padding, non-zero diff)."""
        return (self.hashes != PAD_HASH) & (self.diffs != 0)

    def count(self) -> torch.Tensor:
        return self.live.sum()

    def to_host(self) -> dict:
        """Trimmed host copy: only live rows, in canonical order (vals, then
        time, then hash). `keys` are an arrangement artifact, not row data."""
        live = self.live.cpu().numpy()
        idx = np.nonzero(live)[0]
        rows = {
            "hashes": self.hashes.cpu().numpy()[idx],
            "vals": tuple(v.cpu().numpy()[idx] for v in self.vals),
            "times": self.times.cpu().numpy()[idx],
            "diffs": self.diffs.cpu().numpy()[idx],
        }
        order = np.lexsort(tuple(rows["vals"][::-1]) + (rows["times"], rows["hashes"]))
        return {
            k: (tuple(c[order] for c in v) if isinstance(v, tuple) else v[order])
            for k, v in rows.items()
        }

    def to_rows(self) -> list[tuple]:
        """Host rows as (val-cols tuple, time, diff) triples in canonical
        order; float NaN (the float NULL sentinel) becomes None."""
        h = self.to_host()
        cols = []
        for c in h["vals"]:
            lst = c.tolist()
            if c.dtype.kind == "f":
                lst = [None if x != x else x for x in lst]
            cols.append(lst)
        times, diffs = h["times"].tolist(), h["diffs"].tolist()
        data = list(zip(*cols)) if cols else [()] * len(times)
        return [(row, int(t), int(d)) for row, t, d in zip(data, times, diffs)]
