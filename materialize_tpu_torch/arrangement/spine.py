"""Arrangements: keyed batches, and the host-driven spine of an index.

Counterpart of materialize_tpu/arrangement/spine.py. `arrange_batch` keys
a raw batch by some of its columns and canonicalizes it. `Arrangement` is
the host handle of an index's contents: a list of consolidated, hash-sorted
batches of geometrically growing capacity, merged by `merge_consolidate`
whenever the newest is at least half the size of the one before it
(amortized O(log n) merges an insert, decided on capacities alone, so with
no device read). Peeks read it through `rows_host`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.consolidate import advance_times, consolidate, merge_consolidate
from ..repr.batch import UpdateBatch, bucket_cap, device_time_scalar
from ..repr.hashing import hash_columns
from ..utils.native import consolidate_host


def arrange_batch(
    batch: UpdateBatch, key_cols: tuple[int, ...], compact: bool = True
) -> UpdateBatch:
    """Key a raw batch by the given val-column indices and canonicalize it.

    Key columns are *copied* into `keys` (vals stay the full row) and the
    hash is recomputed; dead rows keep their old (padding) hash.
    `compact=False` skips the compaction (see ops/consolidate.py).
    """
    keys = tuple(batch.vals[i] for i in key_cols)
    if keys:
        hashes = torch.where(batch.live, hash_columns(keys), batch.hashes)
    else:
        hashes = torch.where(batch.live, torch.zeros_like(batch.hashes), batch.hashes)
    keyed = UpdateBatch(hashes, keys, batch.vals, batch.times, batch.diffs)
    return consolidate(keyed, compact=compact)


@dataclass
class Arrangement:
    """Host handle to spine state. `key_cols` indexes into the row (val) columns.

    `holds` is the reader-held compaction ledger: a shared arrangement may
    be read by several dataflows, and `allow_compaction` advances `since`
    only to the minimum over live holds. `device` is where an empty
    arrangement's `merged()` batch lives.
    """

    key_cols: tuple[int, ...]
    batches: list[UpdateBatch] = field(default_factory=list)
    since: int = 0  # logical compaction frontier
    holds: dict = field(default_factory=dict)  # reader id -> held since
    device: str = "cuda"

    def insert(self, delta: UpdateBatch, already_keyed: bool = False) -> None:
        """Add a delta batch (raw, keyed on the fly) and restore the merge invariant."""
        b = delta if already_keyed else arrange_batch(delta, self.key_cols)
        self.batches.append(b)
        self._maintain()

    # -- reader-held compaction ---------------------------------------------
    def hold(self, reader: str, since: int) -> None:
        """Register (or re-pin) `reader`'s since hold."""
        self.holds[reader] = int(since)

    def downgrade_hold(self, reader: str, since: int) -> None:
        """Advance one reader's hold (holds only ever move forward)."""
        if reader in self.holds:
            self.holds[reader] = max(self.holds[reader], int(since))

    def release_hold(self, reader: str) -> None:
        """Drop a reader's hold and compact to the remaining minimum; a
        reader with no hold here changes nothing."""
        if self.holds.pop(reader, None) is None:
            return
        if self.holds:
            self.compact(min(self.holds.values()))

    def allow_compaction(self, since: int) -> None:
        """Advance `since`, but never past the minimum live reader hold."""
        if self.holds:
            since = min(since, min(self.holds.values()))
        self.compact(since)

    def _maintain(self) -> None:
        # merge while the tail batch is at least half the size of its
        # predecessor; both are consolidate outputs, so the O(n) merge applies
        while len(self.batches) >= 2 and (
            self.batches[-1].cap * 2 >= self.batches[-2].cap
        ):
            b = self.batches.pop()
            a = self.batches.pop()
            merged = merge_consolidate(a, b, since=device_time_scalar(self.since))
            self.batches.append(merged.with_capacity(bucket_cap(a.cap + b.cap)))

    def compact(self, since: int) -> None:
        """Advance the logical compaction frontier."""
        self.since = max(self.since, since)

    def rebucket(self) -> None:
        """Shrink capacities to fit live counts (host reads; call occasionally)."""
        new = []
        for b in self.batches:
            cap = bucket_cap(int(b.count()))
            if cap < b.cap:
                b = consolidate(b).with_capacity(cap)
            new.append(b)
        self.batches = new
        self._maintain()

    def merged(self) -> UpdateBatch:
        """One consolidated batch of the full contents."""
        if not self.batches:
            return UpdateBatch.empty(8, device=self.device)
        out = self.batches[0]
        for b in self.batches[1:]:
            out = UpdateBatch.concat(out, b)
        return consolidate(advance_times(out, self.since))

    def host_columns(self, at: int | None = None) -> tuple[dict, int]:
        """Consolidated contents as host columns {'c0', ..., 'times',
        'diffs'} (times as u64, advanced to `since`, rows at times <= `at`),
        and the number of data columns."""
        parts: list[dict] = []
        ncols = 0
        for b in self.batches:
            h = b.to_host()
            if len(h["times"]) == 0:
                continue
            ncols = len(h["vals"])
            part = {f"c{i}": np.asarray(c) for i, c in enumerate(h["vals"])}
            part["times"] = np.asarray(h["times"]).astype(np.uint64)
            part["diffs"] = np.asarray(h["diffs"])
            parts.append(part)
        if not parts:
            return {"times": np.zeros(0, np.uint64), "diffs": np.zeros(0, np.int64)}, 0
        cols = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        cols["times"] = np.maximum(cols["times"], np.uint64(self.since))
        if at is not None:
            mask = cols["times"] <= np.uint64(at)
            cols = {k: v[mask] for k, v in cols.items()}
        return consolidate_host(cols), ncols

    def rows_host(self, at: int | None = None) -> list[tuple]:
        """Consolidated (data, time, diff) rows, read and consolidated on
        the host. Float NaN (the float NULL sentinel) becomes None, so NULL
        rows accumulate and compare correctly in host dicts."""
        out, ncols = self.host_columns(at)
        if len(out["times"]) == 0:
            return []
        col_lists = []
        for j in range(ncols):
            c = out[f"c{j}"]
            lst = c.tolist()
            if c.dtype.kind == "f":
                lst = [None if x != x else x for x in lst]
            col_lists.append(lst)
        times_l = out["times"].tolist()
        diffs_l = out["diffs"].tolist()
        if not col_lists:
            return [((), int(t), int(d)) for t, d in zip(times_l, diffs_l)]
        return [
            (data, int(t), int(d))
            for data, t, d in zip(zip(*col_lists), times_l, diffs_l)
        ]

    def count(self) -> int:
        return sum(int(b.count()) for b in self.batches)

    def total_cap(self) -> int:
        return sum(b.cap for b in self.batches)


def _host_value(v):
    """Python value of one host scalar; float NaN (the float NULL sentinel)
    becomes None (two NaN objects are never equal in Python)."""
    x = v.item()
    if isinstance(x, float) and x != x:
        return None
    return x
