"""Arranging a batch: key it by some of its columns and canonicalize it.

Counterpart of materialize_tpu/arrangement/spine.py::arrange_batch. The
host-driven `Arrangement` spine belongs to a later slice.
"""

from __future__ import annotations

import torch

from ..ops.consolidate import consolidate
from ..repr.batch import UpdateBatch
from ..repr.hashing import hash_columns


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
