"""Deterministic 32-bit row hashing, bit-identical to the JAX package's.

Every update batch carries a 32-bit hash of its key columns; arrangements
sort by it and joins probe by it. Mixing runs through splitmix64 per column
and folds to 32 bits at the end.

torch has no usable unsigned 64-bit arithmetic, so splitmix64 runs in
wrapping int64: multiplication and addition wrap exactly as in u64, the
constants above 2^63 are written as their two's-complement values, and every
right shift is a logical shift (`_lsr`, an arithmetic shift plus a mask).
The 32-bit results are carried as int64 in [0, 2^32) (see repr/batch.py).
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _s64(u: int) -> int:
    """Two's-complement int64 value of a u64 constant."""
    u &= _MASK64
    return u - (1 << 64) if u >= 1 << 63 else u


# splitmix64 constants (public domain PRNG finalizer, Steele et al.)
_C1_U = 0x9E3779B97F4A7C15
_C2_U = 0xBF58476D1CE4E5B9
_C3_U = 0x94D049BB133111EB
_C1, _C2, _C3 = _s64(_C1_U), _s64(_C2_U), _s64(_C3_U)

# Reserved sentinel: padding rows hash to PAD_HASH and sort to the end of
# every batch. Real hashes are clamped below it.
PAD_HASH = 0xFFFFFFFF
_U32 = 0xFFFFFFFF
_CANONICAL_NAN_BITS = 0x7FC00000


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor holding u64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) + _C1
    x = (x ^ _lsr(x, 30)) * _C2
    x = (x ^ _lsr(x, 27)) * _C3
    return x ^ _lsr(x, 31)


def value_view(col: torch.Tensor) -> torch.Tensor:
    """Total-order, equality-exact integer view of a column.

    Bool becomes int8; floats become their float32 bit patterns as int64 in
    [0, 2^32), with -0.0 folded into 0.0 and every NaN folded to one
    canonical NaN (NaN is the float NULL sentinel, and NULL must equal NULL
    for grouping and consolidation). Integer columns pass through.
    """
    if col.dtype == torch.bool:
        return col.to(torch.int8)
    if col.dtype.is_floating_point:
        f = col.to(torch.float32)
        f = torch.where(f == 0.0, torch.zeros_like(f), f)
        bits = f.view(torch.int32).to(torch.int64) & _U32
        return torch.where(torch.isnan(f), torch.full_like(bits, _CANONICAL_NAN_BITS), bits)
    return col


def _col_to_u64(col: torch.Tensor) -> torch.Tensor:
    """Canonical u64 bits (in int64) of one column; signed ints sign-extend."""
    return value_view(col).to(torch.int64)


def hash_columns(cols) -> torch.Tensor:
    """Combine key columns into one 32-bit hash per row, clamped below PAD_HASH."""
    if not cols:
        raise ValueError("hash_columns needs at least one column; use zeros for keyless")
    h = torch.full(cols[0].shape, _s64(0x51ED270B_9B1F8C33), dtype=torch.int64,
                   device=cols[0].device)
    for i, col in enumerate(cols):
        salt = _s64((i + 1) * _C1_U)
        h = splitmix64(h ^ splitmix64(_col_to_u64(col) + salt))
    h32 = (h ^ _lsr(h, 32)) & _U32
    return torch.where(h32 == PAD_HASH, torch.full_like(h32, PAD_HASH - 1), h32)


def mix_columns(cols) -> torch.Tensor:
    """A second, independent 32-bit hash of the same columns (accumulator
    tables pair it with `hash_columns` as a 64-bit ordering key)."""
    if not cols:
        return torch.zeros((), dtype=torch.int64)
    h = torch.full(cols[0].shape, _s64(0xA076_1D64_78BD_642F), dtype=torch.int64,
                   device=cols[0].device)
    for i, col in enumerate(cols):
        salt = _s64((i + 7) * _C3_U)
        h = splitmix64(h ^ splitmix64(_col_to_u64(col) ^ salt))
    return (h ^ _lsr(h, 32)) & _U32
