"""Column types, relation schemas and host-side string interning.

Counterpart of materialize_tpu/repr/types.py. Relations are fixed-width
columnar batches: each column type maps to one device dtype (given here as
a numpy dtype; `expr.scalar.torch_dtype` gives the torch one). Strings and
jsonb travel as int64 dictionary codes interned on the host, NUMERIC as
fixed-point int64, SQL doubles as float32 (the reference's precision rule,
kept so both packages agree bit for bit).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class ColType(enum.Enum):
    """Scalar column types. Each maps to a single device dtype.

    Mirrors the subset of `SqlScalarType` the engine's device path supports
    (reference: src/repr/src/relation_and_scalar.rs); remaining SQL ADTs
    (jsonb, ranges, arrays) are host-side only for now.
    """

    INT64 = "int64"
    INT32 = "int32"
    # Doubles are f32 on the device (the reference's precision rule); SUM
    # accumulates in int64 fixed point (scale 2^24, ops/reduce.py) so
    # retractions cancel exactly.
    FLOAT64 = "float64"
    BOOL = "bool"
    STRING = "string"  # dictionary code (i64)
    TIMESTAMP = "timestamp"  # ms since epoch (i64), like mz Timestamp
    NUMERIC = "numeric"  # fixed-point i64, scale in ColumnDesc
    # canonicalized JSON text (sorted keys, compact separators) interned in
    # the dictionary: code equality == jsonb equality, so grouping/joins/
    # DISTINCT work on device; operators evaluate via string-function tables
    # (reference: src/repr/src/adt/jsonb.rs)
    JSONB = "jsonb"

    @property
    def dtype(self) -> np.dtype:
        return _DTYPES[self]


_DTYPES = {
    ColType.INT64: np.dtype(np.int64),
    ColType.INT32: np.dtype(np.int32),
    # float32 on the device, as in the reference
    ColType.FLOAT64: np.dtype(np.float32),
    # int8 {0,1} with -128 = NULL: bool arrays can't carry an in-band null
    # sentinel, so stored truth values are bytes (expr/scalar.py NULL design)
    ColType.BOOL: np.dtype(np.int8),
    ColType.STRING: np.dtype(np.int64),
    ColType.TIMESTAMP: np.dtype(np.int64),
    ColType.NUMERIC: np.dtype(np.int64),
    ColType.JSONB: np.dtype(np.int64),
}


@dataclass(frozen=True)
class ColumnDesc:
    name: str
    typ: ColType
    nullable: bool = False
    scale: int = 2  # NUMERIC fixed-point decimal places

    @property
    def dtype(self) -> np.dtype:
        return self.typ.dtype


@dataclass(frozen=True)
class RelationDesc:
    """Named, typed columns plus an optional primary key (column indices).

    Mirrors the reference's `RelationDesc` (src/repr/src/relation.rs).
    """

    columns: tuple[ColumnDesc, ...]
    key: tuple[int, ...] = ()

    @staticmethod
    def of(*cols: tuple, key: tuple[int, ...] = ()) -> "RelationDesc":
        descs = []
        for c in cols:
            if isinstance(c, ColumnDesc):
                descs.append(c)
            else:
                name, typ = c[0], c[1]
                descs.append(ColumnDesc(name, typ))
        return RelationDesc(tuple(descs), key)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    @property
    def dtypes(self) -> tuple[np.dtype, ...]:
        return tuple(c.dtype for c in self.columns)

    def index_of(self, name: str) -> int:
        return self.names.index(name)

    @property
    def arity(self) -> int:
        return len(self.columns)


class StringDictionary:
    """Interning of strings to dense int64 codes."""

    def __init__(self) -> None:
        self._code: dict[str, int] = {}
        self._strs: list[str] = []

    def encode(self, s: str) -> int:
        code = self._code.get(s)
        if code is None:
            code = len(self._strs)
            self._code[s] = code
            self._strs.append(s)
        return code

    def encode_many(self, xs) -> np.ndarray:
        return np.array([self.encode(x) for x in xs], dtype=np.int64)

    def decode(self, code: int) -> str:
        c = int(code)
        if not (0 <= c < len(self._strs)):
            raise ValueError(f"unknown string dictionary code {c}")
        return self._strs[c]

    def decode_many(self, codes) -> list[str]:
        return [self._strs[int(c)] for c in codes]

    def lookup(self, s: str) -> int | None:
        """Code for `s` if already interned, else None."""
        return self._code.get(s)

    def __len__(self) -> int:
        return len(self._strs)
