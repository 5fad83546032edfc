"""Host-side string interning.

Counterpart of materialize_tpu/repr/types.py::StringDictionary: encoding
for the load generators, decoding for string functions (expr/strings.py)
and basic aggregates. The device only ever sees dense
int64 codes; equality (GROUP BY, join keys) is exact. Code order is
insertion order, not collation order.
"""

from __future__ import annotations

import numpy as np


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
