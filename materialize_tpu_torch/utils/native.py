"""Host-side consolidation of columnar updates, in NumPy.

Counterpart of the NumPy path of materialize_tpu/utils/native.py
(`consolidate_host`): peeks read an arrangement's live rows to the host and
consolidate them there. The reference also has a native C++ kernel for
this; its NumPy path, ported here, gives the same rows in the same order
(data columns compared as signed 64-bit patterns, then times as u64). The
native kernel comes with the persist layer.
"""

from __future__ import annotations

import numpy as np


def consolidate_host(cols: dict) -> dict:
    """Consolidate host columnar updates {'c0': ..., 'times': ..., 'diffs': ...}.

    Columns are first canonicalized to 64-bit integer views (floats become
    float32 bit patterns with -0.0 folded and every NaN, the float NULL
    sentinel, made one, so NULL rows merge; narrower ints widen), mirroring
    the device `value_view`. Output columns keep their input dtypes.
    """
    data_keys = sorted(k for k in cols if k not in ("times", "diffs"))
    n = int(len(cols["times"]))
    if n == 0:
        return cols
    restore: dict = {}
    canon = {"times": cols["times"], "diffs": cols["diffs"]}
    for k in data_keys:
        a = np.asarray(cols[k])
        if a.dtype.kind == "f":
            f = a.astype(np.float32, copy=True)
            f[f == 0.0] = np.float32(0.0)
            f[np.isnan(f)] = np.float32(np.nan)
            canon[k] = f.view(np.uint32).astype(np.int64)
            restore[k] = ("f32", a.dtype)
        elif a.dtype.kind in "iub" and a.dtype.itemsize < 8:
            canon[k] = a.astype(np.int64)
            restore[k] = ("cast", a.dtype)
        else:
            canon[k] = a
    out = _consolidate_numpy(canon, data_keys)
    for k, (kind, dt) in restore.items():
        if kind == "f32":
            out[k] = out[k].astype(np.uint32).view(np.float32).astype(dt)
        else:
            out[k] = out[k].astype(dt)
    return out


def _consolidate_numpy(cols: dict, data_keys) -> dict:
    """Sort by (data columns, time), sum the diffs of equal rows, drop the
    rows whose sum is 0; rows in sorted order."""

    def sort_view(a):
        if a.dtype.itemsize == 8 and a.dtype.kind == "u":
            return a.view(np.int64)
        return a

    times = np.asarray(cols["times"])
    keyed = [sort_view(np.asarray(cols[k])) for k in data_keys] + [times]
    order = np.lexsort(tuple(reversed(keyed)))
    n = len(order)
    starts = np.zeros(n, dtype=bool)
    starts[0] = True
    for a in keyed:
        s = a[order]
        starts[1:] |= s[1:] != s[:-1]
    first = np.flatnonzero(starts)
    sums = np.add.reduceat(np.asarray(cols["diffs"], dtype=np.int64)[order], first)
    keep = first[sums != 0]
    rows = order[keep]
    out = {k: np.asarray(cols[k])[rows] for k in data_keys}
    out["times"] = times[rows].astype(np.uint64)
    out["diffs"] = sums[sums != 0].astype(np.int64)
    return out
