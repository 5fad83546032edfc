"""TPC-H Q3 constants and its brute-force oracle.

Counterpart of materialize_tpu/models/tpch.py (`BUILDING`, `Q3_DATE`,
`q3_oracle`). Revenue ``l_extendedprice * (1 - l_discount)`` is planned as
``extendedprice_cents * (100 - discount_pct)``: exact integer arithmetic.
"""

from __future__ import annotations

import numpy as np

from ..storage.generator import date_num

BUILDING = 1  # segment code of 'BUILDING' in the generator's segment table
Q3_DATE = int(date_num(1995, 3, 15))


def q3_oracle(customer, orders, lineitem, building_code: int = BUILDING) -> dict:
    """Brute-force Q3 over host column tuples -> {(orderkey, orderdate,
    shippriority): revenue}."""
    ck, seg, _ = customer
    ok, ock, od, sp = orders
    lk, ep, dc, sd, _, _ = lineitem
    building = set(ck[seg == building_code].tolist())
    omask = od < Q3_DATE
    o_by_key = {}
    for i in np.nonzero(omask)[0]:
        if int(ock[i]) in building:
            o_by_key[int(ok[i])] = (int(od[i]), int(sp[i]))
    out = {}
    lmask = sd > Q3_DATE
    for i in np.nonzero(lmask)[0]:
        o = o_by_key.get(int(lk[i]))
        if o is not None:
            g = (int(lk[i]), o[0], o[1])
            out[g] = out.get(g, 0) + int(ep[i]) * (100 - int(dc[i]))
    return out
