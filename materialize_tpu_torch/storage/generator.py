"""Deterministic load generators: the auction stream and TPC-H with RF1/RF2.

Counterpart of materialize_tpu/storage/generator.py (`AuctionGenerator`,
`CounterGenerator`, `TpchGenerator` and `date_num`). The numpy draws are the reference's, in
the same order, so the same seed yields the same rows; batches land on the
requested device as port `UpdateBatch`es. Money is fixed-point cents; dates
are day numbers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..repr.batch import UpdateBatch
from ..repr.types import StringDictionary

_ITEMS = [
    "Signed Memorabilia",
    "City Bar Crawl",
    "Best Pizza in Town",
    "Gift Basket",
    "Custom Art",
]


class AuctionGenerator:
    """Append-only auction and bid stream, deterministic per seed.

    The shape of the reference auction load generator: static
    organizations, users and accounts; a stream of auctions and bids.
    auctions(id, seller, item code, end_time), bids(id, buyer, auction_id,
    amount, bid_time), all int64. With `keep_host`, every tick's host
    columns are also kept in `host["auctions"]` and `host["bids"]` (lists
    of column tuples), for oracles.
    """

    # per-bid footprint for ingest budgeting (5 i64 cols + time/diff)
    ROW_BYTES = 56

    def __init__(self, seed: int = 0, n_auctions_per_tick: int = 4,
                 dict_: StringDictionary | None = None, device="cuda",
                 keep_host: bool = False):
        self.rng = np.random.default_rng(seed)
        self.dict = dict_ or StringDictionary()
        self.item_codes = self.dict.encode_many(_ITEMS)
        self.next_auction_id = 0
        self.next_bid_id = 0
        self.n_auctions_per_tick = n_auctions_per_tick
        self.open_auctions: np.ndarray = np.array([], dtype=np.int64)
        self.device = device
        self.host: dict | None = {"auctions": [], "bids": []} if keep_host else None

    def static_tables(self) -> dict[str, tuple]:
        orgs = np.arange(20, dtype=np.int64)
        org_names = self.dict.encode_many([f"org #{i}" for i in orgs])
        users = np.arange(1000, dtype=np.int64)
        user_org = users % 20
        user_names = self.dict.encode_many([f"user #{i}" for i in users])
        balances = np.full(1000, 10_000, dtype=np.int64)
        return {
            "organizations": (orgs, org_names),
            "users": (users, user_org, user_names),
            "accounts": (users, user_org, balances),
        }

    def next_tick(self, tick: int, n_bids: int) -> dict[str, UpdateBatch]:
        """New auctions + a batch of bids on open auctions at time `tick`."""
        na = self.n_auctions_per_tick
        a_ids = np.arange(self.next_auction_id, self.next_auction_id + na, dtype=np.int64)
        self.next_auction_id += na
        sellers = self.rng.integers(0, 1000, na).astype(np.int64)
        items = self.item_codes[self.rng.integers(0, len(self.item_codes), na)]
        end_times = np.full(na, tick + 100, dtype=np.int64)
        self.open_auctions = np.concatenate([self.open_auctions, a_ids])

        b_ids = np.arange(self.next_bid_id, self.next_bid_id + n_bids, dtype=np.int64)
        self.next_bid_id += n_bids
        buyers = self.rng.integers(0, 1000, n_bids).astype(np.int64)
        target = self.open_auctions[self.rng.integers(0, len(self.open_auctions), n_bids)]
        amounts = self.rng.integers(1, 10_000, n_bids).astype(np.int64)
        bid_times = np.full(n_bids, tick, dtype=np.int64)

        auctions = (a_ids, sellers, items, end_times)
        bids = (b_ids, buyers, target, amounts, bid_times)
        if self.host is not None:
            self.host["auctions"].append(auctions)
            self.host["bids"].append(bids)
        return {
            "auctions": UpdateBatch.build((), auctions, [tick] * na, [1] * na,
                                          device=self.device),
            "bids": UpdateBatch.build((), bids, [tick] * n_bids, [1] * n_bids,
                                      device=self.device),
        }


class CounterGenerator:
    """COUNTER load generator: emits 1, 2, 3, ...; with max_cardinality,
    value v - max is retracted when v is emitted."""

    ROW_BYTES = 24  # one i64 col + time/diff

    def __init__(self, max_cardinality: int | None = None, device="cuda"):
        self.max_cardinality = max_cardinality
        self.next = 1
        self.device = device

    def next_tick(self, tick: int, n_rows: int = 1) -> dict[str, UpdateBatch]:
        vals = np.arange(self.next, self.next + n_rows, dtype=np.int64)
        self.next += n_rows
        diffs = np.ones(n_rows, dtype=np.int64)
        if self.max_cardinality is not None:
            dead = vals - self.max_cardinality
            keep = dead >= 1
            vals = np.concatenate([vals, dead[keep]])
            diffs = np.concatenate([diffs, -np.ones(int(keep.sum()), dtype=np.int64)])
        n = len(vals)
        return {
            "counter": UpdateBatch.build((), (vals,), np.full(n, tick), diffs,
                                         device=self.device)
        }


def date_num(y: int, m: int, d: int) -> int:
    """Days since 1992-01-01 (TPC-H epoch)."""
    return (np.datetime64(f"{y:04d}-{m:02d}-{d:02d}") - np.datetime64("1992-01-01")).astype(int)


_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]


@dataclass
class TpchTables:
    customer: tuple  # (custkey, mktsegment_code, nationkey)
    orders: tuple  # (orderkey, custkey, orderdate, shippriority)
    lineitem: tuple  # (orderkey, extendedprice_cents, discount_pct, shipdate, quantity, partkey)
    part: tuple  # (partkey, brand_code, container_code)


class TpchGenerator:
    """TPC-H -flavored deterministic generator with RF1/RF2 refresh streams.

    Per the TPC-H spec, customer = 150k·SF, orders = 1.5M·SF, lineitems 1–7
    per order. Money is fixed-point cents; dates are day numbers (date_num).
    """

    def __init__(self, sf: float = 0.01, seed: int = 0, segment_codes=None,
                 val_dtype=np.int64, device="cuda"):
        self.sf = sf
        self.device = device
        # Device-batch value dtype: int64, or int32 (every TPC-H column fits:
        # orderkey < 2^31 through SF100, cents < 10^7, dates < 2557), which
        # halves the bytes every gather and sort moves. Host mirrors stay
        # int64; the cast happens at batch build.
        self.val_dtype = np.dtype(val_dtype)
        self.rng = np.random.default_rng(seed)
        # c_mktsegment: raw 0..4 indices into _SEGMENTS by default; a caller
        # with a string dictionary passes its codes so SQL 'BUILDING' matches
        self.segment_codes = (
            np.asarray(segment_codes, dtype=np.int64)
            if segment_codes is not None
            else np.arange(5, dtype=np.int64)
        )
        self.n_customer = max(int(150_000 * sf), 10)
        self.n_orders = max(int(1_500_000 * sf), 20)
        self.n_part = max(int(200_000 * sf), 10)
        self.next_orderkey = self.n_orders
        # host mirrors of live orders/lineitems so RF2 can emit exact
        # retractions (column tuples, appended by RF1, consumed from the front)
        self._orders_store: list | None = None
        self._lineitem_store: list | None = None

    def initial(self) -> TpchTables:
        rng = np.random.default_rng(12345)
        custkey = np.arange(self.n_customer, dtype=np.int64)
        mktsegment = self.segment_codes[rng.integers(0, 5, self.n_customer)]
        nationkey = rng.integers(0, 25, self.n_customer).astype(np.int64)

        orderkey = np.arange(self.n_orders, dtype=np.int64)
        o_custkey = rng.integers(0, self.n_customer, self.n_orders).astype(np.int64)
        o_orderdate = rng.integers(0, 2406, self.n_orders).astype(np.int64)  # 1992-1998
        o_shippriority = np.zeros(self.n_orders, dtype=np.int64)

        nli = rng.integers(1, 8, self.n_orders)
        l_orderkey = np.repeat(orderkey, nli)
        n_l = len(l_orderkey)
        l_extendedprice = rng.integers(100_00, 100_000_00, n_l).astype(np.int64)
        l_discount = rng.integers(0, 11, n_l).astype(np.int64)  # percent
        l_shipdate = rng.integers(0, 2557, n_l).astype(np.int64)
        l_quantity = rng.integers(1, 51, n_l).astype(np.int64)
        l_partkey = rng.integers(0, self.n_part, n_l).astype(np.int64)

        partkey = np.arange(self.n_part, dtype=np.int64)
        p_brand = rng.integers(0, 25, self.n_part).astype(np.int64)
        p_container = rng.integers(0, 40, self.n_part).astype(np.int64)

        self._customer = (custkey, mktsegment, nationkey)
        self._orders_store = [np.asarray(c) for c in (orderkey, o_custkey, o_orderdate, o_shippriority)]
        self._lineitem_store = [
            np.asarray(c)
            for c in (l_orderkey, l_extendedprice, l_discount, l_shipdate, l_quantity, l_partkey)
        ]
        return TpchTables(
            customer=(custkey, mktsegment, nationkey),
            orders=(orderkey, o_custkey, o_orderdate, o_shippriority),
            lineitem=(l_orderkey, l_extendedprice, l_discount, l_shipdate, l_quantity, l_partkey),
            part=(partkey, p_brand, p_container),
        )

    def _customer_cols(self) -> tuple:
        return self._customer

    def initial_batches(self, tick: int = 0) -> dict[str, UpdateBatch]:
        t = self.initial()
        out = {}
        for name in ("customer", "orders", "lineitem", "part"):
            cols = tuple(c.astype(self.val_dtype) for c in getattr(t, name))
            n = len(cols[0])
            out[name] = UpdateBatch.build((), cols, np.full(n, tick), np.ones(n, dtype=np.int64),
                                          device=self.device)
        return out

    def refresh(self, tick: int, frac: float = 0.001, deletes: bool = True) -> dict[str, UpdateBatch]:
        """RF1 (insert new orders+lineitems) + RF2 (delete the oldest ones),
        the TPC-H refresh functions — the canonical IVM update stream."""
        if self._orders_store is None:
            raise RuntimeError("call initial()/initial_batches() first")
        n_new = max(int(self.n_orders * frac), 1)
        rng = self.rng
        new_ok = np.arange(self.next_orderkey, self.next_orderkey + n_new, dtype=np.int64)
        self.next_orderkey += n_new
        o_cols = (
            new_ok,
            rng.integers(0, self.n_customer, n_new).astype(np.int64),
            rng.integers(0, 2406, n_new).astype(np.int64),
            np.zeros(n_new, dtype=np.int64),
        )
        nli = rng.integers(1, 8, n_new)
        lk = np.repeat(new_ok, nli)
        n_l = len(lk)
        l_cols = (
            lk,
            rng.integers(100_00, 100_000_00, n_l).astype(np.int64),
            rng.integers(0, 11, n_l).astype(np.int64),
            rng.integers(0, 2557, n_l).astype(np.int64),
            rng.integers(1, 51, n_l).astype(np.int64),
            rng.integers(0, self.n_part, n_l).astype(np.int64),
        )

        o_out = [o_cols]
        l_out = [l_cols]
        o_diffs = [np.ones(n_new, dtype=np.int64)]
        l_diffs = [np.ones(n_l, dtype=np.int64)]
        if deletes:
            # RF2: retract the n_new oldest live orders and their lineitems
            del_ok = self._orders_store[0][:n_new]
            o_out.append(tuple(c[:n_new] for c in self._orders_store))
            o_diffs.append(-np.ones(len(del_ok), dtype=np.int64))
            mask = np.isin(self._lineitem_store[0], del_ok)
            o_del_l = tuple(c[mask] for c in self._lineitem_store)
            l_out.append(o_del_l)
            l_diffs.append(-np.ones(len(o_del_l[0]), dtype=np.int64))
            self._orders_store = [c[n_new:] for c in self._orders_store]
            self._lineitem_store = [c[~mask] for c in self._lineitem_store]
        self._orders_store = [
            np.concatenate([a, b]) for a, b in zip(self._orders_store, o_cols)
        ]
        self._lineitem_store = [
            np.concatenate([a, b]) for a, b in zip(self._lineitem_store, l_cols)
        ]

        o_all = tuple(np.concatenate([p[i] for p in o_out]) for i in range(4))
        l_all = tuple(np.concatenate([p[i] for p in l_out]) for i in range(6))
        od = np.concatenate(o_diffs)
        ld = np.concatenate(l_diffs)
        o_all = tuple(c.astype(self.val_dtype) for c in o_all)
        l_all = tuple(c.astype(self.val_dtype) for c in l_all)
        return {
            "orders": UpdateBatch.build((), o_all, np.full(len(od), tick), od,
                                        device=self.device),
            "lineitem": UpdateBatch.build((), l_all, np.full(len(ld), tick), ld,
                                          device=self.device),
        }
