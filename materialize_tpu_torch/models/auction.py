"""Auction workload dataflows: baseline configs 1, 2 and 4 (BASELINE.md).

Counterpart of materialize_tpu/models/auction.py. Hand-planned LIR for the
three auction-source views:
  1. SUM/COUNT materialized view over append-only bids   (single reduce)
  2. auctions ⋈ bids two-way equi-join                   (linear join)
  4. max-bid-per-auction TOP-K                           (topk kernel)
and two views of the port's own, which only the host renderer renders:
  - the sliding window of Materialize's temporal-filter documentation:
    SUM/COUNT by auction of the bids of the last `window` ticks
    (TemporalFilter, then a reduce);
  - each bid's rank in its auction by amount (a row_number Window).
`views()` exports several of them from one description.

Schemas follow the reference auction load generator
(src/storage-types/src/sources/load_generator.rs:185-240):
  auctions(id, seller, item, end_time)   bids(id, buyer, auction_id, amount, bid_time)
"""

from __future__ import annotations

import numpy as np

from ..dataflow import BuildDesc, DataflowDescription
from ..dataflow import plan as lir
from ..expr import CallBinary, Column, Literal, MapFilterProject
from ..ops.reduce import AggregateExpr
from ..ops.topk import TopKPlan
from ..ops.window import WindowFuncSpec, WindowPlan

I64 = np.dtype(np.int64)

AUCTIONS_DTYPES = (I64, I64, I64, I64)  # id, seller, item(code), end_time
BIDS_DTYPES = (I64, I64, I64, I64, I64)  # id, buyer, auction_id, amount, bid_time


def bids_sum_count() -> DataflowDescription:
    """Config 1: SELECT auction_id, sum(amount), count(*) FROM bids GROUP BY 1."""
    return DataflowDescription(
        source_imports={"bids": BIDS_DTYPES},
        objects_to_build=[
            BuildDesc(
                "mv_bids_sum",
                lir.Reduce(
                    lir.Get("bids"),
                    key_cols=(2,),
                    aggs=(
                        AggregateExpr("sum", Column(3)),
                        AggregateExpr("count", Literal(1)),
                    ),
                ),
                (I64, I64, I64),
            )
        ],
        index_exports={"idx_bids_sum": ("mv_bids_sum", (0,))},
    )


def auctions_join_bids() -> DataflowDescription:
    """Config 2: SELECT * FROM auctions a JOIN bids b ON a.id = b.auction_id."""
    return DataflowDescription(
        source_imports={"auctions": AUCTIONS_DTYPES, "bids": BIDS_DTYPES},
        objects_to_build=[
            BuildDesc(
                "mv_join",
                lir.Join(
                    inputs=(lir.Get("auctions"), lir.Get("bids")),
                    plan=lir.LinearJoinPlan(
                        stages=(lir.JoinStage(stream_key=(0,), lookup_key=(2,)),)
                    ),
                ),
                AUCTIONS_DTYPES + BIDS_DTYPES,
            )
        ],
        index_exports={"idx_join": ("mv_join", (0,))},
    )


def max_bid_per_auction() -> DataflowDescription:
    """Config 4: top-1 bid per auction by amount (hierarchical top_k analogue)."""
    return DataflowDescription(
        source_imports={"bids": BIDS_DTYPES},
        objects_to_build=[
            BuildDesc(
                "mv_topk",
                lir.TopK(
                    lir.Get("bids"),
                    TopKPlan(group_cols=(2,), order_by=((3, True),), limit=1),
                ),
                BIDS_DTYPES,
            )
        ],
        index_exports={"idx_topk": ("mv_topk", (0,))},
    )


def live_bids_sum_count(window: int = 16) -> DataflowDescription:
    """SELECT auction_id, sum(amount), count(*) FROM bids
    WHERE mz_now() < bid_time + window GROUP BY 1: each bid counts for
    `window` ticks from its bid_time, then is retracted by the passage of
    time (an upper bound only)."""
    live = lir.TemporalFilter(lir.Get("bids"), lowers=(),
                              uppers=(CallBinary("add", Column(4), Literal(window)),))
    keyed = lir.Mfp(live, MapFilterProject(5, projection=(2, 3)))
    return DataflowDescription(
        source_imports={"bids": BIDS_DTYPES},
        objects_to_build=[BuildDesc(
            "mv_live_sum",
            lir.Reduce(keyed, key_cols=(0,),
                       aggs=(AggregateExpr("sum", Column(1)), AggregateExpr("count", Literal(1)))),
            (I64, I64, I64))],
        index_exports={"idx_live_sum": ("mv_live_sum", (0,))},
    )


def bid_rank() -> DataflowDescription:
    """SELECT *, row_number() OVER (PARTITION BY auction_id ORDER BY amount
    DESC, id) FROM bids."""
    plan = WindowPlan(partition_cols=(2,), order_by=((3, True), (0, False)),
                      funcs=(WindowFuncSpec("row_number"),))
    return DataflowDescription(
        source_imports={"bids": BIDS_DTYPES},
        objects_to_build=[BuildDesc("mv_rank", lir.Window(lir.Get("bids"), plan),
                                    BIDS_DTYPES + (I64,))],
        index_exports={"idx_rank": ("mv_rank", (2,))},
    )


def views(*descs: DataflowDescription) -> DataflowDescription:
    """One description exporting every object and index of `descs` (their
    ids must differ; their sources must agree)."""
    sources: dict = {}
    builds, indexes = [], {}
    for d in descs:
        for sid, dts in d.source_imports.items():
            if sources.setdefault(sid, dts) != dts:
                raise ValueError(f"source {sid} differs between views")
        builds += d.objects_to_build
        indexes.update(d.index_exports)
    return DataflowDescription(source_imports=sources, objects_to_build=builds,
                               index_exports=indexes)
