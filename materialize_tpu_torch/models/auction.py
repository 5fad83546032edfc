"""Auction workload dataflows: baseline configs 1, 2 and 4 (BASELINE.md).

Counterpart of materialize_tpu/models/auction.py. Hand-planned LIR for the
three auction-source views:
  1. SUM/COUNT materialized view over append-only bids   (single reduce)
  2. auctions ⋈ bids two-way equi-join                   (linear join)
  4. max-bid-per-auction TOP-K                           (topk kernel)

Schemas follow the reference auction load generator
(src/storage-types/src/sources/load_generator.rs:185-240):
  auctions(id, seller, item, end_time)   bids(id, buyer, auction_id, amount, bid_time)
"""

from __future__ import annotations

import numpy as np

from ..dataflow import BuildDesc, DataflowDescription
from ..dataflow import plan as lir
from ..expr import Column, Literal
from ..ops.reduce import AggregateExpr
from ..ops.topk import TopKPlan

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
