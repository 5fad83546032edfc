"""The exchange between the workers of an in-process mesh (exchange.py)."""

from .exchange import (  # noqa: F401
    WorkerComm,
    exchange,
    mesh_run,
    note_overflow_retry,
    overflow_retries,
    route_to_buckets,
)
