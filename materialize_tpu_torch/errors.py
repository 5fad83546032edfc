"""SQLSTATE-carrying errors that the port's dataflow layer raises.

Counterpart of materialize_tpu/errors.py, as far as the dataflow layer
and the in-memory coordinator need it: `SqlError`, the base that carries a
pg SQLSTATE to the wire; `QueryCanceled` (57014, statement_timeout or a
cancel); `AdmissionShed` (53300, a full admission queue, retryable); and
`ResultSizeExceeded` (53400), which a peek raises when its expansion would
pass `max_result_size`. The other codes come with the serving layers.
"""

from __future__ import annotations


class SqlError(Exception):
    """Base for errors that carry a pg SQLSTATE to the wire."""

    sqlstate = "XX000"
    #: sheds are safe to retry verbatim; cancels/limits are not
    retryable = False


class QueryCanceled(SqlError):
    """Cooperative cancellation: statement_timeout or CancelRequest (57014)."""

    sqlstate = "57014"


class AdmissionShed(SqlError):
    """Load shed by an admission gate: the work queue was full (53300).

    Retryable by contract: nothing about the statement itself was wrong."""

    sqlstate = "53300"
    retryable = True


class ResultSizeExceeded(SqlError):
    """Result would exceed max_result_size; aborted before full
    materialization (53400)."""

    sqlstate = "53400"
