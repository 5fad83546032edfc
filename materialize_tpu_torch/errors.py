"""SQLSTATE-carrying errors that the port's dataflow layer raises.

Counterpart of materialize_tpu/errors.py, as far as the dataflow layer
needs it: `SqlError`, the base that carries a pg SQLSTATE to the wire, and
`ResultSizeExceeded` (53400), which a peek raises when its expansion would
pass `max_result_size`. The other codes come with the serving layers.
"""

from __future__ import annotations


class SqlError(Exception):
    """Base for errors that carry a pg SQLSTATE to the wire."""

    sqlstate = "XX000"
    #: sheds are safe to retry verbatim; cancels/limits are not
    retryable = False


class ResultSizeExceeded(SqlError):
    """Result would exceed max_result_size; aborted before full
    materialization (53400)."""

    sqlstate = "53400"
