"""The device exchange plane: one tick across a mesh of workers.

Mesh policy and formation in `mesh.py`; the in-memory all-to-all exchange,
`mesh_run` and the tick builder `mesh_tick` in `exchange.py`. The
`exchange_backend` setting picks the plane (`resolve_exchange_mesh`).
"""

from .exchange import (  # noqa: F401
    WorkerComm,
    exchange,
    mesh_run,
    mesh_tick,
    note_overflow_retry,
    overflow_retries,
    route_to_buckets,
)
from .mesh import (  # noqa: F401
    EXCHANGE_MODES,
    device_mesh_rows,
    form_device_mesh,
    local_device_count,
    resolve_exchange_mesh,
)
