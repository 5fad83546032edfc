"""Worker-sharded execution: the shared routing rule, the worker mesh, its
exchange and the fixed-capacity operator steps.

Counterpart of materialize_tpu/parallel/: `routing.py` (the one routing
rule), `mesh.py` (a worker mesh over CUDA devices), `devicemesh/` (the
exchange policy, hash-routed all-to-all between the workers, `mesh_run` and
the tick builder `mesh_tick`) and `fused.py` (fixed-capacity steps). The
names below are exported as the reference exports them, but resolved on
first use: ops/kernels/route.py imports `routing` from below this package,
and the exchange imports the kernels, so importing them here would be a
cycle.
"""

from importlib import import_module

_EXPORTS = {
    "exchange": ".devicemesh",
    "mesh_tick": ".devicemesh",
    "resolve_exchange_mesh": ".devicemesh",
    "route_to_buckets": ".devicemesh",
    "arrangement_insert": ".fused",
    "fused_accumulable_step": ".fused",
    "fused_join_delta": ".fused",
    "WORKERS": ".mesh",
    "make_mesh": ".mesh",
    "route_mod": ".routing",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(_EXPORTS[name], __name__), name)
