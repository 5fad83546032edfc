"""Worker-sharded execution: the shared routing rule, the worker mesh and
its exchange.

Counterpart of materialize_tpu/parallel/ for the mesh-sharded tick:
`routing.py` (the one routing rule), `mesh.py` (a worker mesh over CUDA
devices), `devicemesh/exchange.py` (hash-routed all-to-all between the
workers, and `mesh_run`, which runs one function on every worker). Nothing
is imported here: ops/kernels/route.py imports `routing` from below this
package, and the exchange imports the kernels.
"""
