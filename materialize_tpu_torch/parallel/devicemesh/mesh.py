"""Device-mesh formation and the host-vs-device exchange policy.

Counterpart of materialize_tpu/parallel/devicemesh/mesh.py. The device
exchange plane runs one tick over a mesh of workers (a tuple of
`torch.device`s, parallel/mesh.py), whose per-operator shuffle is the
in-memory all-to-all of `devicemesh/exchange.py`. This module decides when
that plane applies (`resolve_exchange_mesh`, driven by the
`exchange_backend` setting) and reports what it formed (`device_mesh_rows`,
the rows of the `mz_device_mesh` relation).

Policy:

- ``host``   - never form a mesh; the single-device renderers carry
  everything. The force-disable escape hatch.
- ``device`` - use the mesh the caller gave, or form one over every visible
  CUDA device. Without a CUDA device that raises: the policy never falls
  back to the CPU.
- ``auto``   - use a mesh the caller gave as it is; otherwise form one only
  for a dataflow on a CUDA device, with more than one CUDA device visible.
  A CPU mesh is a test harness, not a win, so auto stays host unless the
  caller built a mesh.
"""

from __future__ import annotations

import torch

from ..mesh import WORKERS, make_mesh

EXCHANGE_MODES = ("auto", "host", "device")


def local_device_count() -> int:
    """Visible CUDA devices (0 without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def form_device_mesh(n_devices: int | None = None) -> tuple:
    """A mesh of `n_devices` workers, one per visible CUDA device (all of
    them if None). Raises without a CUDA device, or with fewer than asked."""
    have = local_device_count()
    if have == 0:
        raise RuntimeError("form_device_mesh: no CUDA device is visible")
    n = have if n_devices is None else int(n_devices)
    if n > have:
        raise ValueError(f"need {n} devices, have {have}")
    return make_mesh(n)


def resolve_exchange_mesh(mode: str, mesh=None, device="cuda"):
    """Apply the `exchange_backend` policy: the mesh to render over, or None
    (the host plane: the single-device renderers exactly as before the
    plane existed). `device` is the dataflow's: under ``auto`` only a CUDA
    dataflow forms a mesh of its own."""
    if mode not in EXCHANGE_MODES:
        raise ValueError(f"exchange_backend must be one of {EXCHANGE_MODES}, got {mode!r}")
    if mode == "host":
        return None
    if mode == "device":
        return mesh if mesh is not None else form_device_mesh()
    if mesh is not None:
        return mesh
    if torch.device(device).type == "cuda" and local_device_count() > 1:
        return form_device_mesh()
    return None


def device_mesh_rows(mesh, backend: str) -> list:
    """Rows of `mz_device_mesh`: (position, device, platform, axis, axis
    size, member, backend), one per visible CUDA device, mesh members
    marked. `mesh` may be None (host mode): the devices are still listed.
    A mesh on the CPU lists its one CPU device instead."""
    axis, axis_size, members = "", 0, frozenset()
    if mesh is not None:
        axis, axis_size = WORKERS, len(mesh)
        members = frozenset(str(d) for d in mesh)
    devices = [torch.device("cuda", i) for i in range(local_device_count())]
    if mesh is not None and not devices:
        devices = sorted({d for d in mesh}, key=str)
    rows = []
    for pos, dev in enumerate(devices):
        plat = "gpu" if dev.type == "cuda" else dev.type
        rows.append((pos, f"{plat}:{dev.index or 0}", plat, axis, axis_size,
                     str(dev) in members, str(backend)))
    return rows
