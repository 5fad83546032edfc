"""The worker mesh: the devices that the workers of one process run on.

Counterpart of materialize_tpu/parallel/mesh.py. The JAX package stamps one
`shard_map` program over the devices of one process; the port runs `n`
workers as threads of one process (as Materialize's clusterd runs its timely
workers), each with its shard state on its own `torch.device`, and the
workers exchange rows in memory (devicemesh/exchange.py). A mesh is a tuple
of `torch.device`s, one per worker; several workers may share a device.
"""

from __future__ import annotations

import torch

WORKERS = "workers"


def make_mesh(n_workers: int, device=None) -> tuple:
    """A mesh of `n_workers` workers.

    With `device` None the workers go round-robin over the visible CUDA
    devices (on one card they all share `cuda:0`); without a CUDA device
    this raises, it never falls back to the CPU. A `device` given puts every
    worker on it (`"cpu"` in the tests).
    """
    n_workers = int(n_workers)
    if n_workers < 1:
        raise ValueError(f"a mesh needs at least one worker, got {n_workers}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [_indexed(torch.device(device))]
    return tuple(devices[w % len(devices)] for w in range(n_workers))


def _indexed(d: torch.device) -> torch.device:
    """`cuda` as `cuda:<current device>`: a worker thread's own current
    device would otherwise decide where its tensors go."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d
