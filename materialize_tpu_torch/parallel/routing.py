"""The one shard-routing rule, shared by every partitioner of the port.

Counterpart of materialize_tpu/parallel/routing.py. A row's destination
worker is ``u32 key hash % n_dest``. The port carries u32 hashes as int64 in
[0, 2^32), where the int64 remainder equals the u32 one. The `route_dest`
kernel (ops/kernels/route.py) computes this function, and its plain version
calls it.
"""

from __future__ import annotations

import torch


def route_mod(hashes: torch.Tensor, n_dest: int) -> torch.Tensor:
    """Destination per row: hash mod ``n_dest`` (int64 in [0, n_dest))."""
    return torch.remainder(hashes, int(n_dest))
