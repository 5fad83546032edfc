"""route_dest / bucket_rank: the exchange's two integer primitives.

Counterparts of materialize_tpu/ops/kernels/route.py. The exchange
(parallel/devicemesh/exchange.py) packs each worker's rows into fixed-size
buckets, one per destination worker:

- ``route_dest``: int64 hashes holding u32 values -> int32 destination,
  ``hash % n_dest`` (the shared rule, parallel/routing.py::route_mod);
- ``bucket_rank``: int32 keys (the destinations in sorted order) -> int32
  rank of each row within its run of equal keys, the bucket slot it fills,
  ``idx - cummax(run_start ? idx : -1)`` on any input, sorted or not.

On a CUDA tensor each wrapper launches its kernel in `csrc/route.cu`; on the
CPU it runs the plain version below. An empty input returns an empty int32
tensor and launches nothing.
"""

from __future__ import annotations

import torch

from ...parallel.routing import route_mod
from . import registry


def plain_route_dest(hashes: torch.Tensor, n_dest: int) -> torch.Tensor:
    return route_mod(hashes, n_dest).to(torch.int32)


def plain_bucket_rank(key_s: torch.Tensor) -> torch.Tensor:
    n = int(key_s.shape[0])
    idx = torch.arange(n, dtype=torch.int32, device=key_s.device)
    if n == 0:
        return idx
    run_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=key_s.device),
                           key_s[1:] != key_s[:-1]])
    first, _ = torch.cummax(torch.where(run_start, idx, -1), 0)
    return idx - first


def route_dest(hashes: torch.Tensor, n_dest: int) -> torch.Tensor:
    """int32 destination ``hash % n_dest`` of every row.

    `hashes` is int64 holding u32 values, each in [0, 2^32): the kernel
    takes a 32-bit modulus, which equals the plain version only there."""
    n_dest = int(n_dest)
    if not 0 < n_dest < 2**31:
        raise ValueError(f"route_dest: n_dest must be in [1, 2^31), got {n_dest}")
    if not registry.on_cuda(hashes):
        return plain_route_dest(hashes, n_dest)
    registry.require(hashes, (torch.int64,), "route_dest: hashes")
    n = int(hashes.shape[0])
    out = torch.empty((n,), dtype=torch.int32, device=hashes.device)
    if n == 0:
        return out
    lib = registry.library("route")
    registry.launch("route_dest", (hashes, n_dest), (n, n_dest))
    with registry.on_device(hashes.device) as stream:
        err = lib.mz_route_dest(registry.ptr(hashes), n, n_dest, registry.ptr(out), stream)
    registry.check(err, "route_dest")
    return out


def bucket_rank(key_s: torch.Tensor) -> torch.Tensor:
    """int32 rank of every row within its run of equal int32 keys."""
    if not registry.on_cuda(key_s):
        return plain_bucket_rank(key_s)
    registry.require(key_s, (torch.int32,), "bucket_rank: key_s")
    n = int(key_s.shape[0])
    if n >= 2**31:
        raise ValueError("bucket_rank: ranks are int32, so n must be below 2^31")
    out = torch.empty((n,), dtype=torch.int32, device=key_s.device)
    if n == 0:
        return out
    lib = registry.library("route")
    scratch = torch.empty((lib.mz_bucket_rank_scratch_bytes(n),), dtype=torch.uint8,
                          device=key_s.device)
    registry.launch("bucket_rank", (key_s,), (n,))
    with registry.on_device(key_s.device) as stream:
        err = lib.mz_bucket_rank(registry.ptr(key_s), n, registry.ptr(out),
                                 registry.ptr(scratch), stream)
    registry.check(err, "bucket_rank")
    return out
