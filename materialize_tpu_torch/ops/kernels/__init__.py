"""The port's hand-written CUDA kernels and their plain PyTorch versions.

- ``run_sum``    segmented sum by run (segsum.py; every consolidation)
- ``multi_take`` clip-mode multi-column gather (permute.py; every permute
                 and the join and reduce gathers)
- ``probe`` / ``probe2`` fixed-depth binary search, one key or (hi, lo)
                 pairs (probe.py; join ranges, lookups, merge interleaves)
- ``route_dest`` / ``bucket_rank`` destination and bucket slot of each row
                 (route.py; the mesh exchange)

Dispatch is by device (registry.py): CPU tensors take the plain version,
CUDA tensors the kernel, with no fallback.
"""

from .permute import batch_permute, multi_take  # noqa: F401
from .registry import KERNELS, LAUNCHES, reset_launches  # noqa: F401
from .route import bucket_rank, route_dest  # noqa: F401
from .segsum import run_sum  # noqa: F401
