"""The in-memory coordinator, its catalog and its timestamp oracle.

Counterpart of materialize_tpu/adapter/.
"""

from .catalog import Catalog, CatalogItem
from .coordinator import Coordinator, ExecResult, TimestampOracle

__all__ = ["Catalog", "CatalogItem", "Coordinator", "ExecResult", "TimestampOracle"]
