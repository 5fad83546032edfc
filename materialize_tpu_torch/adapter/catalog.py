"""Catalog: named objects, their schemas, and the shared string dictionary.

Counterpart of materialize_tpu/adapter/catalog.py, in memory only: the
analogue of the reference's `mz-catalog` CatalogState
(src/catalog/src/memory). The mz_* introspection relations are not ported
yet; naming one raises NotImplementedError.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from ..repr.types import ColType, ColumnDesc, RelationDesc, StringDictionary

# the reference's mz_* introspection relations (adapter/introspection.py)
INTROSPECTION_NAMES = frozenset((
    "mz_tables", "mz_views", "mz_materialized_views", "mz_sources", "mz_indexes",
    "mz_columns", "mz_dataflows", "mz_dataflow_operators", "mz_scheduling_elapsed",
    "mz_dataflow_operator_rates", "mz_hydration_statuses", "mz_source_statistics",
    "mz_trace_spans", "mz_peek_durations", "mz_overload_counters",
    "mz_arrangement_sharing", "mz_subscriptions", "mz_sinks", "mz_kernel_dispatch",
    "mz_device_mesh", "mz_arrangement_sizes",
))

# SQL type name → (ColType, scale)
_TYPE_MAP = {
    "int": ColType.INT64,
    "integer": ColType.INT64,
    "bigint": ColType.INT64,
    "smallint": ColType.INT64,
    "int4": ColType.INT64,
    "int8": ColType.INT64,
    "text": ColType.STRING,
    "string": ColType.STRING,
    "varchar": ColType.STRING,
    "char": ColType.STRING,
    "boolean": ColType.BOOL,
    "bool": ColType.BOOL,
    "numeric": ColType.NUMERIC,
    "decimal": ColType.NUMERIC,
    "double": ColType.FLOAT64,
    "float": ColType.FLOAT64,
    "real": ColType.FLOAT64,
    "date": ColType.TIMESTAMP,
    "timestamp": ColType.TIMESTAMP,
    "timestamptz": ColType.TIMESTAMP,
    "jsonb": ColType.JSONB,
    "json": ColType.JSONB,
    "timestamp with time zone": ColType.TIMESTAMP,
}


def coltype_of(sql_type: str) -> ColType:
    base = sql_type.split("(")[0].strip()
    t = _TYPE_MAP.get(base)
    if t is None:
        t = _TYPE_MAP.get(base.split()[0])
    if t is None:
        raise ValueError(f"unsupported SQL type: {sql_type}")
    return t


@dataclass
class CatalogItem:
    name: str
    kind: str  # table | source | view | materialized_view | index | sink
    desc: Optional[RelationDesc] = None
    # views: the SQL query AST + planned MIR; indexes: (on, key column idxs)
    query_ast: object = None
    mir: object = None
    index_on: Optional[str] = None
    index_key: tuple = ()
    # sources: generator kind + options
    generator: Optional[str] = None
    options: tuple = ()
    global_id: str = ""
    append_only: bool = False  # monotonic source (unlocks Monotonic plans)


class Catalog:
    """Name → item map plus the engine-wide string dictionary."""

    def __init__(self) -> None:
        self.items: dict[str, CatalogItem] = {}
        self.dict = StringDictionary()
        from ..expr.strings import StringFuncTables

        # engine-wide string-function code tables, tied to this dictionary
        self.str_tables = StringFuncTables(self.dict)
        self._next_id = 0

    def allocate_id(self, prefix: str = "u") -> str:
        v = self._next_id
        self._next_id += 1
        return f"{prefix}{v}"

    def create(self, item: CatalogItem) -> CatalogItem:
        if item.name in self.items:
            raise ValueError(f"catalog item already exists: {item.name}")
        if not item.global_id:
            item.global_id = self.allocate_id()
        self.items[item.name] = item
        return item

    def drop(self, name: str, if_exists: bool = False) -> Optional[CatalogItem]:
        item = self.items.pop(name, None)
        if item is None and not if_exists:
            raise ValueError(f"unknown catalog item: {name}")
        return item

    def get(self, name: str) -> CatalogItem:
        item = self.items.get(name)
        if item is None:
            if name in INTROSPECTION_NAMES:
                raise NotImplementedError(
                    f"{name} needs adapter/introspection.py, which is not ported yet")
            raise ValueError(f"unknown catalog item: {name}")
        return item

    def maybe(self, name: str) -> Optional[CatalogItem]:
        return self.items.get(name)

    def indexes_on(self, obj_name: str) -> list[CatalogItem]:
        return [
            i
            for i in self.items.values()
            if i.kind == "index" and i.index_on == obj_name
        ]
