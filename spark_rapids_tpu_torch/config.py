"""The configuration keys the port reads.

A copy, with the same keys and defaults, of the entries of
spark_rapids_tpu/config.py that the port's operators consult.  Device
selection is a constructor argument of TpuSession, not a key.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

_REGISTRY: "Dict[str, ConfEntry]" = {}


def _to_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    raise ValueError(f"not a boolean: {v!r}")


class ConfEntry:
    def __init__(self, key: str, default: Any, doc: str,
                 converter: Callable[[Any], Any]):
        self.key = key
        self.default = default
        self.doc = doc
        self.converter = converter
        _REGISTRY[key] = self


MAX_READER_BATCH_SIZE_ROWS = ConfEntry(
    "spark.rapids.sql.reader.batchSizeRows", 2 ** 31 - 1,
    "Soft cap on rows per batch produced by the in-memory scan.", int)
VARIABLE_FLOAT_AGG = ConfEntry(
    "spark.rapids.sql.variableFloatAgg.enabled", False,
    "Allow float/double aggregations whose result may differ in last-bit "
    "rounding from CPU due to reduction order.", _to_bool)
AGG_MERGE_FAN_IN = ConfEntry(
    "spark.rapids.sql.tpu.agg.mergeFanIn", 8,
    "Number of per-batch partial aggregate states buffered before one "
    "K-way concat+merge.", int)
AGG_BUCKET_GROUPS = ConfEntry(
    "spark.rapids.sql.tpu.agg.bucketGroups", True,
    "Low-cardinality grouped-aggregate fast path: rows scatter into hash "
    "buckets and per-bucket states replace the per-batch sort when every "
    "bucket holds one distinct key (checked exactly per batch; dirty "
    "batches take the sort path).", _to_bool)
SORT_PACKED_ENABLED = ConfEntry(
    "spark.rapids.sql.tpu.sort.packed.enabled", True,
    "One-shot packed-key sort: fuse the order-preserving integer sort keys "
    "into 64-bit words with the row id in the low bits and order rows with "
    "single-operand word sorts; false restores the multi-key lexsort.",
    _to_bool)


class TpuConf:
    """Session settings over the registry's defaults.  Keys the port does
    not read are kept and ignored."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})

    def get(self, entry: ConfEntry):
        raw = self._settings.get(entry.key)
        return entry.default if raw is None else entry.converter(raw)
