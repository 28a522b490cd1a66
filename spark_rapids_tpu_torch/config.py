"""The configuration keys the port reads.

A copy, with the same keys, defaults and parsers, of the entries of
spark_rapids_tpu/config.py that the port's operators and planner
consult.  Device selection is a constructor argument of TpuSession, not
a key.
"""
from __future__ import annotations

import re
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


_BYTE_SUFFIXES = {"b": 1, "k": 1 << 10, "kb": 1 << 10, "m": 1 << 20,
                  "mb": 1 << 20, "g": 1 << 30, "gb": 1 << 30, "t": 1 << 40,
                  "tb": 1 << 40}


def to_bytes(v) -> int:
    """Parse '2g', '512m', '1024' -> bytes."""
    if isinstance(v, (int, float)):
        return int(v)
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]*)\s*", str(v))
    if not m:
        raise ValueError(f"not a byte size: {v!r}")
    num, suf = float(m.group(1)), m.group(2).lower()
    if suf == "":
        return int(num)
    if suf not in _BYTE_SUFFIXES:
        raise ValueError(f"unknown byte suffix {suf!r} in {v!r}")
    return int(num * _BYTE_SUFFIXES[suf])


def _to_bytes_or_disabled(v) -> int:
    """A byte size, or a negative integer meaning 'disabled' (Spark's
    autoBroadcastJoinThreshold=-1)."""
    s = str(v).strip()
    if re.fullmatch(r"-\d+", s):
        return int(s)
    return to_bytes(v)


class ConfEntry:
    def __init__(self, key: str, default: Any, doc: str,
                 converter: Callable[[Any], Any]):
        self.key = key
        self.default = default
        self.doc = doc
        self.converter = converter
        _REGISTRY[key] = self


BATCH_SIZE_BYTES = ConfEntry(
    "spark.rapids.sql.batchSizeBytes", 2 << 30,
    "Target size in bytes for TPU columnar batches; operators coalesce "
    "smaller batches up to this goal (reference default 2GiB).", to_bytes)
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

PARTITIONED_JOIN_ENABLED = ConfEntry(
    "spark.rapids.sql.tpu.join.partitioned.enabled", True,
    "Insert hash-partition exchanges around non-broadcast equi-joins so "
    "the build side is bounded per partition (EnsureRequirements "
    "analogue; reference GpuShuffledHashJoinExec).", _to_bool)
PARTITIONED_JOIN_THRESHOLD = ConfEntry(
    "spark.rapids.sql.tpu.join.partitioned.threshold", 64 << 20,
    "Estimated build-side bytes above which a non-broadcast join is "
    "planned with partition exchanges; below it the whole build side is "
    "one batch.  Unknown sizes partition.", to_bytes)
AUTO_BROADCAST_JOIN_THRESHOLD = ConfEntry(
    "spark.sql.autoBroadcastJoinThreshold", 10 << 20,
    "Maximum estimated size in bytes of a join build side that will be "
    "broadcast to every consumer instead of shuffled (Spark's conf key; "
    "-1 disables broadcast joins).", _to_bytes_or_disabled)
CAST_STRING_TO_FLOAT = ConfEntry(
    "spark.rapids.sql.castStringToFloat.enabled", False,
    "Enable string->float casts on device; off by default because corner-case "
    "formats differ from the CPU.", _to_bool)
CAST_STRING_TO_TIMESTAMP = ConfEntry(
    "spark.rapids.sql.castStringToTimestamp.enabled", False,
    "Enable string->timestamp casts on device.", _to_bool)


class TpuConf:
    """Session settings over the registry's defaults.  Keys the port does
    not read are kept and ignored."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})

    def get(self, entry: ConfEntry):
        raw = self._settings.get(entry.key)
        return entry.default if raw is None else entry.converter(raw)
