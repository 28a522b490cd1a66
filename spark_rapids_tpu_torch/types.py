"""Data types of the port, mapped onto torch dtypes.

The same ten SQL types as spark_rapids_tpu/types.py, with the same
device layout:
  * numeric/bool/date/timestamp columns -> one tensor [capacity]
  * DateType      -> int32 days since 1970-01-01
  * TimestampType -> int64 microseconds since the epoch, UTC
  * StringType    -> uint8 byte matrix [capacity, max_len] of padded UTF-8
                     plus an int32 length column
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataType:
    """A SQL-level column type."""

    name: str
    # dtype of the data buffer (None for types with a special layout)
    np_dtype: Optional[np.dtype]

    def __repr__(self) -> str:
        return self.name

    @property
    def is_numeric(self) -> bool:
        return self in (ByteType, ShortType, IntegerType, LongType,
                        FloatType, DoubleType)

    @property
    def is_integral(self) -> bool:
        return self in (ByteType, ShortType, IntegerType, LongType)

    @property
    def is_floating(self) -> bool:
        return self in (FloatType, DoubleType)

    @property
    def is_string(self) -> bool:
        return self is StringType

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.np_dtype is None:
            raise TypeError(f"{self.name} has no single-buffer dtype")
        return _TORCH[self.np_dtype]


_TORCH = {np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
          np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
          np.dtype(np.int64): torch.int64,
          np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}

BooleanType = DataType("boolean", np.dtype(np.bool_))
ByteType = DataType("byte", np.dtype(np.int8))
ShortType = DataType("short", np.dtype(np.int16))
IntegerType = DataType("int", np.dtype(np.int32))
LongType = DataType("long", np.dtype(np.int64))
FloatType = DataType("float", np.dtype(np.float32))
DoubleType = DataType("double", np.dtype(np.float64))
DateType = DataType("date", np.dtype(np.int32))
TimestampType = DataType("timestamp", np.dtype(np.int64))
StringType = DataType("string", None)
NullType = DataType("null", None)

# every type by its name, as the DSL's `cast` spells it
TYPES_BY_NAME = {t.name: t for t in (
    BooleanType, ByteType, ShortType, IntegerType, LongType, FloatType,
    DoubleType, DateType, TimestampType, StringType, NullType)}

_NUMERIC_ORDER = [ByteType, ShortType, IntegerType, LongType, FloatType,
                  DoubleType]


def promote(a: DataType, b: DataType) -> DataType:
    """Numeric type promotion for binary arithmetic."""
    if a is b:
        return a
    if a.is_numeric and b.is_numeric:
        winner = _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(a),
                                    _NUMERIC_ORDER.index(b))]
        # int64 with float32 -> float64, like Spark
        if winner.is_floating and LongType in (a, b):
            return DoubleType
        return winner
    raise TypeError(f"cannot promote {a} and {b}")


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: tuple

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i):
        return self.fields[i]

    @property
    def names(self):
        return [f.name for f in self.fields]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __repr__(self):
        inner = ", ".join(f"{f.name}:{f.dtype.name}" for f in self.fields)
        return f"Schema({inner})"
