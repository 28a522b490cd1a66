"""Device columns.

A column is a few tensors on one device:

  * data    : [capacity] (numeric/bool/date/timestamp)
              or uint8 [capacity, max_len] (strings, padded UTF-8 bytes)
  * valid   : bool [capacity] (True = non-null)
  * lengths : int32 [capacity] (strings only)

`capacity` is a bucketed size (see batch.py); the live rows of a batch are
its `sel` mask.  Null slots hold zeros so masked reductions stay clean.
Operators never write into a column they were given.
"""
from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import torch

from ..types import DataType, DateType, StringType, TimestampType


class Column:
    __slots__ = ("data", "valid", "lengths", "dtype")

    def __init__(self, data: torch.Tensor, valid: torch.Tensor,
                 dtype: DataType, lengths: Optional[torch.Tensor] = None):
        self.data = data
        self.valid = valid
        self.dtype = dtype
        self.lengths = lengths

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def max_len(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    # ---- constructors ------------------------------------------------------

    @staticmethod
    def from_numpy(values: np.ndarray, valid: Optional[np.ndarray],
                   dtype: DataType, capacity: int,
                   device) -> "Column":
        """A column from numpy values (dates as int32 days or
        datetime64[D]), padded to `capacity`; null slots are zeroed."""
        n = len(values)
        arr = np.asarray(values)
        if dtype is DateType and arr.dtype.kind == "M":
            arr = arr.astype("datetime64[D]").astype(np.int64)
        if dtype is TimestampType and arr.dtype.kind == "M":
            arr = arr.astype("datetime64[us]").astype(np.int64)
        data = np.zeros(capacity, dtype=dtype.np_dtype)
        data[:n] = arr
        vfull = np.zeros(capacity, dtype=np.bool_)
        vfull[:n] = True if valid is None else valid
        data[~vfull] = 0
        return Column(torch.from_numpy(data).to(device),
                      torch.from_numpy(vfull).to(device), dtype)

    @staticmethod
    def from_strings(values, valid: Optional[np.ndarray], capacity: int,
                     device, max_len: Optional[int] = None) -> "Column":
        """A string column from a numpy `S`/`U` array (null slots given by
        `valid`), built as one byte matrix with no per-row loop."""
        arr = np.asarray(values)
        if arr.dtype.kind == "U":
            arr = np.char.encode(arr, "utf-8")
        if arr.dtype.kind != "S":
            raise TypeError(f"string column from dtype {arr.dtype}")
        n = len(arr)
        width = arr.dtype.itemsize
        raw = (np.frombuffer(arr.tobytes(), dtype=np.uint8).reshape(n, width)
               if n and width else np.zeros((n, width), np.uint8))
        # numpy drops trailing NUL bytes: a row's length is one past its
        # last non-zero byte
        nz = raw != 0
        lens = (np.where(nz.any(axis=1),
                         width - np.argmax(nz[:, ::-1], axis=1), 0)
                if raw.shape[1] else np.zeros(n, dtype=np.int64))
        vfull = np.zeros(capacity, dtype=np.bool_)
        vfull[:n] = True if valid is None else valid
        ml = max_len if max_len is not None else bucket_strlen(
            int(lens[vfull[:n]].max()) if vfull[:n].any() else 0)
        data = np.zeros((capacity, ml), dtype=np.uint8)
        w = min(width, ml)
        data[:n, :w] = raw[:, :w]
        lengths = np.zeros(capacity, dtype=np.int32)
        lengths[:n] = lens
        data[~vfull] = 0
        lengths[~vfull] = 0
        return Column(torch.from_numpy(data).to(device),
                      torch.from_numpy(vfull).to(device), StringType,
                      torch.from_numpy(lengths).to(device))

    @staticmethod
    def all_null(dtype: DataType, capacity: int, device,
                 max_len: int = 8) -> "Column":
        valid = torch.zeros(capacity, dtype=torch.bool, device=device)
        if dtype.is_string:
            return Column(torch.zeros((capacity, max_len), dtype=torch.uint8,
                                      device=device), valid, dtype,
                          torch.zeros(capacity, dtype=torch.int32,
                                      device=device))
        return Column(torch.zeros(capacity, dtype=dtype.torch_dtype,
                                  device=device), valid, dtype)

    # ---- host materialization ---------------------------------------------

    def to_numpy(self, rows: torch.Tensor):
        """(values, valid) of the rows at index tensor `rows`, on the host.
        Strings come back as a numpy unicode array, dates as
        datetime64[D], timestamps as datetime64[us]."""
        valid = self.valid[rows].cpu().numpy()
        data = self.data[rows].cpu().numpy()
        if self.dtype.is_string:
            lens = np.where(valid, self.lengths[rows].cpu().numpy(), 0)
            width = data.shape[1]
            if width == 0:
                return np.zeros(len(valid), dtype="U1"), valid
            keep = np.arange(width)[None, :] < lens[:, None]
            data = np.ascontiguousarray(np.where(keep, data, 0))
            as_bytes = data.view(f"S{width}").reshape(-1)
            return np.char.decode(as_bytes, "utf-8", "replace"), valid
        if self.dtype is DateType:
            return data.astype("datetime64[D]"), valid
        if self.dtype is TimestampType:
            return data.astype("datetime64[us]"), valid
        return data, valid

    def to_pylist(self, rows: torch.Tensor) -> list:
        """Python values of the rows at `rows` (None for null)."""
        data, valid = self.to_numpy(rows)
        if self.dtype is DateType:
            epoch = datetime.date(1970, 1, 1)
            out = [epoch + datetime.timedelta(days=int(d))
                   for d in data.astype(np.int64)]
        elif self.dtype is TimestampType:
            epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
            out = [epoch + datetime.timedelta(microseconds=int(t))
                   for t in data.astype(np.int64)]
        else:
            out = data.tolist()
        if valid.all():
            return out
        return [v if ok else None for v, ok in zip(out, valid)]

    # ---- structural ops -----------------------------------------------------

    def take(self, indices: torch.Tensor) -> "Column":
        """Gather rows; indices are clamped into range (out-of-range rows
        are garbage the caller masks)."""
        idx = indices.long().clamp(0, self.capacity - 1)
        return Column(self.data[idx], self.valid[idx], self.dtype,
                      self.lengths[idx] if self.dtype.is_string else None)

    def with_valid(self, valid: torch.Tensor) -> "Column":
        return Column(self.data, valid, self.dtype, self.lengths)

    def mask_invalid(self) -> "Column":
        """Zero data in null slots."""
        if self.dtype.is_string:
            return Column(torch.where(self.valid[:, None], self.data, 0),
                          self.valid, self.dtype,
                          torch.where(self.valid, self.lengths, 0))
        zero = torch.zeros((), dtype=self.data.dtype, device=self.device)
        return Column(torch.where(self.valid, self.data, zero), self.valid,
                      self.dtype)

    def pad_strings_to(self, max_len: int) -> "Column":
        cur = self.max_len
        if cur == max_len:
            return self
        if cur > max_len:
            raise ValueError(f"cannot shrink string column {cur} -> "
                             f"{max_len}")
        if self.capacity and self.data.stride(0) == 0:
            # a literal's one row broadcast to every row: pad the row
            row = torch.zeros(max_len, dtype=torch.uint8, device=self.device)
            row[:cur] = self.data[0]
            return Column(row.expand(self.capacity, max_len), self.valid,
                          self.dtype, self.lengths)
        pad = torch.zeros((self.capacity, max_len - cur), dtype=torch.uint8,
                          device=self.device)
        return Column(torch.cat([self.data, pad], dim=1), self.valid,
                      self.dtype, self.lengths)

    def __repr__(self):
        return f"Column({self.dtype.name}, cap={self.capacity})"


def bucket_strlen(n: int, minimum: int = 8) -> int:
    """Round a string max-length up to a power-of-two bucket."""
    b = minimum
    while b < n:
        b <<= 1
    return b
