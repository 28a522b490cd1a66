"""Columnar batches: columns plus a `sel` mask of live rows, at a bucketed
capacity.

As in spark_rapids_tpu/columnar/batch.py: capacities are powers of two of
at least 1024 (the sort kernel takes power-of-two lengths), filters AND
into `sel` and move no data, and compaction waits for the operators that
need it (concat, sort, shrink).
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..types import Schema
from .column import Column, bucket_strlen


def bucket_rows(n: int, minimum: int = 1024) -> int:
    """Round a row count up to a power-of-two capacity bucket."""
    b = minimum
    while b < n:
        b <<= 1
    return b


class ColumnarBatch:
    __slots__ = ("columns", "sel", "schema", "known_rows")

    def __init__(self, columns: Sequence[Column], sel: torch.Tensor,
                 schema: Schema):
        self.columns = tuple(columns)
        self.sel = sel
        self.schema = schema
        # the live-row count when its producer already holds it on the
        # host (a join's fetched total), so num_rows_host skips a device
        # read; every structural transform drops it
        self.known_rows: Optional[int] = None

    # ---- metadata -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return int(self.sel.shape[0])

    @property
    def device(self) -> torch.device:
        return self.sel.device

    def column(self, i_or_name) -> Column:
        if isinstance(i_or_name, str):
            return self.columns[self.schema.index_of(i_or_name)]
        return self.columns[i_or_name]

    def num_rows(self) -> torch.Tensor:
        """Live-row count as a 0-d device tensor (no host sync)."""
        return self.sel.sum(dtype=torch.int32)

    def num_rows_host(self) -> int:
        if self.known_rows is not None:
            return self.known_rows
        return int(self.num_rows())

    def device_size_bytes(self) -> int:
        """Bytes of the batch's tensors at its capacity (the coalesce's
        size, as the JAX package counts it)."""
        total = self.sel.numel()
        for c in self.columns:
            total += c.data.numel() * c.data.element_size() + c.valid.numel()
            if c.lengths is not None:
                total += c.lengths.numel() * 4
        return total

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    # ---- structural transforms ---------------------------------------------

    def with_sel(self, sel: torch.Tensor) -> "ColumnarBatch":
        return ColumnarBatch(self.columns, sel, self.schema)

    def filter(self, keep: torch.Tensor) -> "ColumnarBatch":
        """AND a predicate into the selection mask; no data moves."""
        return self.with_sel(self.sel & keep)

    def take(self, indices: torch.Tensor,
             sel: Optional[torch.Tensor] = None) -> "ColumnarBatch":
        cols = [c.take(indices) for c in self.columns]
        if sel is None:
            sel = self.sel[indices.long().clamp(0, self.capacity - 1)]
        return ColumnarBatch(cols, sel, self.schema)

    def select_columns(self, indices: Sequence[int],
                       schema: Optional[Schema] = None) -> "ColumnarBatch":
        cols = [self.columns[i] for i in indices]
        if schema is None:
            schema = Schema([self.schema[i] for i in indices])
        return ColumnarBatch(cols, self.sel, schema)

    def shrink_to(self, new_cap: int) -> "ColumnarBatch":
        """Live rows gathered, in order, into a smaller-capacity batch (the
        caller guarantees new_cap >= live rows)."""
        pos = torch.cumsum(self.sel.to(torch.int32), 0, dtype=torch.int32) - 1
        iota = torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device)
        # dead rows scatter to a trash slot past the end
        slot = torch.where(self.sel, pos, new_cap).long()
        idx = torch.zeros(new_cap + 1, dtype=torch.int32, device=self.device)
        idx.scatter_(0, slot, iota)
        idx = idx[:new_cap]
        cols = [c.take(idx) for c in self.columns]
        sel2 = torch.arange(new_cap, device=self.device) < self.num_rows()
        return ColumnarBatch(cols, sel2, self.schema)

    def maybe_shrink(self, n_live: int) -> "ColumnarBatch":
        """shrink_to a bucket when the batch is at least 8x oversized."""
        new_cap = bucket_rows(max(n_live, 1))
        if self.capacity >= 8 * new_cap:
            return self.shrink_to(new_cap)
        return self

    def compact(self, packed: bool = True) -> "ColumnarBatch":
        """Live rows to the front, in order; capacity unchanged.  The
        permutation is a 1-bit packed-key sort (utils/packed_sort)."""
        from ..utils import packed_sort as PS
        cap = self.capacity
        iota = torch.arange(cap, device=self.device)
        if packed and cap & (cap - 1) == 0:
            order = PS.packed_argsort([((~self.sel).long(), 1)], cap)
        else:
            order = torch.argsort(torch.where(self.sel, iota, cap + iota),
                                  stable=True)
        return self.take(order, sel=iota < self.num_rows())

    # ---- host interop -------------------------------------------------------

    @staticmethod
    def from_numpy(columns: Dict[str, object], schema: Schema, device,
                   capacity: Optional[int] = None) -> "ColumnarBatch":
        """A device batch from host columns: numpy arrays (dates as int32
        days or datetime64[D], strings as `S`/`U` arrays), lists, or
        numpy masked arrays (masked = null).  Python lists may hold None."""
        n = len(next(iter(columns.values()))) if columns else 0
        cap = capacity if capacity is not None else bucket_rows(max(n, 1))
        cols = []
        for f in schema:
            vals, valid = _host_values(columns[f.name], f.dtype)
            if f.dtype.is_string:
                cols.append(Column.from_strings(vals, valid, cap, device))
            else:
                cols.append(Column.from_numpy(vals, valid, f.dtype, cap,
                                              device))
        sel = torch.arange(cap, device=device) < n
        return ColumnarBatch(cols, sel, schema)

    def arrow_nbytes(self, n: int) -> int:
        """Bytes of the first `n` rows as Arrow lays them out: n x the
        value width (booleans packed 8 to a byte, strings 4 bytes of
        offset a row plus their UTF-8 bytes), and a bitmap of n / 8 bytes
        for a column with a null.  This is the size of an in-memory table
        the JAX package's planner reads (pyarrow's Table.nbytes)."""
        total = 0
        for c in self.columns:
            if not bool(c.valid[:n].all()):
                total += -(-n // 8)
            if c.dtype.is_string:
                total += 4 * n + int(c.lengths[:n].sum())
            elif c.dtype.name == "boolean":
                total += -(-n // 8)
            else:
                total += n * c.dtype.np_dtype.itemsize
        return total

    def live_rows(self) -> torch.Tensor:
        """Indices of the live rows, in order, on the batch's device."""
        return torch.nonzero(self.sel).flatten()

    def to_pylist(self) -> List[tuple]:
        rows = self.live_rows()
        cols = [c.to_pylist(rows) for c in self.columns]
        return list(zip(*cols)) if cols else [()] * int(rows.numel())

    def to_pydict(self) -> Dict[str, np.ndarray]:
        """Live rows as numpy columns; a column with nulls comes back as a
        masked array.  Raises ValueError when two columns share a name
        (a dict would keep only one of them)."""
        check_unique_names(self.schema)
        rows = self.live_rows()
        out = {}
        for f, c in zip(self.schema, self.columns):
            data, valid = c.to_numpy(rows)
            out[f.name] = (data if valid.all()
                           else np.ma.masked_array(data, mask=~valid))
        return out

    def __repr__(self):
        return f"ColumnarBatch(cap={self.capacity}, schema={self.schema!r})"


def check_unique_names(schema: Schema) -> None:
    """Raise ValueError naming a column name the schema repeats."""
    seen = set()
    for name in schema.names:
        if name in seen:
            raise ValueError(
                f"column name {name!r} is repeated in {schema.names}; "
                "alias the columns apart to get them as a dict")
        seen.add(name)


def _host_values(values, dtype) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(values, valid-or-None) of one host column."""
    if isinstance(values, np.ma.MaskedArray):
        valid = ~np.ma.getmaskarray(values)
        return values.filled(b"" if dtype.is_string else 0), valid
    if isinstance(values, np.ndarray) and values.dtype != object:
        return values, None
    seq = list(values)
    valid = np.array([v is not None for v in seq], dtype=np.bool_)
    if dtype.is_string:
        clean = np.array(["" if v is None else v for v in seq], dtype=str)
    elif dtype.name == "date":
        clean = np.array([0 if v is None else v for v in seq])
        if clean.dtype == object:  # datetime.date values
            clean = clean.astype("datetime64[D]")
    elif dtype.name == "timestamp":
        # datetime.datetime values: a naive one is UTC, an aware one is
        # converted to UTC (as pyarrow reads them for the JAX package)
        clean = np.array([0 if v is None else _naive_utc(v) for v in seq])
        if clean.dtype == object:
            clean = clean.astype("datetime64[us]")
    else:
        clean = np.array([0 if v is None else v for v in seq],
                         dtype=dtype.np_dtype)
    return clean, (None if valid.all() else valid)


def _naive_utc(v):
    if isinstance(v, datetime.datetime) and v.tzinfo is not None:
        return v.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    return v


def batch_from_numpy(columns: Sequence[Sequence[np.ndarray]],
                     sel: np.ndarray, schema: Schema,
                     device="cuda") -> ColumnarBatch:
    """The port's batch from another batch's raw leaves, given as numpy
    arrays: per column (data, valid) or (data, valid, lengths) at the
    batch capacity, plus the `sel` mask.  Carries a ColumnarBatch's state
    across packages unchanged, so both can be fed the same input.  Runs on
    the card unless `device="cpu"` is passed; without a card it raises."""
    device = resolve_device(device)
    def tensor(a, dtype=None):
        # a copy: the leaves may be read-only views of another package's
        # buffers
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    cols = []
    for f, leaves in zip(schema, columns):
        data, valid = tensor(leaves[0]), tensor(leaves[1])
        lengths = None
        if f.dtype.is_string:
            lengths = tensor(leaves[2], np.int32)
        elif data.dtype != f.dtype.torch_dtype:
            raise TypeError(f"{f.name}: {data.dtype} is not "
                            f"{f.dtype.torch_dtype}")
        cols.append(Column(data, valid, f.dtype, lengths))
    return ColumnarBatch(cols, tensor(sel), schema)


def concat_batches(batches: Sequence[ColumnarBatch], packed: bool = True,
                   capacity: Optional[int] = None) -> ColumnarBatch:
    """Live rows of every batch, in order, in one batch whose capacity is
    the bucket of their total."""
    assert batches, "concat of nothing"
    schema = batches[0].schema
    device = batches[0].device
    compacted = [b.compact(packed) for b in batches]
    counts = [b.num_rows_host() for b in compacted]
    total = sum(counts)
    cap = capacity if capacity is not None else bucket_rows(max(total, 1))
    pad = cap - total
    out_cols = []
    for ci, f in enumerate(schema):
        parts = [b.columns[ci] for b in compacted]
        valid = torch.cat([p.valid[:n] for p, n in zip(parts, counts)]
                          + [torch.zeros(pad, dtype=torch.bool,
                                         device=device)])
        if f.dtype.is_string:
            ml = max(p.max_len for p in parts)
            parts = [p.pad_strings_to(ml) for p in parts]
            data = torch.cat([p.data[:n] for p, n in zip(parts, counts)]
                             + [torch.zeros((pad, ml), dtype=torch.uint8,
                                            device=device)])
            lengths = torch.cat([p.lengths[:n] for p, n in zip(parts, counts)]
                                + [torch.zeros(pad, dtype=torch.int32,
                                               device=device)])
            out_cols.append(Column(data, valid, f.dtype, lengths))
        else:
            data = torch.cat([p.data[:n] for p, n in zip(parts, counts)]
                             + [torch.zeros(pad, dtype=parts[0].data.dtype,
                                            device=device)])
            out_cols.append(Column(data, valid, f.dtype))
    sel = torch.arange(cap, device=device) < total
    return ColumnarBatch(out_cols, sel, schema)


__all__ = ["ColumnarBatch", "bucket_rows", "bucket_strlen", "batch_from_numpy",
           "check_unique_names", "concat_batches"]
