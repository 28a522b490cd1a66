"""Basic operators: the in-memory scan, project, filter, limit, the
coalesce of a stream into one batch or into batches of a target size,
union, the expand of rollup and cube, and the device-to-host edge (port
of the device half of spark_rapids_tpu/exec/basic.py).

Project and filter move no data: filter ANDs into the batch's selection
mask.  Whole-stage fusion does not exist in the port yet; each operator
runs its PyTorch calls eagerly, batch by batch.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Union

import numpy as np
import torch

from ..columnar import Column, ColumnarBatch, bucket_rows, concat_batches
from ..config import (BATCH_SIZE_BYTES, MAX_READER_BATCH_SIZE_ROWS,
                      SORT_PACKED_ENABLED)
from ..ops import expressions as E
from ..types import Schema, StructField
from .base import ExecContext, ExecNode, map_batches


def _pred_keep(col: Column) -> torch.Tensor:
    """A null predicate filters the row out (SQL WHERE semantics)."""
    return col.valid & col.data


class TpuScanMemoryExec(ExecNode):
    """Scan of a table that already lives on the device (one batch at the
    table's capacity), cut into batches of at most
    `spark.rapids.sql.reader.batchSizeRows` rows.  `schema` names the
    columns it produces (a pruned subset of the table's)."""

    def __init__(self, table: ColumnarBatch, num_rows: int, schema: Schema):
        super().__init__()
        if schema != table.schema:
            table = table.select_columns(
                [table.schema.index_of(n) for n in schema.names], schema)
        self.table = table
        self.num_rows = num_rows

    @property
    def schema(self):
        return self.table.schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        limit = max(1, ctx.conf.get(MAX_READER_BATCH_SIZE_ROWS))
        n = self.num_rows
        if n <= limit:
            yield self.table
            return
        for off in range(0, n, limit):
            # built in a call, so that this frame holds no batch while
            # the consumer runs
            yield self._slice(off, min(limit, n - off))

    def _slice(self, off: int, cnt: int) -> ColumnarBatch:
        cap = bucket_rows(cnt)
        cols = []
        for c in self.table.columns:
            def part(t):
                out = torch.zeros((cap,) + tuple(t.shape[1:]),
                                  dtype=t.dtype, device=t.device)
                out[:cnt] = t[off:off + cnt]
                return out
            cols.append(Column(part(c.data), part(c.valid), c.dtype,
                               part(c.lengths) if c.dtype.is_string
                               else None))
        sel = torch.arange(cap, device=self.table.device) < cnt
        return ColumnarBatch(cols, sel, self.table.schema)


class TpuProjectExec(ExecNode):
    def __init__(self, exprs: Sequence[E.Expression], names: Sequence[str],
                 child: ExecNode):
        super().__init__(child)
        self.exprs = list(exprs)
        self._schema = Schema([StructField(n, e.dtype)
                               for n, e in zip(names, exprs)])

    @property
    def schema(self):
        return self._schema

    def execute(self, ctx):
        yield from map_batches(
            self.children[0].execute(ctx),
            lambda batch: ColumnarBatch([e.eval(batch) for e in self.exprs],
                                        batch.sel, self._schema))


class TpuFilterExec(ExecNode):
    def __init__(self, condition: E.Expression, child: ExecNode):
        super().__init__(child)
        self.condition = condition

    @property
    def schema(self):
        return self.children[0].schema

    def execute(self, ctx):
        yield from map_batches(
            self.children[0].execute(ctx),
            lambda batch: batch.filter(_pred_keep(self.condition.eval(batch))))


class TpuLocalLimitExec(ExecNode):
    """The first n live rows of the stream: each batch compacted (live
    rows to the front, in order), then cut by its selection mask."""

    def __init__(self, n: int, child: ExecNode):
        super().__init__(child)
        self.n = n

    @property
    def schema(self):
        return self.children[0].schema

    def execute(self, ctx):
        packed = ctx.conf.get(SORT_PACKED_ENABLED)
        remaining = self.n
        for batch in self.children[0].execute(ctx):
            if remaining <= 0:
                return
            batch = batch.compact(packed)
            count = batch.num_rows_host()
            if count > remaining:
                batch = batch.with_sel(
                    torch.arange(batch.capacity, device=batch.device)
                    < remaining)
                count = remaining
            remaining -= count
            yield batch


class TpuGlobalLimitExec(TpuLocalLimitExec):
    """The same cut on the single merged stream."""


class TpuCoalesceBatchesExec(ExecNode):
    """The child's batches concatenated, live rows in order, to a goal:
    "single" yields one batch of every row (the planner puts one under an
    aggregate that dedups a distinct child, whose update must see every
    row at once); "target" concatenates batches while their bytes stay
    within `spark.rapids.sql.batchSizeBytes` (under a window)."""

    def __init__(self, child: ExecNode, goal: str = "single"):
        super().__init__(child)
        self.goal = goal

    @property
    def schema(self):
        return self.children[0].schema

    def execute(self, ctx):
        packed = ctx.conf.get(SORT_PACKED_ENABLED)
        target = ctx.conf.get(BATCH_SIZE_BYTES)
        pending: List[ColumnarBatch] = []
        pending_bytes = 0
        for batch in self.children[0].execute(ctx):
            size = batch.device_size_bytes()
            if self.goal != "single" and pending \
                    and pending_bytes + size > target:
                yield self._flush(pending, packed)
                pending, pending_bytes = [], 0
            pending.append(batch)
            pending_bytes += size
            del batch
        if pending:
            yield self._flush(pending, packed)

    @staticmethod
    def _flush(pending: List[ColumnarBatch], packed: bool) -> ColumnarBatch:
        # the list is emptied here, so that no frame holds a batch once
        # its concatenation is yielded
        out = (pending[0].compact(packed) if len(pending) == 1
               else concat_batches(pending, packed))
        pending.clear()
        return out


class TpuUnionExec(ExecNode):
    """Each child's batches in turn (the planner checks that the children
    agree in arity and types; the first names the columns)."""

    def __init__(self, children: Sequence[ExecNode]):
        super().__init__(*children)

    @property
    def schema(self):
        return self.children[0].schema

    def execute(self, ctx):
        for child in self.children:
            yield from map_batches(child.execute(ctx), lambda b: ColumnarBatch(
                b.columns, b.sel, self.schema))


class TpuExpandExec(ExecNode):
    """Projection-list fan-out (ROLLUP/CUBE): one batch per projection of
    each input batch, in projection order, so the live rows come in the
    order of the JAX package's exec, which concatenates the projections
    into one batch of n times the capacity (a static shape the TPU
    needs; eager torch would only pay n times the peak memory for it).
    The string columns of every projection are padded to the widest
    across the projections, so all the batches share one layout."""

    def __init__(self, projections: List[List[E.Expression]],
                 names: Sequence[str], child: ExecNode):
        super().__init__(child)
        self.projections = projections
        self._schema = Schema([StructField(n, e.dtype)
                               for n, e in zip(names, projections[0])])

    @property
    def schema(self):
        return self._schema

    def execute(self, ctx):
        strings = [i for i, f in enumerate(self._schema) if f.dtype.is_string]
        for batch in self.children[0].execute(ctx):
            # a width evaluates the column and drops it: a reference
            # costs nothing, a null key copy one small allocation
            width = {i: max(p[i].eval(batch).max_len
                            for p in self.projections) for i in strings}
            for proj in self.projections:
                cols = [e.eval(batch) for e in proj]
                for i in strings:
                    cols[i] = cols[i].pad_strings_to(width[i])
                out = [ColumnarBatch(cols, batch.sel, self._schema)]
                del cols
                yield out.pop()


class DeviceToHostExec(ExecNode):
    """The device-to-host edge: live rows of every batch, copied to the
    host as Python rows or numpy columns."""

    def __init__(self, child: ExecNode):
        super().__init__(child)

    @property
    def schema(self):
        return self.children[0].schema

    def execute_host(self, ctx: ExecContext, rows: bool
                     ) -> Iterator[Union[List[tuple], Dict[str, np.ndarray]]]:
        yield from map_batches(
            self.children[0].execute(ctx),
            lambda batch: batch.to_pylist() if rows else batch.to_pydict())
