"""Window exec (port of TpuWindowExec, spark_rapids_tpu/exec/window.py).

Its child is a TpuCoalesceBatchesExec with the "target" goal.  The exec
concatenates what arrives into one batch, sorts it once by (partition
keys ascending with nulls first, then the order keys) through
exec/sort's permutation (K3 on the card), evaluates every function on
the sorted rows (ops/windows.py) and puts each result column back in
input order through the inverse permutation.  Only the columns the keys
and the functions read are gathered into sorted order; the batch's own
columns pass through as they are, with its `sel`, so dead rows stay dead
(they sort last, into segments of their own).

Over `spark.rapids.sql.batchSizeBytes`, with more than one batch and
partition keys, the JAX exec hash-exchanges the batches by the
partition keys and runs each exchange partition alone; the port has no
exchange, so it concatenates them all, the "single" behaviour: the rows
are the same multiset, in another order.  CpuWindowExec, the JAX
package's CPU executor, is not ported.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..columnar import ColumnarBatch, concat_batches
from ..config import SORT_PACKED_ENABLED
from ..ops import expressions as E
from ..ops.windows import Segments, WindowFunc, eval_window_func
from ..types import Schema, StructField
from .base import ExecContext, ExecNode
from .sort import order_of_columns


class TpuWindowExec(ExecNode):
    """The window functions of one (partition, order) spec group: every
    child column, then one column per function."""

    child_coalesce_goal = "target"

    def __init__(self, part_exprs: Sequence[E.Expression],
                 order_exprs: Sequence[E.Expression],
                 ascending: Sequence[bool], nulls_first: Sequence[bool],
                 funcs: Sequence[WindowFunc], child: ExecNode):
        super().__init__(child)
        self.part_exprs = list(part_exprs)
        self.order_exprs = list(order_exprs)
        self.ascending = list(ascending)
        self.nulls_first = list(nulls_first)
        self.funcs = list(funcs)
        self._schema = Schema(list(child.schema.fields)
                              + [StructField(f.name, f.dtype)
                                 for f in self.funcs])

    @property
    def schema(self):
        return self._schema

    def _window(self, batch: ColumnarBatch, packed: bool) -> ColumnarBatch:
        cap = batch.capacity
        part = [e.eval(batch) for e in self.part_exprs]
        order = [e.eval(batch) for e in self.order_exprs]
        if part or order:
            perm = order_of_columns(
                batch.sel, part + order,
                [True] * len(part) + self.ascending,
                [True] * len(part) + self.nulls_first, packed).long()
        else:
            perm = torch.arange(cap, device=batch.device)
        seg = Segments(batch.sel[perm], [c.take(perm) for c in part],
                       [c.take(perm) for c in order])
        del part, order
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(cap, device=batch.device)
        # a child read by several functions is gathered once, and its
        # prefix sums are shared through `seg`
        children = {}
        out = list(batch.columns)
        for f in self.funcs:
            c = key = None
            if f.child is not None:
                key = repr(f.child)
                if key not in children:
                    children[key] = f.child.eval(batch).take(perm)
                c = children[key]
            out.append(eval_window_func(f, c, seg, key).take(inv))
        return ColumnarBatch(out, batch.sel, self._schema)

    def execute(self, ctx: ExecContext):
        packed = ctx.conf.get(SORT_PACKED_ENABLED)
        batches = list(self.children[0].execute(ctx))
        if not batches:
            return
        batch = [batches[0] if len(batches) == 1
                 else concat_batches(batches, packed)]
        del batches
        out = [self._window(batch.pop(), packed)]
        yield out.pop()
