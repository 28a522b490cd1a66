"""Broadcast exchange and broadcast hash join (port of
spark_rapids_tpu/exec/broadcast.py).

On one card the broadcast value is the build side as one device batch.
The exchange passes its child's batches through; the join it feeds
(TpuHashJoinExec._build_batch) merges them into that one batch, builds
it once and probes every stream batch against it.  The classes stay
apart from the plain hash join so that plans name the same execs as the
JAX package's.  The JAX package's host form and its registration as a
spillable buffer wait for the device memory runtime (ROADMAP Queue 1
item 5); CpuBroadcastExchangeExec is not ported.
"""
from __future__ import annotations

from typing import Iterator

from ..columnar import ColumnarBatch
from .base import ExecContext, ExecNode
from .join import TpuHashJoinExec


class TpuBroadcastExchangeExec(ExecNode):
    """The build side of a broadcast join: its child's batches, which the
    join merges into one device batch."""

    @property
    def schema(self):
        return self.children[0].schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        return self.children[0].execute(ctx)


class TpuBroadcastHashJoinExec(TpuHashJoinExec):
    """Hash join whose build side is a broadcast exchange; the probe is
    TpuHashJoinExec's, only the build side's source differs."""
