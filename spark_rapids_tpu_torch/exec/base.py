"""Physical operator base classes (port of spark_rapids_tpu/exec/base.py).

An exec is a node of the physical plan; `execute(ctx)` yields device
batches.  The port runs operators eagerly, one PyTorch call after
another; there is no compiled-stage cache, metrics registry or memory
runtime yet.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, TypeVar

import torch

from ..columnar import ColumnarBatch
from ..config import TpuConf
from ..types import Schema

T = TypeVar("T")


class ExecContext:
    """What one execution of a plan shares: the session conf and the
    device every batch lives on."""

    def __init__(self, conf: Optional[TpuConf], device: torch.device):
        self.conf = conf if conf is not None else TpuConf()
        self.device = device


class ExecNode:
    def __init__(self, *children: "ExecNode"):
        self.children = list(children)

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        raise NotImplementedError


def map_batches(batches: Iterator[ColumnarBatch],
                fn: Callable[[ColumnarBatch], T]) -> Iterator[T]:
    """`fn` over each batch of a stream, holding neither the input batch
    nor its output while the consumer runs or the stream makes its next
    batch: a chain of streaming execs then keeps two generations of
    batches alive, not three."""
    for batch in batches:
        out = [fn(batch)]
        del batch
        yield out.pop()
