"""Declarative aggregate functions (port of spark_rapids_tpu/ops/aggregates).

Each aggregate is an (update, merge, finalize) triple run by the
aggregate exec (exec/aggregate.py); this module only declares semantics.
Sum, Min, Max, Count, Average, First and Last run on the device, each in
its distinct form too (distinct First and Last excepted).  Percentile
resolves, and the planner refuses it (plan/physical.py): the JAX package
runs it on its CPU executor, which the port does not have.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..types import DataType, DoubleType, LongType
from .expressions import Expression

AGG_FUNCS = ("Sum", "Min", "Max", "Count", "Average", "First", "Last",
             "Percentile")


@dataclasses.dataclass
class AggregateExpression(Expression):
    """A resolved aggregate call in an agg list."""

    func: str                    # one of AGG_FUNCS
    child: Optional[Expression]  # None for count(*)
    distinct: bool = False
    output_name: str = ""
    # Percentile's p in [0, 1]
    param: Optional[float] = None

    def __post_init__(self):
        self.children = (self.child,) if self.child is not None else ()

    @property
    def dtype(self) -> DataType:
        if self.func == "Count":
            return LongType
        if self.func in ("Average", "Percentile"):
            return DoubleType
        if self.func == "Sum":
            return LongType if self.child.dtype.is_integral else DoubleType
        return self.child.dtype

    def eval(self, batch):
        raise RuntimeError("AggregateExpression is evaluated by the "
                           "aggregate exec, not columnar eval")

    def __repr__(self):
        inner = repr(self.child) if self.child is not None else "*"
        d = "DISTINCT " if self.distinct else ""
        return f"{self.func}({d}{inner})"
