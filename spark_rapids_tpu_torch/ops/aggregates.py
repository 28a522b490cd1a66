"""Declarative aggregate functions (port of spark_rapids_tpu/ops/aggregates).

Each aggregate is an (update, merge, finalize) triple run by the
aggregate exec (exec/aggregate.py); this module only declares semantics.
The slice supports Sum, Min, Max, Count and Average.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..types import DataType, DoubleType, LongType
from .expressions import Expression

AGG_FUNCS = ("Sum", "Min", "Max", "Count", "Average")


@dataclasses.dataclass
class AggregateExpression(Expression):
    """A resolved aggregate call in an agg list."""

    func: str                    # Sum|Min|Max|Count|Average
    child: Optional[Expression]  # None for count(*)
    output_name: str = ""

    def __post_init__(self):
        self.children = (self.child,) if self.child is not None else ()

    @property
    def dtype(self) -> DataType:
        if self.func == "Count":
            return LongType
        if self.func == "Average":
            return DoubleType
        if self.func == "Sum":
            return LongType if self.child.dtype.is_integral else DoubleType
        return self.child.dtype

    def eval(self, batch):
        raise RuntimeError("AggregateExpression is evaluated by the "
                           "aggregate exec, not columnar eval")

    def __repr__(self):
        inner = repr(self.child) if self.child is not None else "*"
        return f"{self.func}({inner})"
