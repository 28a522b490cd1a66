"""Cast between numeric types (the numeric -> numeric part of
spark_rapids_tpu/ops/cast.py).

The planner materialises it to widen a join key whose two sides differ
in type (int32 against int64 hashes differently).  Any other cast raises
NotImplementedError when it is made, so a plan that needs one fails at
planning time.
"""
from __future__ import annotations

import torch

from ..columnar import Column
from ..types import DataType
from .expressions import Expression

_INT_RANGE = {
    "byte": (-128, 127),
    "short": (-(2 ** 15), 2 ** 15 - 1),
    "int": (-(2 ** 31), 2 ** 31 - 1),
    "long": (-(2 ** 63), 2 ** 63 - 1),
}


class Cast(Expression):
    def __init__(self, child: Expression, to: DataType):
        if child.dtype is not to and not (child.dtype.is_numeric
                                          and to.is_numeric):
            raise NotImplementedError(
                f"cast {child.dtype.name} -> {to.name} is not ported; only "
                "numeric -> numeric casts are")
        self.child = child
        self.to = to
        self.children = (child,)

    @property
    def dtype(self):
        return self.to

    def __repr__(self):
        return f"cast({self.child!r} as {self.to.name})"

    def eval(self, batch):
        c = self.child.eval(batch)
        src, dst = self.child.dtype, self.to
        if src is dst:
            return c
        x = c.data
        if dst.is_floating or not src.is_floating:
            # widening, or integral -> integral with a Java-style wrap
            return Column(x.to(dst.torch_dtype), c.valid, dst)
        # float -> integral: truncate, NaN -> 0, saturate at the range
        lo, hi = _INT_RANGE[dst.name]
        xf = torch.trunc(torch.nan_to_num(x.to(torch.float64), nan=0.0))
        out = xf.clamp(float(lo), float(hi)).to(torch.int64)
        out = torch.where(xf >= float(hi), hi, out)
        out = torch.where(xf <= float(lo), lo, out)
        return Column(out.to(dst.torch_dtype), c.valid, dst)
