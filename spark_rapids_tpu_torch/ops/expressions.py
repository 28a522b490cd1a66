"""Bound expression trees evaluated a whole column at a time.

The subset of spark_rapids_tpu/ops/expressions.py that TPC-H q1, q6 and
the q18 lineitem aggregate use, with Spark's null semantics: a result is
null when an input is null, except for Kleene And/Or.  Comparisons follow
Spark's float order: -0.0 == 0.0, NaN == NaN, NaN greater than all.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..columnar import Column, ColumnarBatch, bucket_strlen
from ..types import (BooleanType, DataType, DoubleType, IntegerType,
                     LongType, NullType, StringType, promote)


class Expression:
    """Bound expression node; eval(batch) -> Column of batch.capacity rows."""

    children: Sequence["Expression"] = ()

    @property
    def dtype(self) -> DataType:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def eval(self, batch: ColumnarBatch) -> Column:
        raise NotImplementedError

    def __repr__(self):
        inner = ", ".join(repr(c) for c in self.children)
        return f"{self.name}({inner})"


def _all_valid(*cols: Column) -> torch.Tensor:
    v = cols[0].valid
    for c in cols[1:]:
        v = v & c.valid
    return v


class BoundReference(Expression):
    """A resolved column index."""

    def __init__(self, index: int, dtype: DataType, column_name: str = ""):
        self.index = index
        self._dtype = dtype
        self.column_name = column_name

    @property
    def dtype(self):
        return self._dtype

    def eval(self, batch):
        return batch.columns[self.index]

    def __repr__(self):
        return f"input[{self.index} {self.column_name}:{self._dtype.name}]"


class Literal(Expression):
    def __init__(self, value: Any, dtype: Optional[DataType] = None):
        self.value = value
        self._dtype = dtype if dtype is not None else infer_literal_type(value)

    @property
    def dtype(self):
        return self._dtype

    def eval(self, batch):
        cap, dev = batch.capacity, batch.device
        if self.value is None:
            return Column.all_null(
                self._dtype if self._dtype is not NullType else LongType,
                cap, dev)
        if self._dtype.is_string:
            # one row of bytes on the device, broadcast to every row (no
            # host array of the batch's capacity); read-only, like every
            # column
            raw = self.value.encode("utf-8")
            row = torch.zeros(bucket_strlen(len(raw)), dtype=torch.uint8)
            row[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
            return Column(row.to(dev).expand(cap, row.numel()),
                          torch.ones(cap, dtype=torch.bool, device=dev),
                          StringType,
                          torch.full((cap,), len(raw), dtype=torch.int32,
                                     device=dev))
        data = torch.full((cap,), self.value, dtype=self._dtype.torch_dtype,
                          device=dev)
        return Column(data, torch.ones(cap, dtype=torch.bool, device=dev),
                      self._dtype)

    def __repr__(self):
        return f"lit({self.value!r})"


def infer_literal_type(v) -> DataType:
    if v is None:
        return NullType
    if isinstance(v, bool):
        return BooleanType
    if isinstance(v, (int, np.integer)):
        return IntegerType if -2**31 <= int(v) < 2**31 else LongType
    if isinstance(v, (float, np.floating)):
        return DoubleType
    if isinstance(v, str):
        return StringType
    raise TypeError(f"cannot infer literal type of {v!r}")


# --------------------------------------------------------------------------
# binary ops with promotion and null propagation
# --------------------------------------------------------------------------

class BinaryExpression(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right
        self.children = (left, right)

    @property
    def promoted_type(self) -> DataType:
        return promote(self.left.dtype, self.right.dtype)

    @property
    def dtype(self):
        return self.promoted_type

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        t = self.promoted_type.torch_dtype
        data = self.do_op(l.data.to(t), r.data.to(t))
        return Column(data, _all_valid(l, r), self.dtype).mask_invalid()

    def do_op(self, l, r):
        raise NotImplementedError


class Add(BinaryExpression):
    def do_op(self, l, r):
        return l + r


class Subtract(BinaryExpression):
    def do_op(self, l, r):
        return l - r


class Multiply(BinaryExpression):
    def do_op(self, l, r):
        return l * r


def _cmp_prep(l, r):
    if l.is_floating_point():
        l, r = l + 0.0, r + 0.0  # -0.0 -> 0.0
    return l, r


def _string_pair(l: Column, r: Column):
    ml = max(l.max_len, r.max_len)
    return l.pad_strings_to(ml), r.pad_strings_to(ml)


def string_eq(l: Column, r: Column):
    a, b = _string_pair(l, r)
    return torch.all(a.data == b.data, dim=1) & (a.lengths == b.lengths)


def string_lt(l: Column, r: Column):
    """Lexicographic byte order (zero padding sorts prefixes first)."""
    a, b = _string_pair(l, r)
    neq = a.data != b.data
    has_diff = torch.any(neq, dim=1)
    idx = torch.argmax(neq.to(torch.uint8), dim=1)[:, None]
    av = torch.gather(a.data, 1, idx)[:, 0]
    bv = torch.gather(b.data, 1, idx)[:, 0]
    return torch.where(has_diff, av < bv, a.lengths < b.lengths)


class _Comparison(BinaryExpression):
    @property
    def dtype(self):
        return BooleanType

    @property
    def promoted_type(self):
        lt, rt = self.left.dtype, self.right.dtype
        if lt is rt or (lt.is_string and rt.is_string):
            return lt
        return promote(lt, rt)

    def eval(self, batch):
        if not (self.left.dtype.is_string and self.right.dtype.is_string):
            l = self.left.eval(batch)
            r = self.right.eval(batch)
            t = self.promoted_type.torch_dtype
            out = self.compare(*_cmp_prep(l.data.to(t), r.data.to(t)))
            return Column(out, _all_valid(l, r), BooleanType).mask_invalid()
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        out = self.compare_strings(l, r)
        return Column(out, _all_valid(l, r), BooleanType)

    def compare(self, l, r):
        raise NotImplementedError

    def compare_strings(self, l: Column, r: Column):
        raise NotImplementedError


def _lt(l, r):
    if l.is_floating_point():
        # NaN is greatest: l < r iff (r is NaN and l is not) or l < r
        return torch.where(torch.isnan(l), False,
                           torch.where(torch.isnan(r), True, l < r))
    return l < r


class EqualTo(_Comparison):
    def compare(self, l, r):
        eq = l == r
        if l.is_floating_point():
            eq = eq | (torch.isnan(l) & torch.isnan(r))
        return eq

    def compare_strings(self, l, r):
        return string_eq(l, r)


class LessThan(_Comparison):
    def compare(self, l, r):
        return _lt(l, r)

    def compare_strings(self, l, r):
        return string_lt(l, r)


class GreaterThan(_Comparison):
    def compare(self, l, r):
        return _lt(r, l)

    def compare_strings(self, l, r):
        return string_lt(r, l)


class LessThanOrEqual(_Comparison):
    def compare(self, l, r):
        return ~_lt(r, l)

    def compare_strings(self, l, r):
        return ~string_lt(r, l)


class GreaterThanOrEqual(_Comparison):
    def compare(self, l, r):
        return ~_lt(l, r)

    def compare_strings(self, l, r):
        return ~string_lt(l, r)


# --------------------------------------------------------------------------
# Kleene boolean logic
# --------------------------------------------------------------------------

class And(Expression):
    def __init__(self, left, right):
        self.left, self.right = left, right
        self.children = (left, right)

    @property
    def dtype(self):
        return BooleanType

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        data = (l.valid & l.data) & (r.valid & r.data)
        # null unless one side is definitely false
        false_l = l.valid & ~l.data
        false_r = r.valid & ~r.data
        valid = (l.valid & r.valid) | false_l | false_r
        return Column(data, valid, BooleanType)


class Or(Expression):
    def __init__(self, left, right):
        self.left, self.right = left, right
        self.children = (left, right)

    @property
    def dtype(self):
        return BooleanType

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        true_l = l.valid & l.data
        true_r = r.valid & r.data
        valid = (l.valid & r.valid) | true_l | true_r
        return Column(true_l | true_r, valid, BooleanType)


class Not(Expression):
    def __init__(self, child):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return BooleanType

    def eval(self, batch):
        c = self.child.eval(batch)
        return Column(~c.data, c.valid, BooleanType)


EXPRESSIONS = {c.__name__: c for c in (Add, Subtract, Multiply, EqualTo,
                                       LessThan, GreaterThan,
                                       LessThanOrEqual, GreaterThanOrEqual,
                                       And, Or, Not)}
COMPARISONS = ("EqualTo", "LessThan", "GreaterThan", "LessThanOrEqual",
               "GreaterThanOrEqual")
ARITHMETIC = ("Add", "Subtract", "Multiply")
