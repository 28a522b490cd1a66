"""Bound expression trees evaluated a whole column at a time.

The subset of spark_rapids_tpu/ops/expressions.py that the port's TPC-H
queries use: the arithmetic family (Divide, IntegralDivide, Remainder and
Pmod add a null where the divisor is zero), the comparisons and Kleene
logic, the null and NaN family and the conditionals, with Spark's null
semantics: a result is null when an input is null, except for Kleene
And/Or, the null predicates, the conditionals and Coalesce.
Comparisons follow Spark's float order: -0.0 == 0.0, NaN == NaN, NaN
greater than all.

Each class computes what its JAX namesake computes, down to the value it
leaves in a null slot (NaNvl, Coalesce and If read those), so one
expression tree gives the same rows in both packages.  Where the JAX
package raises when it evaluates a tree (a type it has no device layout
for, an In item that numpy cannot cast to the column's type), the port
raises when the tree is built, at planning time.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..columnar import Column, ColumnarBatch, bucket_strlen
from ..types import (BooleanType, DataType, DoubleType, IntegerType,
                     LongType, NullType, StringType, promote)


def _ones(cap: int, dev) -> torch.Tensor:
    return torch.ones(cap, dtype=torch.bool, device=dev)


def _string_row(raw: bytes, width: int, dev) -> torch.Tensor:
    """One string's UTF-8 bytes as a zero-padded row of `width` bytes on
    the device (the caller has checked that it fits)."""
    row = torch.zeros(width, dtype=torch.uint8)
    row[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    return row.to(dev)


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
            row = _string_row(raw, bucket_strlen(len(raw)), dev)
            return Column(row.expand(cap, row.numel()), _ones(cap, dev),
                          StringType,
                          torch.full((cap,), len(raw), dtype=torch.int32,
                                     device=dev))
        data = torch.full((cap,), self.value, dtype=self._dtype.torch_dtype,
                          device=dev)
        return Column(data, _ones(cap, dev), self._dtype)

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
    """A binary op over both sides promoted to one type, null where
    either side is.  With `promote_children` false (the shifts) neither
    side is promoted and the result has the left side's type."""

    promote_children = True

    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right
        self.children = (left, right)

    @property
    def promoted_type(self) -> DataType:
        return promote(self.left.dtype, self.right.dtype)

    @property
    def dtype(self):
        if self.promote_children:
            return self.promoted_type
        return self.left.dtype

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        ld, rd = l.data, r.data
        if self.promote_children:
            t = self.promoted_type.torch_dtype
            ld, rd = ld.to(t), rd.to(t)
        data, valid = self.do_op(ld, rd, _all_valid(l, r))
        return Column(data, valid, self.dtype).mask_invalid()

    def do_op(self, l, r, valid):
        """(data, valid) of the op over both sides' data (in the promoted
        type when `promote_children`) and the rows where both sides are
        valid."""
        raise NotImplementedError


class _Unary(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return self.child.dtype


# --------------------------------------------------------------------------
# arithmetic
# --------------------------------------------------------------------------

class Add(BinaryExpression):
    def do_op(self, l, r, valid):
        return l + r, valid


class Subtract(BinaryExpression):
    def do_op(self, l, r, valid):
        return l - r, valid


class Multiply(BinaryExpression):
    def do_op(self, l, r, valid):
        return l * r, valid


def to_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x as integer type `dtype`, a float converted as the JAX package
    converts it: truncated, saturating at the type's range, NaN to 0 (a
    plain torch cast wraps or gives the minimum there on the CPU and is
    undefined on the card).  An integer or boolean x converts as torch
    converts it, wrapping as jnp's astype does."""
    if not x.is_floating_point():
        return x.to(dtype)
    info = torch.iinfo(dtype)
    big = x >= float(info.max) + 1.0  # a power of two, exact
    small = x < float(info.min)
    out = torch.where(big | small | torch.isnan(x), 0.0, x).to(dtype)
    out = torch.where(big, info.max, out)
    return torch.where(small, info.min, out)


def _to_long(x: torch.Tensor) -> torch.Tensor:
    return to_int(x, torch.int64)


def _trunc_div(l, r):
    """The JVM's truncating integer division, as the JAX package writes
    it (the sign times the floor of the magnitudes, which wraps as it
    does at the type's minimum).  `r` holds no zero."""
    return torch.sign(l) * torch.sign(r) * torch.div(
        torch.abs(l), torch.abs(r), rounding_mode="floor")


def _trunc_mod(l, r):
    """JVM %: the result has the dividend's sign."""
    return l - r * _trunc_div(l, r)


class Divide(BinaryExpression):
    """Spark's `/`: always a double, null where the divisor is 0 or -0.0.
    The divisor is made safe before dividing."""

    @property
    def dtype(self):
        return DoubleType

    def do_op(self, l, r, valid):
        l, r = l.to(torch.float64), r.to(torch.float64)
        nz = r != 0.0
        return torch.where(nz, l, 1.0) / torch.where(nz, r, 1.0), valid & nz


class IntegralDivide(BinaryExpression):
    """Spark's `div`: a long, truncated toward zero, null where the
    divisor is 0."""

    @property
    def dtype(self):
        return LongType

    def do_op(self, l, r, valid):
        l, r = _to_long(l), _to_long(r)
        nz = r != 0
        return _trunc_div(l, torch.where(nz, r, 1)), valid & nz


class Remainder(BinaryExpression):
    """Spark's `%`: fmod for floats, the JVM's truncating remainder for
    integers; null where the divisor is 0."""

    def do_op(self, l, r, valid):
        nz = r != 0
        safe = torch.where(nz, r, 1)
        if l.is_floating_point():
            return torch.fmod(l, safe), valid & nz
        return _trunc_mod(l, safe), valid & nz


class Pmod(BinaryExpression):
    """Spark's pmod: the remainder moved into the divisor's range when it
    is negative; null where the divisor is 0."""

    def do_op(self, l, r, valid):
        nz = r != 0
        safe = torch.where(nz, r, 1)
        mod = torch.fmod if l.is_floating_point() else _trunc_mod
        m = mod(l, safe)
        return torch.where(m < 0, mod(m + safe, safe), m), valid & nz


class _ArithUnary(_Unary):
    """A unary op on the data; the child's validity, and its null slots
    go through the op (-0.0 for a float UnaryMinus), as in the JAX
    package."""

    def __init__(self, child: Expression):
        if child.dtype.is_string:
            # the JAX package has no string layout for the result
            raise TypeError(f"{type(self).__name__} of a string column")
        super().__init__(child)

    def eval(self, batch):
        c = self.child.eval(batch)
        return Column(self.do_op(c.data), c.valid, self.dtype)

    def do_op(self, x):
        raise NotImplementedError


class UnaryMinus(_ArithUnary):
    def do_op(self, x):
        return -x


class UnaryPositive(_ArithUnary):
    def do_op(self, x):
        return x


class Abs(_ArithUnary):
    """abs, which leaves an integer type's minimum as it is."""

    def do_op(self, x):
        return torch.abs(x)


# --------------------------------------------------------------------------
# bitwise
# --------------------------------------------------------------------------

def _integral_side(op: str, dt: DataType, floating: bool = False) -> None:
    """Raise for a side jnp's bitwise ops reject when the JAX package
    evaluates them (a float, except as a shift count; a string, whose
    byte matrix does not broadcast against a column), here, when the
    tree is built."""
    if dt.is_string or (dt.is_floating and not floating):
        raise NotImplementedError(f"{op} of a {dt.name} column: the JAX "
                                  "package cannot evaluate it")


class _Bitwise(BinaryExpression):
    """And, Or and Xor of both sides promoted to one integral type (a
    boolean pair stays boolean, as in jnp)."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__(left, right)
        if left.dtype is not NullType and right.dtype is not NullType:
            _integral_side(type(self).__name__, self.promoted_type)


class BitwiseAnd(_Bitwise):
    def do_op(self, l, r, valid):
        return l & r, valid


class BitwiseOr(_Bitwise):
    def do_op(self, l, r, valid):
        return l | r, valid


class BitwiseXor(_Bitwise):
    def do_op(self, l, r, valid):
        return l ^ r, valid


class BitwiseNot(_Unary):
    """~x in the child's type (a boolean's logical not, as in jnp); the
    child's validity, and its null slots go through the op."""

    def __init__(self, child: Expression):
        _integral_side("BitwiseNot", child.dtype)
        super().__init__(child)

    def eval(self, batch):
        c = self.child.eval(batch)
        return Column(~c.data, c.valid, self.dtype)


class _Shift(BinaryExpression):
    """A shift of the left side by the right side's count, in the left
    side's type: the count is taken modulo that type's width in bits (a
    floor modulo), so a byte shifts within 8 bits and a short within 16.
    A boolean left side shifts as a byte, as jnp shifts it, and comes
    out as a boolean: true where the shifted value is not zero (jnp
    leaves the int64 value under the boolean type, which is what its
    collect reads)."""

    promote_children = False

    def __init__(self, left: Expression, right: Expression):
        super().__init__(left, right)
        _integral_side(type(self).__name__, left.dtype)
        _integral_side(type(self).__name__, right.dtype, floating=True)

    def do_op(self, l, r, valid):
        if l.dtype == torch.bool:
            return self.shift(l.to(torch.int64), r, 8, torch.bool) != 0, \
                valid
        return self.shift(l, r, l.element_size() * 8, l.dtype), valid

    def shift(self, l, r, bits: int, left_type: torch.dtype):
        """l shifted by count r, both tensors; `bits` is the width of
        the left side's type `left_type`."""
        raise NotImplementedError


def _count(r: torch.Tensor, dtype: torch.dtype, bits: int) -> torch.Tensor:
    """The count of ShiftLeft and ShiftRight: r converted to the left
    side's type (a long count wraps to an int; a float one truncates,
    saturating, NaN to 0; a boolean left side's type is boolean), then
    modulo `bits`."""
    if dtype == torch.bool:
        return r.to(torch.bool).to(torch.int64)  # 0 or 1, below 8
    return torch.remainder(to_int(r, dtype), bits)


class ShiftLeft(_Shift):
    def shift(self, l, r, bits, left_type):
        return l << _count(r, left_type, bits)


class ShiftRight(_Shift):
    def shift(self, l, r, bits, left_type):
        return l >> _count(r, left_type, bits)


_M32 = (1 << 32) - 1


class ShiftRightUnsigned(_Shift):
    """A logical shift right: the left side read as an unsigned 32-bit
    word (a byte, short or int sign-extended first) or a 64-bit one, the
    count taken modulo the left type's width in the count's own type,
    the result wrapped back into the left side's type.  Carried in
    int64: a masked arithmetic shift."""

    def shift(self, l, r, bits, left_type):
        if r.dtype == torch.bool:
            r = r.to(torch.int64)
        # the count modulo the width in its own type, then converted (a
        # float count truncated, NaN to 0)
        s = to_int(torch.remainder(r, bits), torch.int64)
        if bits < 64:
            return ((l.to(torch.int64) & _M32) >> s).to(l.dtype)
        # 64 bits: the arithmetic shift's sign fill masked off; a count
        # of 0 keeps every bit, and 1 << 64 does not fit
        nz = torch.where(s == 0, 1, s)
        mask = (1 << (64 - nz)) - 1
        return torch.where(s == 0, l, (l >> nz) & mask)


def _cmp_prep(l, r):
    if l.is_floating_point():
        l, r = l + 0.0, r + 0.0  # -0.0 -> 0.0
    return l, r


def _string_pair(l: Column, r: Column):
    ml = max(l.max_len, r.max_len)
    return l.pad_strings_to(ml), r.pad_strings_to(ml)


def _word_view(c: Column, width: int) -> torch.Tensor:
    """A string column's bytes zero-padded to `width` (a multiple of 8) as
    int64 words, [capacity, width / 8]; a literal's one broadcast row
    stays one row."""
    data = c.pad_strings_to(width).data
    if data.stride(-1) != 1 or data.stride(0) % 8 \
            or data.storage_offset() % 8:
        data = data.contiguous()
    return data.view(torch.int64)


def string_eq(l: Column, r: Column):
    """Equal lengths and equal bytes, one elementwise compare per 8-byte
    word rather than a reduction over bytes."""
    width = -(-max(l.max_len, r.max_len) // 8) * 8
    a, b = _word_view(l, width), _word_view(r, width)
    eq = l.lengths == r.lengths
    for k in range(a.shape[1]):
        eq = eq & (a[:, k] == b[:, k])
    return eq


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


def _eq(l, r):
    eq = l == r
    if l.is_floating_point():
        eq = eq | (torch.isnan(l) & torch.isnan(r))
    return eq


class EqualTo(_Comparison):
    def compare(self, l, r):
        return _eq(l, r)

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


class EqualNullSafe(_Comparison):
    """<=> : true when both sides are null or both equal; never null."""

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        if self.left.dtype.is_string:
            eq = string_eq(l, r)
        else:
            t = self.promoted_type.torch_dtype
            eq = _eq(*_cmp_prep(l.data.to(t), r.data.to(t)))
        out = (l.valid & r.valid & eq) | (~l.valid & ~r.valid)
        return Column(out, torch.ones_like(out), BooleanType)


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


class Not(_Unary):
    @property
    def dtype(self):
        return BooleanType

    def eval(self, batch):
        c = self.child.eval(batch)
        return Column(~c.data, c.valid, BooleanType)


# --------------------------------------------------------------------------
# null and NaN handling
# --------------------------------------------------------------------------

class _Predicate(_Unary):
    """A never-null boolean of one child."""

    @property
    def dtype(self):
        return BooleanType

    def eval(self, batch):
        out = self.test(self.child.eval(batch))
        return Column(out, _ones(batch.capacity, batch.device), BooleanType)

    def test(self, c: Column) -> torch.Tensor:
        raise NotImplementedError


class IsNull(_Predicate):
    def test(self, c):
        return ~c.valid


class IsNotNull(_Predicate):
    def test(self, c):
        return c.valid


class IsNaN(_Predicate):
    def __init__(self, child: Expression):
        if child.dtype.is_string:
            # the JAX package fails to broadcast the byte matrix
            raise TypeError("IsNaN of a string column")
        super().__init__(child)

    def test(self, c):
        return c.valid & torch.isnan(c.data)


def _common_type(dtypes) -> DataType:
    """Least common type of conditional branches: NullType skipped, the
    rest promoted."""
    out = None
    for dt in dtypes:
        if dt is NullType:
            continue
        out = dt if out is None or out is dt else promote(out, dt)
    return out if out is not None else NullType


def _check_branches(dt: DataType, branches) -> None:
    """Raise for a result type the JAX package cannot evaluate: null
    (no device layout), or string with a branch that is not a string
    (its null literal is a long column, which cannot be padded)."""
    if dt is NullType:
        raise TypeError("null has no single-buffer device dtype")
    if dt.is_string and any(not b.dtype.is_string for b in branches):
        raise TypeError("a string result with a null-literal branch: the "
                        "literal is a long column, not a string one")


class Coalesce(Expression):
    def __init__(self, *children: Expression):
        self.children = tuple(children)
        _check_branches(self.dtype, self.children)

    @property
    def dtype(self):
        return _common_type(c.dtype for c in self.children)

    def eval(self, batch):
        dt = self.dtype
        cols = [c.eval(batch) for c in self.children]
        if not dt.is_string:
            cols = [Column(c.data.to(dt.torch_dtype), c.valid, dt)
                    for c in cols]
        out = cols[0]
        for nxt in cols[1:]:
            if dt.is_string:
                o, n = _string_pair(out, nxt)
                out = Column(torch.where(o.valid[:, None], o.data, n.data),
                             o.valid | n.valid, dt,
                             torch.where(o.valid, o.lengths, n.lengths))
            else:
                out = Column(torch.where(out.valid, out.data, nxt.data),
                             out.valid | nxt.valid, dt)
        return out


class NaNvl(BinaryExpression):
    """The left value unless it is NaN, else the right one.  It reads
    isnan of the left data on every row, null rows too.

    The JAX package computes in the left side's type and declares the
    promoted one (a float left with a double right gives a double column
    of float-rounded values); the port computes the same values and
    widens them to the declared type."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__(left, right)
        if self.dtype.is_string:
            raise TypeError("NaNvl of string columns")

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        use_r = torch.isnan(l.data)
        data = torch.where(use_r, r.data.to(l.data.dtype), l.data)
        valid = torch.where(use_r, r.valid, l.valid)
        return Column(data.to(self.dtype.torch_dtype), valid,
                      self.dtype).mask_invalid()


class AtLeastNNonNulls(Expression):
    """True where at least n children are non-null, a float child
    counting only when it is also not NaN (df.na.drop's predicate)."""

    def __init__(self, n: int, children: Sequence[Expression]):
        self.n = int(n)
        self.children = tuple(children)

    @property
    def dtype(self):
        return BooleanType

    def eval(self, batch):
        cap, dev = batch.capacity, batch.device
        count = torch.zeros(cap, dtype=torch.int32, device=dev)
        for ch in self.children:
            c = ch.eval(batch)
            ok = c.valid
            if c.dtype.is_floating:
                ok = ok & ~torch.isnan(c.data)
            count = count + ok.to(torch.int32)
        return Column(count >= self.n, _ones(cap, dev), BooleanType)

    def __repr__(self):
        return f"AtLeastNNonNulls({self.n}, {list(self.children)!r})"


class NormalizeNaNAndZero(_Unary):
    """Floats made canonical for grouping and join keys: every NaN
    becomes one NaN and -0.0 becomes 0.0.  Other types pass through."""

    def eval(self, batch):
        c = self.child.eval(batch)
        if not c.dtype.is_floating:
            return c
        x = c.data
        nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        data = torch.where(torch.isnan(x), nan,
                           torch.where(x == 0, zero, x))
        return Column(data, c.valid, c.dtype)


class KnownFloatingPointNormalized(_Unary):
    """A marker that its child is already normalized: a passthrough."""

    def eval(self, batch):
        return self.child.eval(batch)


# --------------------------------------------------------------------------
# conditionals
# --------------------------------------------------------------------------

class If(Expression):
    """`then` where the predicate is true, else `other`; a null
    predicate counts as false, and the validity is the taken branch's."""

    def __init__(self, pred: Expression, then: Expression,
                 other: Expression):
        if pred.dtype.is_string:
            raise TypeError("a string predicate")
        self.pred, self.then, self.other = pred, then, other
        self.children = (pred, then, other)
        _check_branches(self.dtype, (then, other))

    @property
    def dtype(self):
        return _common_type((self.then.dtype, self.other.dtype))

    def eval(self, batch):
        p = self.pred.eval(batch)
        t = self.then.eval(batch)
        o = self.other.eval(batch)
        # the JAX package's logical_and: any non-zero predicate is true
        cond = p.valid & p.data.to(torch.bool)
        valid = torch.where(cond, t.valid, o.valid)
        dt = self.dtype
        if dt.is_string:
            t, o = _string_pair(t, o)
            return Column(torch.where(cond[:, None], t.data, o.data), valid,
                          dt, torch.where(cond, t.lengths, o.lengths))
        tt = dt.torch_dtype
        return Column(torch.where(cond, t.data.to(tt), o.data.to(tt)),
                      valid, dt)


class CaseWhen(Expression):
    """branches [(pred, value), ...] and an optional else value, run as
    nested Ifs from the last branch, so the first true branch wins; with
    no else value the result is a null of the common type."""

    def __init__(self, branches, else_value: Optional[Expression] = None):
        self.branches = list(branches)
        self.else_value = else_value
        ch: List[Expression] = []
        for p, v in self.branches:
            ch += [p, v]
        if else_value is not None:
            ch.append(else_value)
        self.children = tuple(ch)
        expr = else_value if else_value is not None \
            else Literal(None, self.dtype)
        for p, v in reversed(self.branches):
            expr = If(p, v, expr)
        self._tree = expr

    @property
    def dtype(self):
        dts = [v.dtype for _, v in self.branches]
        if self.else_value is not None:
            dts.append(self.else_value.dtype)
        return _common_type(dts)

    def eval(self, batch):
        return self._tree.eval(batch)


class In(Expression):
    """value IN (items): null where the value is null, and where no item
    matched and the list holds a None.  A string item matches by bytes
    and length.  Numeric items are first cast to the column's numpy type
    (as the JAX package does: an int column matches 1.5 as 1); NaN
    matches nothing."""

    def __init__(self, value: Expression, items: Sequence[Any]):
        self.value = value
        self.items = list(items)
        self.children = (value,)
        non_null = [i for i in self.items if i is not None]
        self.has_null_item = len(non_null) != len(self.items)
        if value.dtype.is_string:
            bad = [i for i in non_null if not isinstance(i, str)]
            if bad:
                raise TypeError(f"In over a string column with non-string "
                                f"items {bad!r}")
            self._strings = non_null
        else:
            # the cast the JAX package makes when it evaluates, made here
            # so that an item numpy cannot cast raises at planning time
            vt = LongType if value.dtype is NullType else value.dtype
            self._numbers = np.array(non_null, dtype=vt.np_dtype)

    @property
    def dtype(self):
        return BooleanType

    def eval(self, batch):
        v = self.value.eval(batch)
        dev = batch.device
        hit = torch.zeros(batch.capacity, dtype=torch.bool, device=dev)
        if v.dtype.is_string:
            # each item a literal: one row on the device, broadcast to
            # every row
            for item in self._strings:
                if len(item.encode("utf-8")) > v.max_len:
                    continue  # longer than every value
                hit = hit | string_eq(v, Literal(item, StringType).eval(batch))
        elif len(self._numbers):
            items = torch.from_numpy(self._numbers).to(dev)
            hit = torch.any(v.data[:, None] == items[None, :], dim=1)
        valid = v.valid & hit if self.has_null_item else v.valid
        return Column(hit, valid, BooleanType)

    def __repr__(self):
        return f"In({self.value!r}, {self.items!r})"


InSet = In


class _ExtremeN(Expression):
    """least/greatest(e1, ..., en): nulls skipped (null only where every
    argument is), NaN greater than any number."""

    def __init__(self, *children: Expression):
        if len(children) < 2:
            raise TypeError(f"{type(self).__name__} needs at least two "
                            "arguments")
        self.children = tuple(children)
        dt = self.dtype
        if dt is NullType or dt.is_string:
            raise TypeError(f"{dt.name} has no single-buffer device dtype")

    @property
    def dtype(self):
        return _common_type(c.dtype for c in self.children)

    def eval(self, batch):
        dt = self.dtype
        t = dt.torch_dtype
        cols = [c.eval(batch) for c in self.children]
        acc_v, acc_m = cols[0].data.to(t), cols[0].valid
        for c in cols[1:]:
            v, m = c.data.to(t), c.valid
            take = m & (~acc_m | self._better(v, acc_v))
            acc_v = torch.where(take, v, acc_v)
            acc_m = acc_m | m
        return Column(acc_v, acc_m, dt).mask_invalid()

    @staticmethod
    def _key(x):
        """(comparison key, NaN mask or None): NaN sorts greatest."""
        if x.is_floating_point():
            nan = torch.isnan(x)
            return torch.where(nan, float("inf"), x), nan
        return x, None

    def _better(self, v, acc):
        raise NotImplementedError


class Least(_ExtremeN):
    def _better(self, v, acc):
        vk, vn = self._key(v)
        ak, an = self._key(acc)
        lt = vk < ak
        return lt if vn is None else lt | (~vn & an)


class Greatest(_ExtremeN):
    def _better(self, v, acc):
        vk, vn = self._key(v)
        ak, an = self._key(acc)
        gt = vk > ak
        return gt if vn is None else gt | (vn & ~an)


# the ops `resolve` builds from their resolved arguments alone (In,
# CaseWhen, AtLeastNNonNulls, Least and Greatest take their own branches).
# UnaryPositive is left out, as the JAX package's resolve leaves it out
EXPRESSIONS = {c.__name__: c for c in (
    Add, Subtract, Multiply, Divide, IntegralDivide, Remainder, Pmod,
    UnaryMinus, Abs, EqualTo, LessThan, GreaterThan,
    LessThanOrEqual, GreaterThanOrEqual, EqualNullSafe, And, Or, Not,
    IsNull, IsNotNull, IsNaN, Coalesce, NaNvl, NormalizeNaNAndZero,
    KnownFloatingPointNormalized, BitwiseAnd, BitwiseOr, BitwiseXor,
    BitwiseNot, ShiftLeft, ShiftRight, ShiftRightUnsigned)}
COMPARISONS = ("EqualTo", "LessThan", "GreaterThan", "LessThanOrEqual",
               "GreaterThanOrEqual", "EqualNullSafe")
ARITHMETIC = ("Add", "Subtract", "Multiply", "Divide", "IntegralDivide",
              "Remainder", "Pmod")
