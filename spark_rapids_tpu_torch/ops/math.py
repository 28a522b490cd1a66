"""Spark's math expressions (port of spark_rapids_tpu/ops/math.py).

The functions take and return doubles (a child of another type is read
as float64 first); the logs are null where their argument is at or
below their lower bound, as Spark's nullSafeEval makes them.  Floor and
Ceil pass an integral child through and convert a floating one to a
long, saturating as the JAX package converts (NaN to 0); Round (HALF_UP)
and BRound (HALF_EVEN) keep their child's type.

Each class computes what its JAX namesake computes.  Sqrt, Floor, Ceil,
Rint, Round, BRound, Signum, ToDegrees and ToRadians are exact (IEEE
operations in the same order), so both packages give the same bits.  The
transcendental functions come from torch's libraries (the CPU's or
CUDA's), which part from XLA's by a few ulp, and Cbrt, which torch
lacks, is written here.  Where XLA overflows or flushes differently
from IEEE, the port keeps IEEE's answer: a subnormal input or result is
kept (XLA's CPU backend reads and writes zero), and cosh and sinh stay
finite up to the largest double they reach.  Where the JAX package
cannot evaluate a tree (a string child; a round scale that is not an
integer literal, which it sends to its CPU executor), the port raises
NotImplementedError when the tree is built.
"""
from __future__ import annotations

import math

import torch

from ..columnar import Column
from ..types import DoubleType, LongType
from .datetime_utils import true_div
from .expressions import (BinaryExpression, Expression, Literal, _Unary,
                          to_int)


def _numeric_child(name: str, child: Expression) -> None:
    if child.dtype.is_string:
        raise NotImplementedError(f"{name} of a string column: the JAX "
                                  "package has no layout for its result")


class _DoubleUnary(_Unary):
    """f(child as float64), a double; the child's validity, and its null
    slots go through f."""

    def __init__(self, child: Expression):
        _numeric_child(type(self).__name__, child)
        super().__init__(child)

    @property
    def dtype(self):
        return DoubleType

    def eval(self, batch):
        c = self.child.eval(batch)
        return Column(self.do_op(c.data.to(torch.float64)), c.valid,
                      DoubleType)

    def do_op(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitter for a double


def _square(y: torch.Tensor):
    """(p, e) with p + e = y * y exactly (Dekker's product: no FMA)."""
    c = y * _SPLIT
    hi = c - (c - y)
    lo = y - hi
    p = y * y
    return p, ((hi * hi - p) + 2.0 * hi * lo) + lo * lo


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, t) with s + t = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE's correctly rounded square root of float64 `x`, on any
    device.  torch.sqrt is that on the card but can be an ulp off on
    the CPU (sqrt(2.0) gives 1.414213562373095).  A Newton step over the
    exact residual x - y^2 brings it within a hair of the root; then the
    sign of x - m^2 at the midpoint m to each neighbour, summed exactly
    from Dekker's y^2 (every term a whole multiple of the ulp squared,
    and x never on a midpoint), decides whether it moves one ulp.  x is
    first scaled by an even power of two into a range where no term
    overflows or underflows, which moves no rounding."""
    big, small = x > 2.0 ** 900, x < 2.0 ** -900
    xs = torch.where(big, x * 2.0 ** -1000,
                     torch.where(small, x * 2.0 ** 1000, x))
    y = torch.sqrt(xs)
    p, e = _square(y)
    y = y + ((xs - p) - e) / (2.0 * y)
    p, e = _square(y)
    a = xs - p  # exact: p is within a factor 2 of xs
    up = torch.nextafter(y, torch.full_like(y, math.inf)) - y
    down = y - torch.nextafter(y, torch.zeros_like(y))

    def sign(c):  # of a - e + c, exactly
        s1, t1 = _two_sum(a, c)
        s2, t2 = _two_sum(s1, -e)
        return s2 + (t1 + t2)
    y = torch.where(sign(-y * up) > 0, y + up,
                    torch.where(sign(y * down) <= 0, y - down, y))
    y = torch.where(big, y * 2.0 ** 500, torch.where(small, y * 2.0 ** -500,
                                                      y))
    return torch.where((x > 0) & torch.isfinite(x), y, torch.sqrt(x))


class Sqrt(_DoubleUnary):
    def do_op(self, x):
        return sqrt(x)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root of float64 `x`, odd in x (-0.0 stays -0.0):
    exp(log|x| / 3), then two Newton steps in the form that neither
    overflows nor underflows (y - (y - |x| / y^2) / 3), and a root that
    is an integer whose cube is |x| exactly taken as that integer, so a
    perfect cube's root is exact."""
    a = torch.abs(x)
    fin = torch.isfinite(a) & (a != 0)
    s = torch.where(fin, a, 1.0)
    y = torch.exp(true_div(torch.log(s), 3.0))
    for _ in range(2):
        y = y - true_div(y - s / (y * y), 3.0)
    r = torch.round(y)
    y = torch.where(r * r * r == s, r, y)
    return torch.copysign(torch.where(fin, y, a), x)


class Cbrt(_DoubleUnary):
    def do_op(self, x):
        return cbrt(x)


class Exp(_DoubleUnary):
    def do_op(self, x):
        return torch.exp(x)


class Expm1(_DoubleUnary):
    def do_op(self, x):
        return torch.expm1(x)


class _LogBase(_DoubleUnary):
    """Null where x <= the lower bound (Spark's nullSafeEval); f runs on
    1.0 there."""

    lower = 0.0

    def eval(self, batch):
        c = self.child.eval(batch)
        x = c.data.to(torch.float64)
        ok = x > self.lower
        return Column(self.do_op(torch.where(ok, x, 1.0)), c.valid & ok,
                      DoubleType)


class Log(_LogBase):
    def do_op(self, x):
        return torch.log(x)


class Log2(_LogBase):
    def do_op(self, x):
        return torch.log2(x)


class Log10(_LogBase):
    def do_op(self, x):
        return torch.log10(x)


class Log1p(_LogBase):
    lower = -1.0

    def do_op(self, x):
        return torch.log1p(x)


class Sin(_DoubleUnary):
    def do_op(self, x):
        return torch.sin(x)


class Cos(_DoubleUnary):
    def do_op(self, x):
        return torch.cos(x)


class Tan(_DoubleUnary):
    def do_op(self, x):
        return torch.tan(x)


class Asin(_DoubleUnary):
    def do_op(self, x):
        return torch.asin(x)


class Acos(_DoubleUnary):
    def do_op(self, x):
        return torch.acos(x)


class Atan(_DoubleUnary):
    def do_op(self, x):
        return torch.atan(x)


# past it exp(|x|) overflows while cosh(x) and sinh(x) do not until
# ~710.48; there both are exp(|x| / 2) * exp(|x| / 2) / 2 to the last
# few ulp (e^-|x| is far below one ulp)
_EXP_HALVED = 700.0


def _half_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(|x|) / 2 without overflowing where it is finite."""
    h = torch.exp(torch.abs(x) * 0.5)
    return (h * 0.5) * h


class Sinh(_DoubleUnary):
    def do_op(self, x):
        big = torch.abs(x) > _EXP_HALVED
        return torch.where(big, torch.copysign(_half_exp(x), x),
                           torch.sinh(x))


class Cosh(_DoubleUnary):
    def do_op(self, x):
        return torch.where(torch.abs(x) > _EXP_HALVED, _half_exp(x),
                           torch.cosh(x))


class Tanh(_DoubleUnary):
    def do_op(self, x):
        return torch.tanh(x)


class Asinh(_DoubleUnary):
    def do_op(self, x):
        return torch.asinh(x)


class Acosh(_DoubleUnary):
    """NaN below 1, as StrictMath.log(x + sqrt(x*x - 1))."""

    def do_op(self, x):
        return torch.acosh(x)


class Atanh(_DoubleUnary):
    def do_op(self, x):
        return torch.atanh(x)


class ToDegrees(_DoubleUnary):
    def do_op(self, x):
        return x * (180.0 / math.pi)  # jnp.degrees' one product


class ToRadians(_DoubleUnary):
    def do_op(self, x):
        return x * (math.pi / 180.0)


class Signum(_DoubleUnary):
    """-1.0, 1.0, or x itself for +-0.0 and NaN (jnp.sign keeps both;
    torch.sign gives +0.0 for each)."""

    def do_op(self, x):
        return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


class _Rounding(_Unary):
    """Floor and Ceil: an integral (or any other non-floating) child
    passes through unchanged; a floating one becomes a long, saturating
    at the long range with NaN as 0, as the JAX package converts."""

    @property
    def dtype(self):
        return LongType if self.child.dtype.is_floating else self.child.dtype

    def eval(self, batch):
        c = self.child.eval(batch)
        if not self.child.dtype.is_floating:
            return c
        return Column(to_int(self.f(c.data), torch.int64), c.valid,
                      LongType)


class Floor(_Rounding):
    f = staticmethod(torch.floor)


class Ceil(_Rounding):
    f = staticmethod(torch.ceil)


class Rint(_DoubleUnary):
    def do_op(self, x):
        return torch.round(x)  # half to even, as Math.rint


class _DoubleBinary(BinaryExpression):
    """f(left, right), both promoted to one type and then read as
    float64; a double."""

    def __init__(self, left: Expression, right: Expression):
        _numeric_child(type(self).__name__, left)
        _numeric_child(type(self).__name__, right)
        super().__init__(left, right)

    @property
    def dtype(self):
        return DoubleType

    def do_op(self, l, r, valid):
        return self.f(l.to(torch.float64), r.to(torch.float64)), valid


class Pow(_DoubleBinary):
    f = staticmethod(torch.pow)


class Atan2(_DoubleBinary):
    f = staticmethod(torch.atan2)


def hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(a^2 + b^2) as jnp.hypot writes it: m * sqrt(1 + (n / m)^2)
    over the larger and smaller magnitude, infinite where either is
    (NaN or not), so it neither overflows nor underflows early (torch's
    hypot on the card squares first: hypot(1.8e308, 2.2e-308) is inf)."""
    a, b = torch.abs(a), torch.abs(b)
    inf = torch.isposinf(a) | torch.isposinf(b)
    m, n = torch.maximum(a, b), torch.minimum(a, b)
    q = n / torch.where(m == 0, 1.0, m)
    out = torch.where(m == 0, m, m * sqrt(1.0 + q * q))
    return torch.where(inf, math.inf, out)


class Hypot(_DoubleBinary):
    f = staticmethod(hypot)


class Cot(_DoubleUnary):
    def do_op(self, x):
        return 1.0 / torch.tan(x)


class Logarithm(_DoubleBinary):
    """log(base, x): null where x <= 0 or base <= 0 (Spark's
    nullSafeEval)."""

    def do_op(self, base, x, valid):
        b, v = base.to(torch.float64), x.to(torch.float64)
        ok = (v > 0.0) & (b > 0.0)
        out = torch.log(torch.where(v > 0, v, 1.0)) \
            / torch.log(torch.where(b > 0, b, 2.0))
        return out, valid & ok


class _RoundBase(Expression):
    """round/bround(child, scale) at an integer literal scale: HALF_UP
    (Round) or HALF_EVEN (BRound) at decimal `scale`, in the child's
    type.  An integral child at scale >= 0 is unchanged; at a negative
    scale it is rounded by floor division, in its own type, and is zero
    once 10^-scale exceeds the type's maximum (every digit rounded away,
    as Spark's BigDecimal).  Any other child is rounded in float64 and
    converted back to its type (a float stays a float; an infinity or
    NaN is returned as it was)."""

    half_even = False

    def __init__(self, child: Expression, scale: Expression = None):
        self.child = child
        self.scale = scale if scale is not None else Literal(0)
        self.children = (child, self.scale)
        name = type(self).__name__
        _numeric_child(name, child)
        if not (isinstance(self.scale, Literal)
                and isinstance(self.scale.value, int)):
            raise NotImplementedError(
                f"{name} with a scale that is not an integer literal: the "
                "JAX package runs it on its CPU executor")
        self.s = int(self.scale.value)
        if not child.dtype.is_integral and self.s > 308:
            # the JAX package's 10.0 ** s overflows when it evaluates
            raise NotImplementedError(f"{name} of a non-integral column at "
                                      f"scale {self.s} > 308")

    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, batch):
        c = self.child.eval(batch)
        s = self.s
        if c.dtype.is_integral:
            if s >= 0:
                return c
            if 10 ** (-s) > torch.iinfo(c.data.dtype).max:
                return Column(torch.zeros_like(c.data), c.valid, c.dtype)
            p = 10 ** (-s)
            half = p // 2
            x = c.data
            q = torch.div(x, p, rounding_mode="floor")
            rem = x - q * p
            if self.half_even:
                up = (rem > half) | ((rem == half) & (q % 2 != 0))
            else:  # HALF_UP on the absolute value
                up = torch.where(x >= 0, rem >= half, rem > half)
            return Column((q + up.to(x.dtype)) * p, c.valid, c.dtype)
        x = c.data.to(torch.float64)
        p = 10.0 ** s
        scaled = x * p
        if self.half_even:
            r = torch.round(scaled)
        else:
            r = torch.trunc(scaled + torch.where(scaled >= 0, 0.5, -0.5))
        # r / p as IEEE divides (true_div: not through 1 / p on the card)
        out = torch.where(torch.isfinite(x), true_div(r, p), x)
        t = c.dtype.torch_dtype
        if not (t.is_floating_point or t == torch.bool):
            out = to_int(out, t)
        return Column(out.to(t), c.valid, c.dtype)

    def __repr__(self):
        return f"{type(self).__name__}({self.child!r}, {self.s})"


class Round(_RoundBase):
    half_even = False


class BRound(_RoundBase):
    half_even = True


# the classes `resolve` builds from their resolved arguments alone
MATH_EXPRESSIONS = {c.__name__: c for c in (
    Sqrt, Cbrt, Exp, Expm1, Log, Log2, Log10, Log1p, Sin, Cos, Tan, Asin,
    Acos, Atan, Sinh, Cosh, Tanh, Asinh, Acosh, Atanh, ToDegrees, ToRadians,
    Signum, Floor, Ceil, Rint, Pow, Atan2, Round, BRound, Hypot, Cot,
    Logarithm)}
