"""Cast (port of spark_rapids_tpu/ops/cast.py): a (source, target) ->
function table, with the JAX package's semantics on each route.  The
port has every route of the JAX package's table:
  * numeric -> numeric: integral narrowing wraps (Java), float ->
    integral truncates and saturates, NaN -> 0;
  * numeric -> boolean (`!= 0`: NaN is true, -0.0 false) and boolean
    -> numeric;
  * date <-> timestamp; timestamp -> long (seconds, floored) and long,
    int, short and byte -> timestamp; timestamp -> double or float
    (seconds) and double or float -> timestamp; boolean -> timestamp
    (false 0, true 1 microsecond); int and short -> date and date -> int
    and long (the days, reinterpreted);
  * string -> byte, short, int and long (a sign and 1-19 digits), float
    and double (`[+-]digits[.digits][eE[+-]digits]`, nan, inf and
    infinity), boolean (true t yes y 1 / false f no n 0, any case), date
    (`yyyy-M-d`) and timestamp (`yyyy-M-d` or `yyyy-M-d HH?mm?ss`, the
    separators of the time unchecked), parsed a byte position at a time
    after trimming the bytes <= 0x20 at either end, an unparsable row
    null;
  * byte, short, int and long -> string (decimal; 8, 8, 16 and 32-byte
    rows), boolean -> string (`true`, `false`; 8-byte rows), date ->
    string (`yyyy-MM-dd`, the year clipped to 0-9999, 16-byte rows) and
    timestamp -> string (`yyyy-MM-dd HH:mm:ss`, 32-byte rows).  The JAX
    package writes integers and timestamps into 24-byte rows, with the
    same bytes up to each row's length.  A null row keeps the text of
    its zeroed data, as in the JAX package.
The number parses keep the JAX package's arithmetic where it parts from
Spark's: the digits sum in int64 and wrap past 2^63, and a double's scale
is a table of 10.0 ** k clipped at 10^308.  Subnormal values are IEEE's,
as in the port's arithmetic, where XLA's CPU backend flushes them to
zero.  A cast of a
string literal is folded when it is made: the route runs once on the
CPU over the literal's bytes (`fold_string`), and the Cast evaluates as
a literal of the result.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import torch

from ..columnar import Column, bucket_strlen
from ..types import (BooleanType, ByteType, DataType, DateType, DoubleType,
                     FloatType, IntegerType, LongType, ShortType, StringType,
                     TimestampType)
from . import datetime_utils as dtu
from .expressions import Expression, Literal

_INT_TYPES = (ByteType, ShortType, IntegerType, LongType)
_NUMERIC = _INT_TYPES + (FloatType, DoubleType)
_INT_RANGE = {
    "byte": (-128, 127),
    "short": (-(2 ** 15), 2 ** 15 - 1),
    "int": (-(2 ** 31), 2 ** 31 - 1),
    "long": (-(2 ** 63), 2 ** 63 - 1),
}
_I32, _I64 = torch.int32, torch.int64


class Cast(Expression):
    def __init__(self, child: Expression, to: DataType):
        src = child.dtype
        if not supported_cast(src, to):
            raise NotImplementedError(
                f"cast {src.name} -> {to.name} is not a route of the JAX "
                "package")
        self.child = child
        self.to = to
        self.children = (child,)
        # a string literal's cast, folded once on the CPU
        self._folded = None
        if isinstance(child, Literal) and src is StringType \
                and to is not StringType:
            self._folded = Literal(None if child.value is None
                                   else fold_string(child.value, to), to)

    @property
    def dtype(self):
        return self.to

    def __repr__(self):
        return f"cast({self.child!r} as {self.to.name})"

    def eval(self, batch):
        if self._folded is not None:
            return self._folded.eval(batch)
        return cast_column(self.child.eval(batch), self.to)


def cast_column(c: Column, to: DataType) -> Column:
    """Column `c` cast to `to`."""
    return c if c.dtype is to else _ROUTES[(c.dtype.name, to.name)](c, to)


def supported_cast(src: DataType, dst: DataType) -> bool:
    """Whether the JAX package has this cast."""
    return src is dst or (src.name, dst.name) in _ROUTES


@functools.lru_cache(maxsize=256)
def fold_string(value: str, to: DataType):
    """What the string -> `to` cast gives the string `value`, as a Python
    value (None: null): the route itself, run on the CPU over a one-row
    column of the UTF-8 bytes, so that a literal and a column cannot
    disagree."""
    raw = value.encode("utf-8")
    data = torch.zeros((1, max(len(raw), 1)), dtype=torch.uint8)
    data[0, :len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    out = cast_column(Column(data, torch.ones(1, dtype=torch.bool),
                             StringType,
                             torch.tensor([len(raw)], dtype=_I32)), to)
    return out.data[0].item() if bool(out.valid[0]) else None


# --------------------------------------------------------------------------
# numeric <-> numeric
# --------------------------------------------------------------------------

def _num_to_num(c: Column, dst: DataType) -> Column:
    x = c.data
    if dst.is_floating or not c.dtype.is_floating:
        # widening, or integral -> integral with a Java-style wrap
        return Column(x.to(dst.torch_dtype), c.valid, dst)
    # float -> integral: truncate, NaN -> 0, saturate at the range
    lo, hi = _INT_RANGE[dst.name]
    xf = torch.trunc(torch.nan_to_num(x.to(torch.float64), nan=0.0))
    out = xf.clamp(float(lo), float(hi)).to(_I64)
    out = torch.where(xf >= float(hi), hi, out)
    out = torch.where(xf <= float(lo), lo, out)
    return Column(out.to(dst.torch_dtype), c.valid, dst)


def _num_to_bool(c: Column, dst: DataType) -> Column:
    """`!= 0`: NaN is true and -0.0 false, as in the JAX package."""
    return Column(c.data != 0, c.valid, dst)


# --------------------------------------------------------------------------
# date / timestamp
# --------------------------------------------------------------------------

def _date_to_timestamp(c: Column, dst: DataType) -> Column:
    return Column(c.data.to(_I64) * dtu.MICROS_PER_DAY, c.valid, dst)


def _timestamp_to_date(c: Column, dst: DataType) -> Column:
    return Column(dtu.micros_to_days(c.data), c.valid, dst)


def _timestamp_to_long(c: Column, dst: DataType) -> Column:
    return Column(c.data // dtu.MICROS_PER_SECOND, c.valid, dst)


def _long_to_timestamp(c: Column, dst: DataType) -> Column:
    return Column(c.data.to(_I64) * dtu.MICROS_PER_SECOND, c.valid, dst)


def _timestamp_to_double(c: Column, dst: DataType) -> Column:
    # the JAX package leaves float64 data under FloatType; the port keeps
    # a float column as float32, the same seconds rounded
    secs = dtu.true_div(c.data.to(torch.float64), dtu.MICROS_PER_SECOND)
    return Column(secs.to(dst.torch_dtype), c.valid, dst)


def _double_to_timestamp(c: Column, dst: DataType) -> Column:
    micros = c.data.to(torch.float64) * dtu.MICROS_PER_SECOND
    return Column(dtu.as_long(micros), c.valid, dst)


def _bool_to_timestamp(c: Column, dst: DataType) -> Column:
    return Column(c.data.to(_I64), c.valid, dst)


def _reinterpret(c: Column, dst: DataType) -> Column:
    return Column(c.data.to(dst.torch_dtype), c.valid, dst)


# --------------------------------------------------------------------------
# string -> number, boolean, date and timestamp: one pass over the rows
# per byte position, so no matrix wider than the text's bytes is made
# --------------------------------------------------------------------------

_SPACE, _PLUS, _DASH, _DOT, _ZERO = 0x20, 0x2B, 0x2D, 0x2E, 0x30


def _byte_columns(c: Column) -> Tuple[torch.Tensor, ...]:
    """The string column's bytes by position: `max_len` contiguous uint8
    tensors of [capacity] (the byte matrix transposed once)."""
    return c.data.t().contiguous().unbind(0)


def _is_digit(b: torch.Tensor) -> torch.Tensor:
    return (b - _ZERO) < 10  # uint8: a byte below '0' wraps above 9


def _trim(cols, lens: torch.Tensor):
    """[start, end) of each row's first `lens` bytes less the bytes <=
    0x20 at either end (the JAX package's _trim_ws, Spark's UTF8String
    trim); all blank gives start > end.  Positions are int16 where the
    rows are narrower than 2^15 bytes, to halve the bytes each pass moves
    against int32."""
    n = len(cols)
    lens = lens.to(torch.int16 if n < 2 ** 15 else _I32)
    start = torch.full_like(lens, n)
    end = torch.zeros_like(lens)
    for p, b in enumerate(cols):
        keep = (b > _SPACE) & (p < lens)
        start.masked_fill_(keep & (start == n), p)
        end.masked_fill_(keep, p + 1)
    return start, end


def _byte_at(data: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """Each row's byte at position `at` (clamped into the row)."""
    idx = at.clamp(0, data.shape[1] - 1).to(_I64)[:, None]
    return data.gather(1, idx)[:, 0]


def _digit_at(data: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """Each row's byte at position `at` (clamped into the row) less '0',
    int32."""
    return _byte_at(data, at).to(_I32) - _ZERO


def _lower(b: torch.Tensor) -> torch.Tensor:
    """ASCII A-Z lowered, every other byte kept."""
    return torch.where((b >= 0x41) & (b <= 0x5A), b + 0x20, b)


def _is_sign(b: torch.Tensor) -> torch.Tensor:
    return (b == _PLUS) | (b == _DASH)


def _is_word(data: torch.Tensor, start: torch.Tensor, n: torch.Tensor,
             words) -> torch.Tensor:
    """Whether each row's `n` bytes from `start`, A-Z lowered, are one
    of `words` (lower-case bytes)."""
    low = [_lower(_byte_at(data, start + j))
           for j in range(max(map(len, words)))]
    hit = torch.zeros(n.shape, dtype=torch.bool, device=n.device)
    for w in words:
        m = n == len(w)
        for j, ch in enumerate(w):
            m &= low[j] == ch
        hit |= m
    return hit


def _parse_integral(c: Column, dst: DataType) -> Column:
    """After the trim, an optional sign and then 1-19 ASCII digits (the
    JAX package's _parse_integral).  The value is a Horner sum in int64
    that wraps past 2^63, as the JAX package's does, and the type's range
    is checked after the wrap, so no long is out of range."""
    cols = _byte_columns(c)
    s, e = _trim(cols, c.lengths)
    acc = torch.zeros(c.capacity, dtype=_I64, device=c.device)
    ndig = torch.zeros_like(s)
    bad = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    neg = torch.zeros_like(bad)
    for p, b in enumerate(cols):
        inr = (p >= s) & (p < e)
        dig = _is_digit(b) & inr
        sign = _is_sign(b) & (p == s)
        bad |= inr & ~dig & ~sign
        neg |= sign & (b == _DASH)
        acc = torch.where(dig, acc * 10 + (b - _ZERO), acc)
        ndig += dig.to(ndig.dtype)
    val = torch.where(neg, -acc, acc)
    lo, hi = _INT_RANGE[dst.name]
    ok = ~bad & (ndig >= 1) & (ndig <= 19) & (val >= lo) & (val <= hi)
    return Column(val.to(dst.torch_dtype), c.valid & ok, dst).mask_invalid()


# 10.0 ** k by Python's pow, as the JAX package's table holds them
_POW10 = [10.0 ** k for k in range(309)]


def _parse_float(c: Column, dst: DataType) -> Column:
    """After the trim, `[+-]digits[.digits][eE[+-]digits]` with at least
    one digit before the e and one after it, or nan, inf or infinity in
    any case with an optional sign (the JAX package's _parse_float).  The
    value is the mantissa's digits as a wrapping int64 Horner sum, times
    10^max(e, 0) over 10^max(-e, 0) from the table of 10.0 ** k, e being
    the exponent less the digits after the dot clipped to [-340, 340] (past
    10^308 the table stops and e > 308 gives inf, 0 for a zero mantissa),
    negated after a leading '-'; a float rounds the double last."""
    cols = _byte_columns(c)
    s, e = _trim(cols, c.lengths)
    dev = c.device
    mant = torch.zeros(c.capacity, dtype=_I64, device=dev)
    expv = torch.zeros_like(mant)
    # digits of the mantissa, of them after the dot, of the exponent;
    # dots before the e, e's
    n_mant, n_frac, n_exp, n_dot, n_e = (torch.zeros_like(s)
                                         for _ in range(5))
    e_at = torch.full_like(s, -2)  # the first e's position
    seen_e = torch.zeros(s.shape, dtype=torch.bool, device=dev)
    seen_dot, bad, neg, exp_neg = (torch.zeros_like(seen_e)
                                   for _ in range(4))
    for p, b in enumerate(cols):
        inr = (p >= s) & (p < e)
        dig = _is_digit(b) & inr
        is_e = ((b | 0x20) == ord("e")) & inr
        sign = _is_sign(b) & inr
        first_sign = sign & (p == s)
        exp_sign = sign & (e_at == p - 1)
        before_e = inr & ~seen_e & ~is_e
        mdig, edig = dig & before_e, dig & seen_e
        dot = (b == _DOT) & before_e
        bad |= inr & ~(dig | dot | is_e | first_sign | exp_sign)
        neg |= first_sign & (b == _DASH)
        exp_neg |= exp_sign & (b == _DASH)
        d = b - _ZERO
        mant = torch.where(mdig, mant * 10 + d, mant)
        expv = torch.where(edig, expv * 10 + d, expv)
        n_mant += mdig.to(s.dtype)
        n_frac += (mdig & seen_dot).to(s.dtype)
        n_exp += edig.to(s.dtype)
        n_dot += dot.to(s.dtype)
        n_e += is_e.to(s.dtype)
        e_at.masked_fill_(is_e & ~seen_e, p)
        seen_e |= is_e
        seen_dot |= dot
    ex = (torch.where(exp_neg, -expv, expv) - n_frac).clamp(-340, 340)
    pow10 = torch.tensor(_POW10, dtype=torch.float64, device=dev)
    val = mant.to(torch.float64) * pow10[ex.clamp(0, 308)] \
        / pow10[(-ex).clamp(0, 308)]
    val = torch.where(ex > 308, torch.where(mant == 0, 0.0, math.inf), val)
    val = torch.where(neg, -val, val)
    ok = (~bad & (e > s) & (n_mant > 0) & (n_dot <= 1) & (n_e <= 1)
          & ((n_e == 0) | (n_exp > 0)))
    # the words, after an optional sign
    lead = _is_sign(_byte_at(c.data, s)).to(s.dtype)
    at, word_len = s + lead, e - s - lead
    is_nan = _is_word(c.data, at, word_len, (b"nan",))
    is_inf = _is_word(c.data, at, word_len, (b"inf", b"infinity"))
    val = torch.where(is_nan, math.nan, torch.where(
        is_inf, torch.where(neg, -math.inf, math.inf), val))
    ok |= is_nan | is_inf
    return Column(val.to(dst.torch_dtype), c.valid & ok, dst).mask_invalid()


_TRUE_WORDS = (b"true", b"t", b"yes", b"y", b"1")
_FALSE_WORDS = (b"false", b"f", b"no", b"n", b"0")


def _parse_bool(c: Column, dst: DataType) -> Column:
    """After the trim, the whole text one of _TRUE_WORDS or _FALSE_WORDS
    with A-Z lowered (the JAX package's _parse_bool), else null."""
    s, e = _trim(_byte_columns(c), c.lengths)
    t = _is_word(c.data, s, e - s, _TRUE_WORDS)
    f = _is_word(c.data, s, e - s, _FALSE_WORDS)
    return Column(t, c.valid & (t | f), dst).mask_invalid()


def _date_of(cols, data: torch.Tensor, s: torch.Tensor, e: torch.Tensor):
    """(days, ok) of each row's bytes [s, e) read as `yyyy-M-d`: only
    digits and exactly two dashes, a 4-digit year, a 1-2 digit month in
    1-12 and a 1-2 digit day no later than the month's last (the JAX
    package's _parse_date after its trim).  The positions found are
    written in place into tensors made here."""
    dashes = torch.zeros_like(s)
    d1 = torch.zeros_like(s)
    d2 = torch.zeros_like(s)
    bad = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    for p, b in enumerate(cols):
        inr = (p >= s) & (p < e)
        dash = (b == _DASH) & inr
        bad |= inr & ~dash & ~_is_digit(b)
        d1.masked_fill_(dash & (dashes == 0), p)
        d2.masked_fill_(dash & (dashes == 1), p)
        dashes += dash.to(dashes.dtype)
    mlen, dlen = d2 - d1 - 1, e - d2 - 1
    y = _digit_at(data, s)
    for k in (1, 2, 3):
        y = y * 10 + _digit_at(data, s + k)
    m = _digit_at(data, d1 + 1)
    m = torch.where(mlen == 2, m * 10 + _digit_at(data, d1 + 2), m)
    d = _digit_at(data, d2 + 1)
    d = torch.where(dlen == 2, d * 10 + _digit_at(data, d2 + 2), d)
    ok = (~bad & (dashes == 2) & (d1 - s == 4) & (mlen >= 1) & (mlen <= 2)
          & (dlen >= 1) & (dlen <= 2) & (m >= 1) & (m <= 12) & (d >= 1))
    ok &= d <= dtu.last_day_of_month(y, m)
    return dtu.days_from_civil(y, m, d), ok


def _parse_date(c: Column, dst: DataType) -> Column:
    cols = _byte_columns(c)
    s, e = _trim(cols, c.lengths)
    days, ok = _date_of(cols, c.data, s, e)
    return Column(days, c.valid & ok, DateType).mask_invalid()


def _parse_timestamp(c: Column, dst: DataType) -> Column:
    """`yyyy-M-d`, or that, one space and 8 bytes `HH?mm?ss` (hour < 24,
    minute and second < 60; the separators are not checked, as in the
    JAX package), after the trim; the date part is trimmed again."""
    cols = _byte_columns(c)
    s, e = _trim(cols, c.lengths)
    sp = e.clone()                  # the first space, else the end
    date_end = torch.zeros_like(e)  # past the date part's last non-blank
    spaced = torch.zeros(e.shape, dtype=torch.bool, device=e.device)
    for p, b in enumerate(cols):
        before = (p >= s) & (p < e) & ~spaced
        space = (b == _SPACE) & before
        sp.masked_fill_(space, p)
        date_end.masked_fill_(before & (b > _SPACE), p + 1)
        spaced |= space
    days, ok = _date_of(cols, c.data, s, date_end)

    def two(at):
        hi, lo = _digit_at(c.data, at), _digit_at(c.data, at + 1)
        return hi * 10 + lo, (hi >= 0) & (hi < 10) & (lo >= 0) & (lo < 10)
    h, okh = two(sp + 1)
    mi, okm = two(sp + 4)
    sec, oks = two(sp + 7)
    time_ok = (okh & okm & oks & (e - sp - 1 == 8) & (h < 24) & (mi < 60)
               & (sec < 60))
    secs = torch.where(spaced, (h * 3600 + mi * 60 + sec).to(_I64), 0)
    micros = days.to(_I64) * dtu.MICROS_PER_DAY \
        + secs * dtu.MICROS_PER_SECOND
    ok &= ~spaced | time_ok
    return Column(micros, c.valid & ok, TimestampType).mask_invalid()


# --------------------------------------------------------------------------
# integer, boolean, date and timestamp -> string
# --------------------------------------------------------------------------

def _text(chars: List, width: int, length, c: Column) -> Column:
    """A string column of `width`-byte rows whose first bytes are
    `chars` (each an int or an integer tensor of one byte per row), each
    `length` bytes long (an int, or an int32 tensor of one per row)."""
    out = torch.zeros((c.capacity, width), dtype=torch.uint8,
                      device=c.device)
    for i, ch in enumerate(chars):
        out[:, i] = ch
    if isinstance(length, int):
        length = torch.full((c.capacity,), length, dtype=_I32,
                            device=c.device)
    return Column(out, c.valid, StringType, length)


# the most digits of each integral type's values
_DIGITS = {"byte": 3, "short": 5, "int": 10, "long": 19}


def _format_integral(c: Column, dst: DataType) -> Column:
    """Decimal text: a '-' before a negative value's digits, no leading
    zeros (the JAX package's _format_integral).  The digits are read off
    -|x|, which every int64 has, int64 min too."""
    k = _DIGITS[c.dtype.name]
    x = c.data.to(_I64)
    neg = x < 0
    m = torch.where(neg, x, -x)
    digits = []  # the least significant first, as ASCII
    ndig = torch.ones(c.capacity, dtype=_I32, device=c.device)
    for j in range(k):
        digits.append((_ZERO - torch.fmod(m, 10)).to(torch.uint8))
        m = torch.div(m, 10, rounding_mode="trunc")
        if j < k - 1:
            ndig += (m != 0).to(_I32)
    slen = ndig + neg.to(_I32)
    digits = torch.stack(digits, dim=1)
    chars = []
    for p in range(k + 1):
        ch = _byte_at(digits, slen - 1 - p)
        ch = torch.where(p < slen, ch, 0)
        chars.append(torch.where(neg, _DASH, ch) if p == 0 else ch)
    return _text(chars, bucket_strlen(k + 1), slen, c)


def _format_bool(c: Column, dst: DataType) -> Column:
    """`true` or `false`, in 8-byte rows."""
    t = c.data
    chars = [torch.where(t, a, b) for a, b in zip(b"true\0", b"false")]
    return _text(chars, 8, torch.where(t, 4, 5).to(_I32), c)


def _two(v: torch.Tensor) -> list:
    """Two zero-padded decimal digits of v (0-99) as bytes."""
    return [v // 10 + _ZERO, v % 10 + _ZERO]


def _date_chars(days: torch.Tensor) -> list:
    y, m, d = dtu.civil_from_days(days)
    yy = y.clamp(0, 9999)
    return ([yy // 1000 % 10 + _ZERO, yy // 100 % 10 + _ZERO,
             yy // 10 % 10 + _ZERO, yy % 10 + _ZERO, _DASH] + _two(m)
            + [_DASH] + _two(d))


def _format_date(c: Column, dst: DataType) -> Column:
    return _text(_date_chars(c.data), 16, 10, c)


def _format_timestamp(c: Column, dst: DataType) -> Column:
    h, mi, s, _ = dtu.micros_time_of_day(c.data)
    colon = ord(":")
    chars = (_date_chars(dtu.micros_to_days(c.data)) + [_SPACE] + _two(h)
             + [colon] + _two(mi) + [colon] + _two(s))
    return _text(chars, 32, 19, c)


# (source name, target name) -> route
_ROUTES = {(s.name, t.name): _num_to_num
           for s in _NUMERIC for t in _NUMERIC if s is not t}
_ROUTES.update({
    ("date", "timestamp"): _date_to_timestamp,
    ("timestamp", "date"): _timestamp_to_date,
    ("timestamp", "long"): _timestamp_to_long,
    ("timestamp", "double"): _timestamp_to_double,
    ("timestamp", "float"): _timestamp_to_double,
    ("double", "timestamp"): _double_to_timestamp,
    ("float", "timestamp"): _double_to_timestamp,
    ("boolean", "timestamp"): _bool_to_timestamp,
    ("int", "date"): _reinterpret,
    ("short", "date"): _reinterpret,
    ("date", "int"): _reinterpret,
    ("date", "long"): _reinterpret,
    ("string", "date"): _parse_date,
    ("string", "timestamp"): _parse_timestamp,
    ("date", "string"): _format_date,
    ("timestamp", "string"): _format_timestamp,
})
_ROUTES.update({(t.name, "timestamp"): _long_to_timestamp
                for t in _INT_TYPES})
_ROUTES.update({(t.name, "boolean"): _num_to_bool for t in _NUMERIC})
_ROUTES.update({("boolean", t.name): _reinterpret for t in _NUMERIC})
_ROUTES.update({("string", t.name): _parse_integral for t in _INT_TYPES})
_ROUTES.update({(t.name, "string"): _format_integral for t in _INT_TYPES})
_ROUTES.update({
    ("string", "float"): _parse_float,
    ("string", "double"): _parse_float,
    ("string", "boolean"): _parse_bool,
    ("boolean", "string"): _format_bool,
})
