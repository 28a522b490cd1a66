"""Cast (port of spark_rapids_tpu/ops/cast.py): a (source, target) ->
function table, with the JAX package's semantics on each route.

The routes the port has:
  * numeric -> numeric: integral narrowing wraps (Java), float ->
    integral truncates and saturates, NaN -> 0;
  * date <-> timestamp; timestamp -> long (seconds, floored) and long,
    int, short and byte -> timestamp; timestamp -> double or float
    (seconds) and double or float -> timestamp; boolean -> timestamp
    (false 0, true 1 microsecond); int and short -> date and date -> int
    and long (the days, reinterpreted);
  * string -> date (`yyyy-M-d`) and string -> timestamp (`yyyy-M-d` or
    `yyyy-M-d HH?mm?ss`, the separators of the time unchecked), parsed
    a byte position at a time after trimming the bytes <= 0x20 at either
    end, an unparsable row null;
  * date -> string (`yyyy-MM-dd`, the year clipped to 0-9999, 16-byte
    rows) and timestamp -> string (`yyyy-MM-dd HH:mm:ss`, 32-byte rows;
    the JAX package's are 24 bytes wide, with the same bytes up to each
    row's length).  A null row keeps the text of its zeroed data, as in
    the JAX package.
The JAX package's other routes (string <-> integral, string -> float,
double and boolean, boolean -> string, numeric <-> boolean) are not
ported: Cast raises NotImplementedError naming the cast when it is made,
so a plan that needs one fails at planning time.  `supported_cast`
answers for the JAX package's whole table, so the planner can tell a
cast that package rejects too (AnalysisError) from one the port lacks.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..columnar import Column
from ..types import (ByteType, DataType, DateType, DoubleType,
                     FloatType, IntegerType, LongType, ShortType, StringType,
                     TimestampType)
from . import datetime_utils as dtu
from .expressions import Expression

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
        if src is not to and (src.name, to.name) not in _ROUTES:
            raise NotImplementedError(
                f"cast {src.name} -> {to.name} is not ported")
        self.child = child
        self.to = to
        self.children = (child,)

    @property
    def dtype(self):
        return self.to

    def __repr__(self):
        return f"cast({self.child!r} as {self.to.name})"

    def eval(self, batch):
        return cast_column(self.child.eval(batch), self.to)


def cast_column(c: Column, to: DataType) -> Column:
    """Column `c` cast to `to`, by a route the port has."""
    return c if c.dtype is to else _ROUTES[(c.dtype.name, to.name)](c, to)


def supported_cast(src: DataType, dst: DataType) -> bool:
    """Whether the JAX package has this cast (ported or not)."""
    key = (src.name, dst.name)
    return src is dst or key in _ROUTES or key in _UNPORTED


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
# string -> date / timestamp: one pass over the rows per byte position,
# so no matrix wider than the text's bytes is made
# --------------------------------------------------------------------------

_SPACE, _DASH, _ZERO = 0x20, 0x2D, 0x30


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


def _digit_at(data: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """Each row's byte at position `at` (clamped into the row) less '0',
    int32."""
    idx = at.clamp(0, data.shape[1] - 1).to(_I64)[:, None]
    return data.gather(1, idx)[:, 0].to(_I32) - _ZERO


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
# date / timestamp -> string
# --------------------------------------------------------------------------

def _text(chars: List, width: int, length: int, c: Column) -> Column:
    """A string column of `width`-byte rows whose first bytes are
    `chars` (each an int or an integer tensor of one byte per row)."""
    out = torch.zeros((c.capacity, width), dtype=torch.uint8,
                      device=c.device)
    for i, ch in enumerate(chars):
        out[:, i] = ch
    return Column(out, c.valid, StringType,
                  torch.full((c.capacity,), length, dtype=_I32,
                             device=c.device))


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
# the JAX package's routes the port does not have yet
_UNPORTED = ({(t.name, "boolean") for t in _NUMERIC}
             | {("boolean", t.name) for t in _NUMERIC}
             | {("string", t.name) for t in _INT_TYPES}
             | {(t.name, "string") for t in _INT_TYPES}
             | {("string", "float"), ("string", "double"),
                ("string", "boolean"), ("boolean", "string")})
