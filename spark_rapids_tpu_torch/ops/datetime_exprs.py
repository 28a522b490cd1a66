"""Date parts (port of the `_DatePart` family of
spark_rapids_tpu/ops/datetime_exprs.py): Year, Month, DayOfMonth,
DayOfWeek, DayOfYear, Quarter, LastDay, Hour, Minute, Second and WeekDay.

Each extracts an int field (LastDay: a date) from its child, as torch
integer arithmetic on the batch's device through datetime_utils, UTC
only.  A TimestampType child is read as microseconds and taken to its
day first; any other child's data is read as days, as the JAX package
reads it: a date's int32 days, an integer column's values, a float
column's values converted as XLA converts a float to an integer.  The
result's validity is the child's, and a null slot keeps what the field
of its zeroed data is (the JAX package does not zero it either).

Two quirks of the JAX package are kept on purpose:
  * Hour, Minute and Second read the child's data as microseconds even
    when the child is a date, so a date's hour is that of `days`
    microseconds after the epoch (0 for 1970 onwards, 23 before);
  * DayOfYear subtracts in the child's type (int32 for a date), not in
    int64.
A string child, which the JAX package cannot evaluate (it has no field
of a byte matrix), raises NotImplementedError when the tree is built.

The date arithmetic (DateAdd to NextDay) computes what the JAX classes
compute, with their quirks kept:
  * DateAdd and DateSub take both sides to int32 first, so a long day
    count wraps; DateDiff takes a side that is not a date to its day
    with a floor, before 1970 too;
  * UnixTimestamp ignores its format: a timestamp is floored to seconds,
    a date's days times 86400, a string parsed as the string ->
    timestamp cast parses it (whatever castStringToTimestamp says, as
    the JAX package does not gate it); FromUnixTime ignores its format
    and writes `yyyy-MM-dd HH:mm:ss`;
  * MonthsBetween takes a timestamp to its day (Spark keeps the time of
    day) and rounds to 8 decimals only when round_off is a literal true;
  * TruncDate and NextDay read their child's data as days, a
    timestamp's microseconds too, need a string literal for the format
    or the day (the JAX package runs any other on its CPU executor,
    which the port does not have, so it raises at planning time), and
    give nulls over zeroed data for one they do not know.
Where the JAX package fails when it evaluates one of these over a string
child (it has no days in a byte matrix), the port raises
NotImplementedError when the tree is built.
"""
from __future__ import annotations

import torch

from ..columnar import Column
from ..types import (DateType, DoubleType, IntegerType, LongType,
                     StringType, TimestampType)
from . import datetime_utils as dtu
from .cast import cast_column
from .expressions import Expression, Literal


class _DatePart(Expression):
    """Extract an int field from a date or timestamp column."""

    out_dtype = IntegerType

    def __init__(self, child: Expression):
        if child.dtype is StringType:
            raise NotImplementedError(
                f"{type(self).__name__} of a string column is not ported: "
                "the JAX package cannot evaluate it")
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return self.out_dtype

    def _days(self, c: Column) -> torch.Tensor:
        if self.child.dtype is TimestampType:
            return dtu.micros_to_days(c.data)
        return c.data

    def eval(self, batch):
        c = self.child.eval(batch)
        return Column(self.compute(c), c.valid, self.out_dtype)

    def compute(self, c: Column) -> torch.Tensor:
        raise NotImplementedError


class Year(_DatePart):
    def compute(self, c):
        y, _, _ = dtu.civil_from_days(self._days(c))
        return y


class Month(_DatePart):
    def compute(self, c):
        _, m, _ = dtu.civil_from_days(self._days(c))
        return m


class DayOfMonth(_DatePart):
    def compute(self, c):
        _, _, d = dtu.civil_from_days(self._days(c))
        return d


class DayOfWeek(_DatePart):
    """Spark: 1 = Sunday ... 7 = Saturday."""

    def compute(self, c):
        days = dtu.as_long(self._days(c))
        # 1970-01-01 was a Thursday (=> dayofweek 5)
        return ((days + 4) % 7 + 1).to(torch.int32)


class DayOfYear(_DatePart):
    def compute(self, c):
        days = self._days(c)
        y, _, _ = dtu.civil_from_days(days)
        jan1 = dtu.days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
        if days.dtype is torch.bool:  # jnp takes a bool to int32 here
            days = days.to(torch.int32)
        # in the child's type (int32 for a date), as jnp promotes it
        return dtu.as_int(days - jan1 + 1)


class Quarter(_DatePart):
    def compute(self, c):
        _, m, _ = dtu.civil_from_days(self._days(c))
        return ((m - 1) // 3 + 1).to(torch.int32)


class LastDay(_DatePart):
    out_dtype = DateType

    def compute(self, c):
        y, m, _ = dtu.civil_from_days(self._days(c))
        return dtu.days_from_civil(y, m, dtu.last_day_of_month(y, m))


class Hour(_DatePart):
    def compute(self, c):
        h, _, _, _ = dtu.micros_time_of_day(c.data)
        return h


class Minute(_DatePart):
    def compute(self, c):
        _, m, _, _ = dtu.micros_time_of_day(c.data)
        return m


class Second(_DatePart):
    def compute(self, c):
        _, _, s, _ = dtu.micros_time_of_day(c.data)
        return s


class WeekDay(_DatePart):
    """Spark weekday: 0 = Monday ... 6 = Sunday."""

    def compute(self, c):
        days = dtu.as_long(self._days(c))
        return ((days + 3) % 7).to(torch.int32)


def _no_strings(cls: type, *children: Expression) -> None:
    if any(c.dtype is StringType for c in children):
        raise NotImplementedError(
            f"{cls.__name__} of a string column is not ported: the JAX "
            "package cannot evaluate it")


def _days_of(e: Expression, c: Column) -> torch.Tensor:
    """A date's days, any other child's data taken as microseconds to its
    day (floored)."""
    return c.data if e.dtype is DateType else dtu.micros_to_days(c.data)


class _DateArith(Expression):
    """date +- a day count, both taken to int32 first."""

    sign = 1

    def __init__(self, left: Expression, right: Expression):
        _no_strings(type(self), left, right)
        self.left, self.right = left, right
        self.children = (left, right)

    @property
    def dtype(self):
        return DateType

    def eval(self, batch):
        l, r = self.left.eval(batch), self.right.eval(batch)
        a, b = dtu.as_int(l.data), dtu.as_int(r.data)
        data = a + b if self.sign > 0 else a - b
        return Column(data, l.valid & r.valid, DateType).mask_invalid()


class DateAdd(_DateArith):
    pass


class DateSub(_DateArith):
    sign = -1


class DateDiff(_DateArith):
    """datediff(end, start): days from start to end, int32."""

    @property
    def dtype(self):
        return IntegerType

    def eval(self, batch):
        end, start = self.left.eval(batch), self.right.eval(batch)
        diff = _days_of(self.left, end) - _days_of(self.right, start)
        return Column(dtu.as_int(diff), end.valid & start.valid,
                      IntegerType).mask_invalid()


class UnixTimestamp(Expression):
    """unix_timestamp(timestamp | date | string[, fmt]) -> long seconds;
    `fmt` is ignored."""

    def __init__(self, child: Expression, fmt: Expression = None):
        if child.dtype not in (TimestampType, DateType, StringType):
            raise NotImplementedError(
                f"unix_timestamp({child.dtype.name}) is not supported")
        self.child = child
        self.fmt = fmt
        self.children = (child,)

    @property
    def dtype(self):
        return LongType

    def eval(self, batch):
        c = self.child.eval(batch)
        if self.child.dtype is DateType:
            return Column(c.data.to(torch.int64) * dtu.SECONDS_PER_DAY,
                          c.valid, LongType)
        c = cast_column(c, TimestampType)  # a string parsed, ungated
        return Column(c.data // dtu.MICROS_PER_SECOND, c.valid, LongType)


class ToUnixTimestamp(UnixTimestamp):
    pass


class FromUnixTime(Expression):
    """from_unixtime(seconds[, fmt]) -> `yyyy-MM-dd HH:mm:ss`; `fmt` is
    ignored."""

    def __init__(self, child: Expression, fmt: Expression = None):
        _no_strings(type(self), child)
        self.child = child
        self.fmt = fmt
        self.children = (child,)

    @property
    def dtype(self):
        return StringType

    def eval(self, batch):
        c = self.child.eval(batch)
        micros = dtu.as_long(c.data) * dtu.MICROS_PER_SECOND
        return cast_column(Column(micros, c.valid, TimestampType),
                           StringType)


class _TimeArith(Expression):
    """timestamp +- an interval in microseconds."""

    sign = 1

    def __init__(self, child: Expression, interval_micros: Expression):
        _no_strings(type(self), child, interval_micros)
        self.child = child
        self.interval = interval_micros
        self.children = (child, interval_micros)

    @property
    def dtype(self):
        return TimestampType

    def eval(self, batch):
        c, i = self.child.eval(batch), self.interval.eval(batch)
        step = dtu.as_long(i.data)
        data = c.data + step if self.sign > 0 else c.data - step
        return Column(data, c.valid & i.valid,
                      TimestampType).mask_invalid()


class TimeAdd(_TimeArith):
    pass


class TimeSub(_TimeArith):
    sign = -1


class AddMonths(Expression):
    """add_months(date, n): civil month arithmetic, the day of month
    clamped to the target month's last day."""

    def __init__(self, left: Expression, right: Expression):
        _no_strings(type(self), left, right)
        self.left, self.right = left, right
        self.children = (left, right)

    @property
    def dtype(self):
        return DateType

    def eval(self, batch):
        d, n = self.left.eval(batch), self.right.eval(batch)
        y, m, dom = dtu.civil_from_days(d.data)
        total = (y.to(torch.int64) * 12 + (m.to(torch.int64) - 1)
                 + dtu.as_long(n.data))
        ny = dtu.floordiv(total, 12).to(torch.int32)
        # ny * 12 in int32, as jnp computes it, so a huge count wraps alike
        nm = (total - ny * 12 + 1).to(torch.int32)
        nd = torch.minimum(dom, dtu.last_day_of_month(ny, nm))
        out = dtu.days_from_civil(ny, nm, nd)
        return Column(out, d.valid & n.valid, DateType).mask_invalid()


class MonthsBetween(Expression):
    """months_between(d1, d2[, round_off]): whole months when the days of
    month match or both are month ends, else the day difference over 31
    added; rounded to 8 decimals when round_off is a literal true (the
    default)."""

    def __init__(self, left: Expression, right: Expression,
                 round_off: Expression = None):
        _no_strings(type(self), left, right)
        self.left, self.right = left, right
        self.round_off = round_off if round_off is not None \
            else Literal(True)
        self.children = (left, right, self.round_off)

    @property
    def dtype(self):
        return DoubleType

    def eval(self, batch):
        a, b = self.left.eval(batch), self.right.eval(batch)
        y1, m1, dom1 = dtu.civil_from_days(_days_of(self.left, a))
        y2, m2, dom2 = dtu.civil_from_days(_days_of(self.right, b))
        months = ((y1 - y2) * 12 + (m1 - m2)).to(torch.float64)
        whole = (dom1 == dom2) | ((dom1 == dtu.last_day_of_month(y1, m1))
                                  & (dom2 == dtu.last_day_of_month(y2, m2)))
        frac = dtu.true_div((dom1 - dom2).to(torch.float64), 31.0)
        out = months + torch.where(whole, 0.0, frac)
        if isinstance(self.round_off, Literal) and bool(self.round_off.value):
            out = dtu.true_div(torch.round(out * 1e8), 1e8)
        return Column(out, a.valid & b.valid, DoubleType).mask_invalid()


def _literal_string(cls: type, e: Expression, what: str) -> str:
    if not (isinstance(e, Literal) and isinstance(e.value, str)):
        raise NotImplementedError(
            f"{cls.__name__} needs a string literal {what}: the JAX "
            "package runs any other on its CPU executor, which the port "
            "does not have")
    return e.value


def _nulls(c: Column) -> Column:
    return Column(torch.zeros(c.capacity, dtype=torch.int32,
                              device=c.device),
                  torch.zeros_like(c.valid), DateType)


_TRUNC_LEVELS = {"year": "year", "yyyy": "year", "yy": "year",
                 "quarter": "quarter", "month": "month", "mon": "month",
                 "mm": "month", "week": "week"}


class TruncDate(Expression):
    """trunc(date, fmt): the first day of its year, quarter, month or
    week (Monday)."""

    def __init__(self, child: Expression, fmt: Expression):
        _no_strings(type(self), child)
        self.level = _TRUNC_LEVELS.get(
            _literal_string(type(self), fmt, "format").lower())
        self.child, self.fmt = child, fmt
        self.children = (child, fmt)

    @property
    def dtype(self):
        return DateType

    def eval(self, batch):
        c = self.child.eval(batch)
        if self.level is None:
            return _nulls(c)
        days = dtu.as_long(c.data)
        y, m, _ = dtu.civil_from_days(days)
        one = torch.ones_like(m)
        if self.level == "year":
            out = dtu.days_from_civil(y, one, one)
        elif self.level == "quarter":
            out = dtu.days_from_civil(y, (m - 1) // 3 * 3 + 1, one)
        elif self.level == "month":
            out = dtu.days_from_civil(y, m, one)
        else:  # the Monday on or before
            out = (days - (days + 3) % 7).to(torch.int32)
        return Column(out, c.valid, DateType)


_DAY_NAMES = {"MO": 0, "MON": 0, "MONDAY": 0, "TU": 1, "TUE": 1,
              "TUESDAY": 1, "WE": 2, "WED": 2, "WEDNESDAY": 2, "TH": 3,
              "THU": 3, "THURSDAY": 3, "FR": 4, "FRI": 4, "FRIDAY": 4,
              "SA": 5, "SAT": 5, "SATURDAY": 5, "SU": 6, "SUN": 6,
              "SUNDAY": 6}


class NextDay(Expression):
    """next_day(date, dayOfWeek): the first date later than `date` on
    that weekday."""

    def __init__(self, child: Expression, day: Expression):
        _no_strings(type(self), child)
        self.target = _DAY_NAMES.get(
            _literal_string(type(self), day, "day").strip().upper())
        self.child, self.day = child, day
        self.children = (child, day)

    @property
    def dtype(self):
        return DateType

    def eval(self, batch):
        c = self.child.eval(batch)
        if self.target is None:
            return _nulls(c)
        days = dtu.as_long(c.data)
        delta = (self.target - (days + 3) % 7 + 7) % 7  # 0 = Monday
        delta = torch.where(delta == 0, 7, delta)
        return Column((days + delta).to(torch.int32), c.valid, DateType)


# the op names `resolve` maps to a class, the JAX package's: WeekDay and
# ToUnixTimestamp have none there either
DATE_PARTS = {c.__name__: c for c in (
    Year, Month, DayOfMonth, Hour, Minute, Second, DayOfWeek, DayOfYear,
    Quarter, LastDay)}
DATE_FUNCTIONS = {c.__name__: c for c in (
    DateAdd, DateSub, DateDiff, UnixTimestamp, FromUnixTime, TimeAdd,
    TimeSub, AddMonths, MonthsBetween, TruncDate, NextDay)}
