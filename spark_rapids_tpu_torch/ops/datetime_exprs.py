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
The date arithmetic of the JAX module (DateAdd to NextDay) is not
ported.
"""
from __future__ import annotations

import torch

from ..columnar import Column
from ..types import DateType, IntegerType, StringType, TimestampType
from . import datetime_utils as dtu
from .expressions import Expression


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


# the op names `resolve` maps to a class, the JAX package's: WeekDay has
# none there either
DATE_PARTS = {c.__name__: c for c in (
    Year, Month, DayOfMonth, Hour, Minute, Second, DayOfWeek, DayOfYear,
    Quarter, LastDay)}
