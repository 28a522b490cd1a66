"""Vectorized civil-calendar conversions (days since epoch <-> y/m/d and
micros since epoch <-> time-of-day), used by the date-part expressions
(port of spark_rapids_tpu/ops/datetime_utils.py).

Torch integer arithmetic on the input tensor's device (Howard Hinnant's
civil_from_days / days_from_civil algorithms), with the JAX package's
casts: int64 inside, int32 out.  Torch's `//` and `%` floor toward -inf,
as jnp's do, so days and micros before 1970 give the same fields; int64
and int32 arithmetic wraps in both.
"""
from __future__ import annotations

import torch

# x as int64, a float converted as XLA converts it
from .expressions import _to_long as as_long

MICROS_PER_SECOND = 1_000_000
SECONDS_PER_DAY = 86_400
MICROS_PER_DAY = MICROS_PER_SECOND * SECONDS_PER_DAY

_I32, _I64 = torch.int32, torch.int64


def as_int(x: torch.Tensor) -> torch.Tensor:
    """x as int32, converted as XLA converts it: an integer wraps, a float
    is truncated, saturating at the int32 range, NaN to 0."""
    if not x.is_floating_point():
        return x.to(_I32)
    lo, hi = torch.iinfo(_I32).min, torch.iinfo(_I32).max
    return as_long(x.to(torch.float64).clamp(lo, hi)).to(_I32)


def civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day) int32 tensors."""
    z = as_long(days) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097                                   # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)          # [0, 365]
    mp = (5 * doy + 2) // 153                                # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                        # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y.to(_I32), m.to(_I32), d.to(_I32)


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor
                    ) -> torch.Tensor:
    """(year, month, day) -> int32 days since 1970-01-01."""
    y, m, d = as_long(y), as_long(m), as_long(d)
    y = torch.where(m <= 2, y - 1, y)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400                                       # [0, 399]
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1                         # [0, 365]
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy             # [0, 146096]
    return (era * 146097 + doe - 719468).to(_I32)


def floordiv(a: torch.Tensor, b) -> torch.Tensor:
    """Floor division toward -inf on int64 (torch's // already floors)."""
    return a // b


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, rounded once as IEEE division (and XLA's) rounds it: on the
    card torch turns a division by a Python number into a product with
    its reciprocal, which can differ in the last bit, so `d` goes in as
    a tensor on x's device."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def micros_to_days(micros: torch.Tensor) -> torch.Tensor:
    return (as_long(micros) // MICROS_PER_DAY).to(_I32)


def micros_time_of_day(micros: torch.Tensor):
    """-> (hour, minute, second, microsecond) int32 tensors."""
    tod = as_long(micros) % MICROS_PER_DAY
    sec = tod // MICROS_PER_SECOND
    us = tod % MICROS_PER_SECOND
    h = sec // 3600
    mi = (sec % 3600) // 60
    s = sec % 60
    return h.to(_I32), mi.to(_I32), s.to(_I32), us.to(_I32)


def is_leap_year(y: torch.Tensor) -> torch.Tensor:
    return ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)


# the month lengths of a common year, one copy on each device they are
# used on
_MONTH_DAYS = {}


def _month_days(dev: torch.device) -> torch.Tensor:
    table = _MONTH_DAYS.get(dev)
    if table is None:
        table = _MONTH_DAYS[dev] = torch.tensor(
            [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], dtype=_I32,
            device=dev)
    return table


def last_day_of_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The last day (28-31) of month `m` (1-12) of year `y`, int32.  A
    month outside 1-12 (an unparsable string's, a wrapped sum of months)
    reads the table as jnp indexes it: a negative index from the end,
    then clamped into the table."""
    i = (m - 1).to(_I64)
    i = torch.where(i < 0, i + 12, i).clamp(0, 11)
    d = _month_days(m.device)[i]
    return torch.where((m == 2) & is_leap_year(y), 29, d)
