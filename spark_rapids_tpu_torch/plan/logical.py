"""Logical plan and the unresolved column DSL (port of the slice's part of
spark_rapids_tpu/plan/logical.py): `col`, `lit`, the arithmetic
operators (`+ - * / %` and unary `-`; IntegralDivide and Pmod have no
operator and are built as `ColumnExpr("Pmod", (a, b))`), `abs`, the
comparison and boolean operators, `between`, `isin`, `is_null` and
`is_not_null`, the aggregate functions sum, avg, count, min, max,
`count_distinct`, `first`, `last` and `percentile` (the others'
distinct forms through `functions._agg(op, e, distinct=True)`),
`when`/`otherwise`, `coalesce`, `isnan`, `least` and `greatest`,
`substr`, `startswith`, `endswith`, `contains` and `like`, the date
parts `year`, `month`, `dayofmonth`, `hour`, `minute` and `second`,
`cast` (to a type or its name), `to_date`, `date_add`, `date_sub`,
`datediff`, `add_months`, `months_between`, `trunc` and `next_day`
(UnixTimestamp, FromUnixTime, TimeAdd and TimeSub have no function, in
the JAX package either: they are built by op name), the math functions
`sqrt`, `exp`, `log`, `pow`, `floor`, `ceil`, `round`, `bround`,
`hypot`, `cot`, `log_base`, `asinh`, `acosh` and `atanh`, and `hash`
(the other math classes and the bitwise ones have no function in the JAX
package either: `ColumnExpr("Sin", (e,))`, `ColumnExpr("ShiftLeft", (e,
n))`), the window functions `row_number`, `rank`, `dense_rank`, `lag`
and `lead` with `ColumnExpr.over`, `WindowSpec` and `Window`,
`SortOrder`, and the scan, filter, project, aggregate, join, sort,
limit, union, distinct, expand and window nodes.  Op names
and argument layouts are the JAX package's, so one ColumnExpr tree means
the same to both.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..types import TYPES_BY_NAME, DateType, Schema


class ColumnExpr:
    """Unresolved expression; analysis resolves it against a child schema."""

    def __init__(self, op: str, args: Tuple = (), alias: Optional[str] = None):
        self.op = op
        self.args = args
        self._alias = alias

    def _bin(self, op, other, flip=False):
        other = _wrap(other)
        return ColumnExpr(op, (other, self) if flip else (self, other))

    def __add__(self, o):
        return self._bin("Add", o)

    def __radd__(self, o):
        return self._bin("Add", o, flip=True)

    def __sub__(self, o):
        return self._bin("Subtract", o)

    def __rsub__(self, o):
        return self._bin("Subtract", o, flip=True)

    def __mul__(self, o):
        return self._bin("Multiply", o)

    def __rmul__(self, o):
        return self._bin("Multiply", o, flip=True)

    def __truediv__(self, o):
        return self._bin("Divide", o)

    def __rtruediv__(self, o):
        return self._bin("Divide", o, flip=True)

    def __mod__(self, o):
        return self._bin("Remainder", o)

    def __neg__(self):
        return ColumnExpr("UnaryMinus", (self,))

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("EqualTo", o)

    def __ne__(self, o):  # type: ignore[override]
        return ColumnExpr("Not", (self._bin("EqualTo", o),))

    def __lt__(self, o):
        return self._bin("LessThan", o)

    def __le__(self, o):
        return self._bin("LessThanOrEqual", o)

    def __gt__(self, o):
        return self._bin("GreaterThan", o)

    def __ge__(self, o):
        return self._bin("GreaterThanOrEqual", o)

    def __and__(self, o):
        return self._bin("And", o)

    def __or__(self, o):
        return self._bin("Or", o)

    def __invert__(self):
        return ColumnExpr("Not", (self,))

    def __hash__(self):
        return id(self)

    def alias(self, name: str) -> "ColumnExpr":
        return ColumnExpr(self.op, self.args, alias=name)

    def cast(self, to) -> "ColumnExpr":
        if isinstance(to, str):  # Spark accepts type names: .cast("BIGINT")
            name = to.strip().lower()
            name = {"bigint": "long", "integer": "int",
                    "smallint": "short", "tinyint": "byte"}.get(name, name)
            if name not in TYPES_BY_NAME:
                raise ValueError(
                    f"cast target type {to!r} is not supported "
                    f"(supported: {sorted(TYPES_BY_NAME)})")
            to = TYPES_BY_NAME[name]
        return ColumnExpr("Cast", (self, to))

    def between(self, lo, hi) -> "ColumnExpr":
        return (self >= lo) & (self <= hi)

    def isin(self, *items) -> "ColumnExpr":
        vals = items[0] if len(items) == 1 and isinstance(items[0],
                                                          (list, tuple)) \
            else items
        return ColumnExpr("In", (self, list(vals)))

    def is_null(self) -> "ColumnExpr":
        return ColumnExpr("IsNull", (self,))

    def is_not_null(self) -> "ColumnExpr":
        return ColumnExpr("IsNotNull", (self,))

    def substr(self, pos, length) -> "ColumnExpr":
        return ColumnExpr("Substring", (self, _wrap(pos), _wrap(length)))

    def startswith(self, s) -> "ColumnExpr":
        return ColumnExpr("StartsWith", (self, _wrap(s)))

    def endswith(self, s) -> "ColumnExpr":
        return ColumnExpr("EndsWith", (self, _wrap(s)))

    def contains(self, s) -> "ColumnExpr":
        return ColumnExpr("Contains", (self, _wrap(s)))

    def like(self, pattern: str) -> "ColumnExpr":
        return ColumnExpr("Like", (self, _wrap(pattern)))

    def asc(self) -> "SortOrder":
        return SortOrder(self, ascending=True)

    def desc(self) -> "SortOrder":
        return SortOrder(self, ascending=False)

    def over(self, spec: "WindowSpec") -> "ColumnExpr":
        """An aggregate or ranking call as a window expression over `spec`
        (pyspark's Column.over); its args are (call, spec)."""
        return ColumnExpr("WindowExpr", (self, spec), alias=self._alias)

    @property
    def output_name(self) -> str:
        if self._alias:
            return self._alias
        if self.op == "col":
            return self.args[0]
        return self.op.lower()

    def __repr__(self):
        if self.op in ("col", "lit"):
            return f"{self.op}({self.args[0]!r})"
        return f"{self.op}({', '.join(map(repr, self.args))})"

    def __bool__(self):
        raise TypeError("Cannot convert ColumnExpr to bool; use & | ~")


def _wrap(v) -> ColumnExpr:
    return v if isinstance(v, ColumnExpr) else ColumnExpr("lit", (v,))


def col(name: str) -> ColumnExpr:
    return ColumnExpr("col", (name,))


def lit(v) -> ColumnExpr:
    return ColumnExpr("lit", (v,))


@dataclasses.dataclass
class SortOrder:
    child: ColumnExpr
    ascending: bool = True
    nulls_first: Optional[bool] = None  # default: first if asc, last if desc

    @property
    def effective_nulls_first(self) -> bool:
        return self.ascending if self.nulls_first is None else self.nulls_first


class functions:
    """The functions of spark.sql.functions the slice has."""

    col = staticmethod(col)
    lit = staticmethod(lit)

    @staticmethod
    def _agg(op, e, distinct=False):
        """An aggregate call: its args are (child, distinct)."""
        return ColumnExpr(op, (_wrap(e), distinct))

    @staticmethod
    def sum(e):
        return functions._agg("Sum", e)

    @staticmethod
    def avg(e):
        return functions._agg("Average", e)

    @staticmethod
    def min(e):
        return functions._agg("Min", e)

    @staticmethod
    def max(e):
        return functions._agg("Max", e)

    @staticmethod
    def count(e):
        return functions._agg("Count", e)

    @staticmethod
    def count_distinct(e):
        return functions._agg("Count", e, distinct=True)

    @staticmethod
    def first(e):
        """The first row's value, nulls included (Spark's ignoreNulls
        false)."""
        return functions._agg("First", e)

    @staticmethod
    def last(e):
        return functions._agg("Last", e)

    @staticmethod
    def percentile(e, p: float):
        """Spark's exact `percentile`; its args are (child, False, p).
        The planner refuses it (plan/physical.py)."""
        return ColumnExpr("Percentile", (_wrap(e), False, float(p)))

    @staticmethod
    def row_number():
        return ColumnExpr("RowNumber", ())

    @staticmethod
    def rank():
        return ColumnExpr("Rank", ())

    @staticmethod
    def dense_rank():
        return ColumnExpr("DenseRank", ())

    @staticmethod
    def lag(e, offset: int = 1, default=None):
        """The value `offset` rows before, within the partition; else
        `default` (null when None).  Its args are (child, offset,
        default)."""
        return ColumnExpr("Lag", (_wrap(e), offset, default))

    @staticmethod
    def lead(e, offset: int = 1, default=None):
        return ColumnExpr("Lead", (_wrap(e), offset, default))

    @staticmethod
    def when(cond, value):
        return WhenBuilder([(cond, _wrap(value))])

    @staticmethod
    def coalesce(*exprs):
        return ColumnExpr("Coalesce", tuple(_wrap(e) for e in exprs))

    @staticmethod
    def abs(e):
        return ColumnExpr("Abs", (_wrap(e),))

    @staticmethod
    def isnan(e):
        return ColumnExpr("IsNaN", (_wrap(e),))

    @staticmethod
    def least(*exprs):
        return ColumnExpr("Least", tuple(_wrap(e) for e in exprs))

    @staticmethod
    def greatest(*exprs):
        return ColumnExpr("Greatest", tuple(_wrap(e) for e in exprs))

    @staticmethod
    def sqrt(e):
        return ColumnExpr("Sqrt", (_wrap(e),))

    @staticmethod
    def exp(e):
        return ColumnExpr("Exp", (_wrap(e),))

    @staticmethod
    def log(e):
        return ColumnExpr("Log", (_wrap(e),))

    @staticmethod
    def pow(a, b):
        return ColumnExpr("Pow", (_wrap(a), _wrap(b)))

    @staticmethod
    def floor(e):
        return ColumnExpr("Floor", (_wrap(e),))

    @staticmethod
    def ceil(e):
        return ColumnExpr("Ceil", (_wrap(e),))

    @staticmethod
    def round(e, scale=0):
        return ColumnExpr("Round", (_wrap(e), _wrap(scale)))

    @staticmethod
    def bround(e, scale=0):
        return ColumnExpr("BRound", (_wrap(e), _wrap(scale)))

    @staticmethod
    def hypot(a, b):
        return ColumnExpr("Hypot", (_wrap(a), _wrap(b)))

    @staticmethod
    def cot(e):
        return ColumnExpr("Cot", (_wrap(e),))

    @staticmethod
    def log_base(base, e):
        return ColumnExpr("Logarithm", (_wrap(base), _wrap(e)))

    @staticmethod
    def asinh(e):
        return ColumnExpr("Asinh", (_wrap(e),))

    @staticmethod
    def acosh(e):
        return ColumnExpr("Acosh", (_wrap(e),))

    @staticmethod
    def atanh(e):
        return ColumnExpr("Atanh", (_wrap(e),))

    @staticmethod
    def hash(*exprs):
        return ColumnExpr("Murmur3Hash", tuple(_wrap(e) for e in exprs))

    @staticmethod
    def year(e):
        return ColumnExpr("Year", (_wrap(e),))

    @staticmethod
    def month(e):
        return ColumnExpr("Month", (_wrap(e),))

    @staticmethod
    def dayofmonth(e):
        return ColumnExpr("DayOfMonth", (_wrap(e),))

    @staticmethod
    def hour(e):
        return ColumnExpr("Hour", (_wrap(e),))

    @staticmethod
    def minute(e):
        return ColumnExpr("Minute", (_wrap(e),))

    @staticmethod
    def second(e):
        return ColumnExpr("Second", (_wrap(e),))

    @staticmethod
    def to_date(e):
        return ColumnExpr("Cast", (_wrap(e), DateType))

    @staticmethod
    def date_add(e, days):
        return ColumnExpr("DateAdd", (_wrap(e), _wrap(days)))

    @staticmethod
    def date_sub(e, days):
        return ColumnExpr("DateSub", (_wrap(e), _wrap(days)))

    @staticmethod
    def datediff(end, start):
        return ColumnExpr("DateDiff", (_wrap(end), _wrap(start)))

    @staticmethod
    def add_months(e, n):
        return ColumnExpr("AddMonths", (_wrap(e), _wrap(n)))

    @staticmethod
    def months_between(a, b, round_off=True):
        return ColumnExpr("MonthsBetween", (_wrap(a), _wrap(b),
                                            _wrap(round_off)))

    @staticmethod
    def trunc(e, fmt):
        return ColumnExpr("TruncDate", (_wrap(e), _wrap(fmt)))

    @staticmethod
    def next_day(e, day_of_week):
        return ColumnExpr("NextDay", (_wrap(e), _wrap(day_of_week)))


class WindowSpec:
    """A window's partition keys, order and frame (pyspark's WindowSpec).
    `frame` is None (Spark's default: the whole partition without an
    ORDER BY, else from its start to the current row's last peer) or
    ("rows", start, end)."""

    def __init__(self, parts=(), orders=(), frame=None):
        self.parts = list(parts)
        self.orders = list(orders)
        self.frame = frame

    def partition_by(self, *cols) -> "WindowSpec":
        return WindowSpec([c if isinstance(c, ColumnExpr) else col(c)
                           for c in cols], self.orders, self.frame)

    partitionBy = partition_by

    def order_by(self, *orders) -> "WindowSpec":
        os = [o if isinstance(o, SortOrder)
              else SortOrder(col(o) if isinstance(o, str) else o)
              for o in orders]
        return WindowSpec(self.parts, os, self.frame)

    orderBy = order_by

    def rows_between(self, start: int, end: int) -> "WindowSpec":
        return WindowSpec(self.parts, self.orders,
                          ("rows", int(start), int(end)))

    rowsBetween = rows_between

    def _group_key(self):
        """Specs with the same partition and order share one window node
        (their frames may differ)."""
        return (tuple(repr(c) for c in self.parts),
                tuple((repr(o.child), o.ascending, o.effective_nulls_first)
                      for o in self.orders))


class Window:
    """pyspark.sql.Window's namespace."""

    unboundedPreceding = unbounded_preceding = -(1 << 62)
    unboundedFollowing = unbounded_following = (1 << 62)
    currentRow = current_row = 0

    @staticmethod
    def partition_by(*cols) -> WindowSpec:
        return WindowSpec().partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*orders) -> WindowSpec:
        return WindowSpec().order_by(*orders)

    orderBy = order_by


class WhenBuilder(ColumnExpr):
    """`when(c, v).when(c2, v2).otherwise(v3)`: a CaseWhen whose args are
    (((cond, value), ...), otherwise or None)."""

    def __init__(self, branches, otherwise=None):
        super().__init__("CaseWhen", (tuple(branches), otherwise))

    def when(self, cond, value):
        return WhenBuilder(self.args[0] + ((cond, _wrap(value)),))

    def otherwise(self, value):
        return WhenBuilder(self.args[0], _wrap(value))


# --------------------------------------------------------------------------
# logical plan nodes
# --------------------------------------------------------------------------

class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    def __repr__(self):
        return type(self).__name__


class LogicalScan(LogicalPlan):
    """An in-memory table already on the device (a ColumnarBatch).
    `schema` may name a subset of the table's columns (column pruning);
    `nbytes` is the whole table's size as Arrow lays it out, the
    planner's size estimate of the scan."""

    def __init__(self, table, num_rows: int, schema: Schema, nbytes: int):
        self.table = table
        self.num_rows = num_rows
        self.schema = schema
        self.nbytes = nbytes


class LogicalProject(LogicalPlan):
    def __init__(self, exprs: Sequence[ColumnExpr], child: LogicalPlan):
        self.exprs = list(exprs)
        self.children = (child,)


class LogicalFilter(LogicalPlan):
    def __init__(self, condition: ColumnExpr, child: LogicalPlan):
        self.condition = condition
        self.children = (child,)


class LogicalAggregate(LogicalPlan):
    def __init__(self, grouping: Sequence[ColumnExpr],
                 aggregates: Sequence[ColumnExpr], child: LogicalPlan):
        self.grouping = list(grouping)
        self.aggregates = list(aggregates)
        self.children = (child,)


class LogicalJoin(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 join_type: str, condition: Optional[ColumnExpr] = None,
                 using: Optional[List[str]] = None):
        self.join_type = join_type
        self.condition = condition
        self.using = using
        self.children = (left, right)


class LogicalSort(LogicalPlan):
    def __init__(self, orders: Sequence[SortOrder], child: LogicalPlan):
        self.orders = [o if isinstance(o, SortOrder) else SortOrder(o)
                       for o in orders]
        self.children = (child,)


class LogicalLimit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = n
        self.children = (child,)


class LogicalUnion(LogicalPlan):
    """UNION ALL of n children, by position: the first child names the
    columns."""

    def __init__(self, children: Sequence[LogicalPlan]):
        self.children = tuple(children)


class LogicalDistinct(LogicalPlan):
    def __init__(self, child: LogicalPlan):
        self.children = (child,)


class LogicalExpand(LogicalPlan):
    """ROLLUP/CUBE fan-out: list of projection lists."""

    def __init__(self, projections: Sequence[Sequence[ColumnExpr]],
                 child: LogicalPlan):
        self.projections = [list(p) for p in projections]
        self.children = (child,)


class LogicalWindow(LogicalPlan):
    """The window expressions of one (partition, order) spec group over
    the child: every child column, then one column per expression."""

    def __init__(self, window_exprs: Sequence[ColumnExpr],
                 partition_by: Sequence[ColumnExpr],
                 order_by: Sequence[SortOrder], child: LogicalPlan):
        self.window_exprs = list(window_exprs)
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.children = (child,)
