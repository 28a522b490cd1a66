"""The port's date parts (Year, Month, DayOfMonth, DayOfWeek, DayOfYear,
Quarter, LastDay, Hour, Minute, Second and WeekDay) against the JAX
package's classes, value for value and null for null.

One seeded numpy table: dates over 1600-2400 (negative days, the leap
days 1900-02-28/03-01, 2000-02-29, 2100-02-28/03-01, 1600-02-29 and
2400-02-29 among them), timestamps over the same years in microseconds
(pre-epoch ones, a microsecond either side of midnight, the int64
extremes), and the other children the JAX classes evaluate as days: int
and long columns with their extremes, a double column with NaN, +-inf
and values past the int64 range, and a boolean column.  Every column
has about 15% nulls.  Each class takes each column through the JAX class
and the port's, evaluated directly; the results must have the same null
mask and, at every row, the same value (a null slot holds the field of
its zeroed data in both).  The DSL (`year` to `second`) is held to the
JAX package through `select`, `with_column` and `group_by`, and a string
child, which the JAX package cannot evaluate, must raise when the port's
plan is made.

The JAX package is imported inside the functions that use it:
tests/test_torch_cuda.py reuses the table and the cases on a machine
without JAX.
"""
import datetime

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import Column
from spark_rapids_tpu_torch.ops import datetime_exprs as PD
from spark_rapids_tpu_torch.ops.expressions import Expression
from spark_rapids_tpu_torch.plan import logical as PL

N = 1024
_EPOCH = datetime.date(1970, 1, 1)
_DAY_US = 86_400_000_000
CLASSES = ["Year", "Month", "DayOfMonth", "DayOfWeek", "DayOfYear",
           "Quarter", "LastDay", "Hour", "Minute", "Second", "WeekDay"]
# column -> its type's name in both packages
TYPES = {"d": "date", "t": "timestamp", "i": "int", "l": "long",
         "x": "double", "b": "boolean"}
_PORT_TYPES = {t.name: t for t in (PT.DateType, PT.TimestampType,
                                   PT.IntegerType, PT.LongType,
                                   PT.DoubleType, PT.BooleanType,
                                   PT.StringType)}


def days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


EDGE_DAYS = [days(*ymd) for ymd in [
    (1900, 2, 28), (1900, 3, 1), (2000, 2, 28), (2000, 2, 29),
    (2000, 3, 1), (2100, 2, 28), (2100, 3, 1), (1600, 1, 1),
    (1600, 2, 29), (2400, 2, 29), (2400, 12, 31), (1969, 12, 31),
    (1970, 1, 1), (1970, 1, 2), (1999, 12, 31), (2000, 1, 1)]]


def table(seed: int = 16):
    """{column: (values, valid)} as numpy arrays, N rows; each column's
    first rows are its edge values, the rest drawn from the seed."""
    rng = np.random.default_rng(seed)
    lo, hi = days(1600, 1, 1), days(2400, 12, 31)
    d = rng.integers(lo, hi + 1, N).astype(np.int32)
    d[:len(EDGE_DAYS)] = EDGE_DAYS
    t = rng.integers(lo * _DAY_US, (hi + 1) * _DAY_US, N)
    t_edge = [-1, 0, 1, -_DAY_US, -_DAY_US + 1, _DAY_US - 1,
              days(1900, 3, 1) * _DAY_US - 1, days(2000, 2, 29) * _DAY_US,
              -2 ** 63, 2 ** 63 - 1]
    t[:len(t_edge)] = t_edge
    i = rng.integers(lo, hi + 1, N).astype(np.int32)
    i[:5] = [-2 ** 31, 2 ** 31 - 1, -1, 0, 1]
    lng = rng.integers(-2 ** 63, 2 ** 63 - 1, N, dtype=np.int64)
    lng[:6] = [-2 ** 63, 2 ** 63 - 1, -1, 0, 2 ** 40, -2 ** 40]
    x = rng.normal(0, 1e5, N)
    x[:8] = [np.nan, np.inf, -np.inf, 1e300, -1e300, -0.0, 0.5, -0.5]
    b = rng.random(N) < 0.5
    cols = {"d": d, "t": t, "i": i, "l": lng, "x": x, "b": b}
    return {k: (v, rng.random(N) >= 0.15) for k, v in cols.items()}


class _Given(Expression):
    """A child that hands back one given column."""

    def __init__(self, column: Column):
        self.column = column

    @property
    def dtype(self):
        return self.column.dtype

    def eval(self, batch):
        return self.column


def port_part(cls: str, data, name: str, device="cpu"):
    """(values, valid) of the port's `cls` over column `name`."""
    v, ok = data[name]
    c = Column(torch.from_numpy(np.where(ok, v, 0).astype(v.dtype))
               .to(device), torch.from_numpy(ok).to(device),
               _PORT_TYPES[TYPES[name]])
    out = getattr(PD, cls)(_Given(c)).eval(None)
    assert out.dtype is (PT.DateType if cls == "LastDay" else PT.IntegerType)
    return out.data.cpu().numpy(), out.valid.cpu().numpy()


def jax_part(cls: str, data, name: str):
    """The same through the JAX package's class."""
    import jax.numpy as jnp
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.columnar import Column as JColumn
    from spark_rapids_tpu.ops import datetime_exprs as JD
    from spark_rapids_tpu.ops.expressions import Expression as JExpression

    class _JaxGiven(JExpression):
        def __init__(self, column):
            self.column = column

        @property
        def dtype(self):
            return self.column.dtype

        def eval(self, batch):
            return self.column

    jtypes = {"date": JT.DateType, "timestamp": JT.TimestampType,
              "int": JT.IntegerType, "long": JT.LongType,
              "double": JT.DoubleType, "boolean": JT.BooleanType}
    v, ok = data[name]
    c = JColumn(jnp.asarray(np.where(ok, v, 0).astype(v.dtype)),
                jnp.asarray(ok), jtypes[TYPES[name]])
    out = getattr(JD, cls)(_JaxGiven(c)).eval(None)
    return np.asarray(out.data), np.asarray(out.valid)


@pytest.fixture(scope="module")
def data():
    return table()


def test_the_table_holds_what_the_cases_need(data):
    d, _ = data["d"]
    years = d.astype("datetime64[D]").astype("datetime64[Y]").astype(int)
    assert years.min() + 1970 == 1600 and years.max() + 1970 == 2400
    assert (d < 0).any() and set(EDGE_DAYS) <= set(d.tolist())
    t, _ = data["t"]
    assert (t < 0).sum() > N // 3 and -1 in t
    for name, (_, ok) in data.items():
        assert 0.1 < 1 - ok.mean() < 0.2, name


@pytest.mark.parametrize("name", list(TYPES))
@pytest.mark.parametrize("cls", CLASSES)
def test_date_part_equals_the_jax_class(cls, name, data):
    want, want_ok = jax_part(cls, data, name)
    got, got_ok = port_part(cls, data, name)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got_ok, want_ok) and np.array_equal(
        got_ok, data[name][1])
    bad = np.flatnonzero(got != want)
    assert not len(bad), (cls, name, data[name][0][bad[:4]], want[bad[:4]],
                          got[bad[:4]])


@pytest.mark.parametrize("fn", ["floordiv", "days_from_civil"])
def test_helper_no_class_reaches_equals_the_jax_module(fn):
    """The two helpers that no date part calls, on negative operands and
    days before 1970, against the JAX module's."""
    import jax.numpy as jnp
    from spark_rapids_tpu.ops import datetime_utils as JU
    from spark_rapids_tpu_torch.ops import datetime_utils as PU
    rng = np.random.default_rng(16)
    if fn == "floordiv":
        a = rng.integers(-10**6, 10**6, 4096, dtype=np.int64)
        for b in (12, 7, -5):
            got = PU.floordiv(torch.from_numpy(a), b).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(JU.floordiv(jnp.asarray(a), b)))
        return
    y = rng.integers(1600, 2401, 4096).astype(np.int32)
    m = rng.integers(1, 13, 4096).astype(np.int32)
    d = rng.integers(1, 29, 4096).astype(np.int32)
    got = PU.days_from_civil(*(torch.from_numpy(x) for x in (y, m, d)))
    want = np.asarray(JU.days_from_civil(*(jnp.asarray(x) for x in (y, m, d))))
    assert got.dtype == torch.int32 and (want < 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_fields_of_known_days(data):
    """The port's fields of the edge days against Python's calendar."""
    d = np.array(EDGE_DAYS, dtype=np.int32)
    col = Column(torch.from_numpy(d), torch.ones(len(d), dtype=torch.bool),
                 PT.DateType)

    def part(cls):
        return getattr(PD, cls)(_Given(col)).eval(None).data.tolist()
    dates = [_EPOCH + datetime.timedelta(days=int(x)) for x in d]
    assert part("Year") == [x.year for x in dates]
    assert part("Month") == [x.month for x in dates]
    assert part("DayOfMonth") == [x.day for x in dates]
    assert part("DayOfYear") == [x.timetuple().tm_yday for x in dates]
    # Spark: 1 = Sunday; weekday(): 0 = Monday
    assert part("DayOfWeek") == [(x.weekday() + 1) % 7 + 1 for x in dates]
    assert part("WeekDay") == [x.weekday() for x in dates]
    assert part("Quarter") == [(x.month - 1) // 3 + 1 for x in dates]
    nxt = [datetime.date(x.year + x.month // 12, x.month % 12 + 1, 1)
           for x in dates]
    assert part("LastDay") == [days(y.year, y.month, y.day) - 1
                               for y in nxt]


def test_hour_of_a_date_reads_its_days_as_microseconds(data):
    """The JAX package's Hour, Minute and Second read a date child's data
    as microseconds: day -1 (1969-12-31) is the last microsecond before
    the epoch, 23:59:59, and every later date is 00:00:00.  The port
    keeps the quirk."""
    v = np.array([-1, 0, 1, days(2000, 2, 29), days(1900, 3, 1)], np.int32)
    given = {"d": (v, np.ones(len(v), bool))}
    for cls, want in (("Hour", [23, 0, 0, 0, 23]),
                      ("Minute", [59, 0, 0, 0, 59]),
                      ("Second", [59, 0, 0, 0, 59])):
        got, _ = port_part(cls, given, "d")
        assert got.tolist() == want == jax_part(cls, given, "d")[0].tolist()


def test_day_of_year_subtracts_in_the_child_type():
    """The JAX package's DayOfYear takes the day less its year's first day
    in the child's type, not in int64 as its other fields read the day:
    over a double column the difference is a double, cast to int32 last,
    so -0.5 (a day of 1970) gives day 0, NaN 0 and 1e300 the int32
    maximum, where the same days truncated into a long column give 1, 1
    and a wrapped field.  The port keeps the quirk."""
    x = np.array([0.5, -0.5, 59.9, np.nan, 1e300])
    ok = np.ones(len(x), bool)
    given = {"x": (x, ok), "l": (np.array([0, 0, 59, 0, 2 ** 63 - 1]), ok)}
    as_double, as_long = (port_part("DayOfYear", given, c)[0]
                          for c in "xl")
    assert as_double.tolist() == jax_part("DayOfYear", given, "x")[0] \
        .tolist() == [1, 0, 60, 0, 2 ** 31 - 1]
    assert as_long.tolist() == jax_part("DayOfYear", given, "l")[0].tolist()
    assert as_long[:4].tolist() == [1, 1, 60, 1] and as_long[4] != 2 ** 31 - 1


# --------------------------------------------------------------------------
# the DSL, through both packages' sessions
# --------------------------------------------------------------------------

def port_df(session, data):
    schema = PT.Schema([PT.StructField(n, _PORT_TYPES[TYPES[n]])
                        for n in data])
    return session.from_numpy(
        {n: np.ma.masked_array(v, mask=~ok) for n, (v, ok) in data.items()},
        schema)


def _jax_df(data):
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    jtypes = {t.name: t for t in (JT.DateType, JT.TimestampType,
                                  JT.IntegerType, JT.LongType,
                                  JT.DoubleType, JT.BooleanType)}
    schema = JT.Schema([JT.StructField(n, jtypes[TYPES[n]]) for n in data])
    return JaxSession({}).from_pydict(
        {n: [x if ok else None for x, ok in zip(v.tolist(), valid)]
         for n, (v, valid) in data.items()}, schema)


class Api:
    """One package's DSL, so one case builds the same tree in both."""

    def __init__(self, logical):
        self.col, self.lit, self.F = logical.col, logical.lit, \
            logical.functions
        self.E = logical.ColumnExpr


PORT = Api(PL)


def _jax_api():
    from spark_rapids_tpu.plan import logical as JL
    return Api(JL)


_DSL = ["year", "month", "dayofmonth", "hour", "minute", "second"]


def dsl_select(a):
    """Every DSL date part of the date and the timestamp column."""
    return [getattr(a.F, f)(a.col(c)).alias(f"{f}_{c}") for f in _DSL
            for c in ("d", "t")]


def dsl_grouped(a, df):
    """Rows per year and quarter of `d` before 2000, with the latest hour
    of `t`."""
    return (df.with_column("y", a.F.year(a.col("d")))
            .with_column("h", a.F.hour(a.col("t")))
            .filter(a.col("y") < 2000)
            .group_by(a.col("y"), a.E("Quarter", (a.col("d"),)).alias("q"))
            .agg(a.F.count(a.lit(1)).alias("n"),
                 a.F.max(a.col("h")).alias("h"))
            .order_by("y", "q"))


@pytest.fixture(scope="module")
def dsl_data(data):
    return {k: data[k] for k in ("d", "t")}


def test_dsl_date_parts_equal_the_jax_package(dsl_data):
    want = _jax_df(dsl_data).select(*dsl_select(_jax_api())).collect()
    got = port_df(TpuSession(device="cpu"), dsl_data).select(
        *dsl_select(PORT)).collect()
    assert len(got) == N and got == want


def test_dsl_with_column_and_group_by_equal_the_jax_package(dsl_data):
    want = dsl_grouped(_jax_api(), _jax_df(dsl_data)).collect()
    got = dsl_grouped(PORT, port_df(TpuSession(device="cpu"),
                                    dsl_data)).collect()
    assert len(got) > 100 and got == want


@pytest.mark.parametrize("op", ["Year", "Month", "DayOfMonth", "DayOfWeek",
                                "DayOfYear", "Quarter", "LastDay", "Hour",
                                "Minute", "Second"])
def test_a_string_child_raises_at_planning(op):
    """The JAX package fails when it collects a date part of a string
    column (its byte matrix has no field); the port raises
    NotImplementedError when the plan is made."""
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    from spark_rapids_tpu.plan import logical as JL
    s = np.array(["1994-08-23", "x"])
    with pytest.raises(Exception):
        JaxSession({}).from_pydict({"s": s.tolist()}).select(
            JL.ColumnExpr(op, (JL.col("s"),)).alias("x")).to_arrow()
    df = TpuSession(device="cpu").from_numpy({"s": s})
    with pytest.raises(NotImplementedError, match="string column"):
        df.select(PL.ColumnExpr(op, (PL.col("s"),)).alias("x")) \
            .physical_plan()


def test_date_arithmetic_and_weekday_do_not_resolve():
    """The ops with no op name in either package do not resolve: WeekDay,
    and ToUnixTimestamp of the date arithmetic; the port raises at
    planning time, the JAX package at analysis.  The rest of the date
    arithmetic resolves by its op name (tests/test_torch_datetime_arith.py
    holds it to the JAX package), DateAdd here among them."""
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    from spark_rapids_tpu.plan import logical as JL
    from spark_rapids_tpu.plan.analysis import AnalysisError
    from spark_rapids_tpu import types as JT
    df = TpuSession(device="cpu").from_numpy(
        {"d": np.array([1, 2], np.int32)},
        PT.Schema([PT.StructField("d", PT.DateType)]))
    jdf = JaxSession({}).from_pydict(
        {"d": [1, 2]}, JT.Schema([JT.StructField("d", JT.DateType)]))
    for op in ("ToUnixTimestamp", "WeekDay"):
        with pytest.raises(NotImplementedError, match=op):
            df.select(PL.ColumnExpr(op, (PL.col("d"),)).alias("x")) \
                .physical_plan()
        with pytest.raises(AnalysisError, match=op):
            jdf.select(JL.ColumnExpr(op, (JL.col("d"),)).alias("x")) \
                .to_arrow()
    got = df.select(PL.ColumnExpr("DateAdd", (PL.col("d"), PL.lit(1)))
                    .alias("x")).collect()
    assert got == [(datetime.date(1970, 1, 3),), (datetime.date(1970, 1, 4),)]
