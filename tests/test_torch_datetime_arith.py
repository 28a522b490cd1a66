"""The port's date and time arithmetic (DateAdd, DateSub, DateDiff,
UnixTimestamp, ToUnixTimestamp, FromUnixTime, TimeAdd, TimeSub,
AddMonths, MonthsBetween, TruncDate and NextDay of
spark_rapids_tpu_torch/ops/datetime_exprs.py) against the JAX package's
classes, value for value and null for null, through the DSL, and in the
two queries of `tpch.DATE_QUERIES`.

The table is tests/test_torch_cast.py's (dates and timestamps of
1600-2400 with their edges, seconds, int, short, byte, double, float and
boolean columns, text) with a second date and timestamp column, month
counts of +-1200 with the int32 extremes, and long day counts beyond
int32.  Each case evaluates one class directly in both packages over the
same columns; the results must have the same null mask and the same
value at every row, null slots too (text: bytes up to each length, and
the lengths).  The JAX package's quirks the port keeps are each pinned
by a test of their own.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.ops import datetime_exprs as JD
from spark_rapids_tpu.ops.expressions import Literal as JLiteral
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu_torch import TpuSession, tpch
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import Column
from spark_rapids_tpu_torch.ops import datetime_exprs as PD
from spark_rapids_tpu_torch.ops.expressions import Literal
from spark_rapids_tpu_torch.plan import logical as PL

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from compare import assert_rows_equal  # noqa: E402
from test_torch_cast import (DAY_US, N, TYPES, Given, JaxGiven,  # noqa: E402
                             assert_same, columns, days, jax_df, port_df)
from test_torch_cast import table as cast_table  # noqa: E402

ARITH_TYPES = dict(TYPES, d2="date", t2="timestamp", mo="int", kl="long")


def table(seed: int = 19):
    """The cast table plus `d2`, `t2`, month counts `mo` and long day
    counts `kl`, with their edges first."""
    out = cast_table(seed)
    rng = np.random.default_rng([seed, 1])
    lo, hi = days(1600, 1, 1), days(2400, 12, 31)
    d2 = rng.integers(lo, hi + 1, N).astype(np.int32)
    d2[:4] = [days(2000, 2, 29), days(1900, 2, 28), days(1970, 1, 31),
              days(1969, 12, 31)]
    t2 = rng.integers(lo * DAY_US, (hi + 1) * DAY_US, N)
    mo = rng.integers(-1200, 1201, N).astype(np.int32)
    mo[:8] = [-2 ** 31, 2 ** 31 - 1, 0, 1, -1, 12, -13, 178_956_971]
    kl = rng.integers(-2 ** 40, 2 ** 40, N)
    kl[:6] = [2 ** 31, 2 ** 32 + 5, -2 ** 31 - 1, -2 ** 63, 2 ** 63 - 1, 1]
    for k, v in (("d2", d2), ("t2", t2), ("mo", mo), ("kl", kl)):
        out[k] = (v, rng.random(N) >= 0.15)
    return out


@pytest.fixture(scope="module")
def data():
    return table()


def _arg(spec, data, package):
    """A case's argument in one package: a column name or ("lit", v)."""
    if isinstance(spec, tuple):
        return (Literal if package == "port" else JLiteral)(spec[1])
    pc, jc = columns(data, spec, ARITH_TYPES)
    return Given(pc) if package == "port" else JaxGiven(jc)


# id -> (class name, argument specs)
CASES = {
    "DateAdd-int": ("DateAdd", ("d", "i")),
    "DateAdd-long": ("DateAdd", ("d", "kl")),
    "DateAdd-short": ("DateAdd", ("d", "s16")),
    "DateAdd-byte": ("DateAdd", ("d", "i8")),
    "DateAdd-boolean": ("DateAdd", ("d", "b")),
    "DateAdd-double": ("DateAdd", ("d", "x")),
    "DateAdd-timestamp": ("DateAdd", ("t", "i")),
    "DateSub-int": ("DateSub", ("d", "i")),
    "DateSub-long": ("DateSub", ("d", "kl")),
    "DateDiff-dates": ("DateDiff", ("d", "d2")),
    "DateDiff-timestamp-date": ("DateDiff", ("t", "d")),
    "DateDiff-date-timestamp": ("DateDiff", ("d", "t2")),
    "DateDiff-timestamps": ("DateDiff", ("t", "t2")),
    "DateDiff-long": ("DateDiff", ("d", "l")),
    "UnixTimestamp-timestamp": ("UnixTimestamp", ("t",)),
    "UnixTimestamp-date": ("UnixTimestamp", ("d",)),
    "UnixTimestamp-fmt": ("UnixTimestamp", ("t", ("lit", "yyyy"))),
    "ToUnixTimestamp": ("ToUnixTimestamp", ("t",)),
    "FromUnixTime-long": ("FromUnixTime", ("l",)),
    "FromUnixTime-int": ("FromUnixTime", ("i",)),
    "FromUnixTime-double": ("FromUnixTime", ("x",)),
    "FromUnixTime-fmt": ("FromUnixTime", ("l", ("lit", "yyyy"))),
    "TimeAdd-long": ("TimeAdd", ("t", "kl")),
    "TimeAdd-int": ("TimeAdd", ("t", "i")),
    "TimeAdd-double": ("TimeAdd", ("t", "x")),
    "TimeAdd-date": ("TimeAdd", ("d", "kl")),
    "TimeSub-long": ("TimeSub", ("t", "kl")),
    "AddMonths-months": ("AddMonths", ("d", "mo")),
    "AddMonths-int": ("AddMonths", ("d", "i")),
    "AddMonths-long": ("AddMonths", ("d", "kl")),
    "AddMonths-timestamp": ("AddMonths", ("t", "mo")),
    "MonthsBetween-dates": ("MonthsBetween", ("d", "d2")),
    "MonthsBetween-timestamps": ("MonthsBetween", ("t", "t2")),
    "MonthsBetween-date-timestamp": ("MonthsBetween", ("d", "t2")),
    "MonthsBetween-no-round": ("MonthsBetween",
                               ("d", "d2", ("lit", False))),
    "MonthsBetween-column-round": ("MonthsBetween", ("d", "d2", "b")),
    "TruncDate-timestamp": ("TruncDate", ("t", ("lit", "month"))),
    "NextDay-timestamp": ("NextDay", ("t", ("lit", "MO"))),
}
CASES.update({f"TruncDate-{f}": ("TruncDate", ("d", ("lit", f)))
              for f in ("year", "yyyy", "yy", "quarter", "month", "mon",
                        "mm", "week", "MONTH", "day")})
CASES.update({f"NextDay-{d.strip()}": ("NextDay", ("d", ("lit", d)))
              for d in ("MO", "tue", "Wednesday", " th ", "FRI", "sa",
                        "SUNDAY", "xyz")})


def evaluate(case: str, data):
    """(port Column, JAX Column) of CASES[case]."""
    cls, specs = CASES[case]
    got = getattr(PD, cls)(*[_arg(s, data, "port") for s in specs]) \
        .eval(None)
    want = getattr(JD, cls)(*[_arg(s, data, "jax") for s in specs]) \
        .eval(None)
    return got, want


@pytest.mark.parametrize("case", list(CASES))
def test_class_equals_the_jax_class(case, data):
    got, want = evaluate(case, data)
    assert_same(got, want)


# --------------------------------------------------------------------------
# the JAX package's behaviour the port keeps, each pinned
# --------------------------------------------------------------------------

def _given(values, dtype, package):
    v = np.asarray(values)
    ok = np.ones(len(v), bool)
    if package == "port":
        return Given(Column(torch.from_numpy(v), torch.from_numpy(ok),
                            PT.TYPES_BY_NAME[dtype]))
    return JaxGiven(JColumn(jnp.asarray(v), jnp.asarray(ok),
                            getattr(JT, {"date": "DateType",
                                         "timestamp": "TimestampType",
                                         "long": "LongType",
                                         "int": "IntegerType"}[dtype])))


def _both(cls, *args):
    """The values of `cls` over `args` ((values, type name) or a
    Literal's value) in the port and in the JAX package, as lists."""
    out = []
    for package, mod, lit in (("port", PD, Literal), ("jax", JD, JLiteral)):
        built = [_given(*a, package) if isinstance(a, tuple) else lit(a)
                 for a in args]
        c = getattr(mod, cls)(*built).eval(None)
        vals = np.asarray(c.data if package == "jax" else c.data.numpy())
        if c.dtype.name == "string":
            lens = np.asarray(c.lengths if package == "jax"
                              else c.lengths.numpy())
            vals = [bytes(r[:n]).decode() for r, n in zip(vals, lens)]
        else:
            vals = vals.tolist()
        ok = np.asarray(c.valid if package == "jax" else c.valid.numpy())
        out.append([v if o else None for v, o in zip(vals, ok)])
    return out


def test_date_add_and_date_sub_wrap_a_long_day_count_to_int32():
    """Both sides are cast to int32 before adding: 2^32 + 5 days is 5."""
    day = days(1994, 7, 23)
    for cls, sign in (("DateAdd", 1), ("DateSub", -1)):
        got, want = _both(cls, ([day] * 3, "date"),
                          (np.array([2 ** 32 + 5, 2 ** 31, 5]), "long"))
        assert got == want == [day + sign * 5,
                               (day + sign * 2 ** 31 + 2 ** 31) % 2 ** 32
                               - 2 ** 31, day + sign * 5]


def test_datediff_floors_a_timestamp_to_its_day_before_1970():
    """A timestamp side is taken to its day with a floor: a microsecond
    before the epoch is day -1."""
    got, want = _both("DateDiff", (np.array([-1, 0, -DAY_US]), "timestamp"),
                      (np.zeros(3, np.int32), "date"))
    assert got == want == [-1, 0, -1]


def test_unix_timestamp_ignores_its_format():
    """Floor to seconds for a timestamp, days x 86400 for a date; the
    format literal changes nothing."""
    for fmt in (None, "yyyy-MM", "HH"):
        extra = () if fmt is None else (fmt,)
        got, want = _both("UnixTimestamp",
                          (np.array([-1, 1_500_000, -1_500_000]),
                           "timestamp"), *extra)
        assert got == want == [-1, 1, -2]
        got, want = _both("UnixTimestamp", (np.array([-1, 1], np.int32),
                                            "date"), *extra)
        assert got == want == [-86400, 86400]


def test_from_unixtime_ignores_its_format():
    for fmt in (None, "yyyy", "dd/MM/yyyy"):
        extra = () if fmt is None else (fmt,)
        got, want = _both("FromUnixTime", (np.array([0, -1, 86399]), "long"),
                          *extra)
        assert got == want == ["1970-01-01 00:00:00", "1969-12-31 23:59:59",
                               "1970-01-01 23:59:59"]


def test_months_between_truncates_timestamps_to_their_day():
    """The time of day is dropped (Spark keeps it): 1994-03-15 23:00
    against 1994-02-15 01:00 is exactly one month."""
    a = days(1994, 3, 15) * DAY_US + 23 * 3_600_000_000
    b = days(1994, 2, 15) * DAY_US + 3_600_000_000
    got, want = _both("MonthsBetween", (np.array([a]), "timestamp"),
                      (np.array([b]), "timestamp"))
    assert got == want == [1.0]


def test_months_between_rounds_only_for_a_literal_true():
    a = np.array([days(1994, 3, 1)], np.int32)
    b = np.array([days(1994, 2, 2)], np.int32)
    exact = 1 - 1 / 31
    for round_off, want_value in ((True, round(exact, 8)), (False, exact),
                                  (None, round(exact, 8))):
        extra = () if round_off is None else (round_off,)
        got, want = _both("MonthsBetween", (a, "date"), (b, "date"), *extra)
        assert got == want == [want_value]
    # a column round_off is no literal: no rounding
    got, want = _both("MonthsBetween", (a, "date"), (b, "date"),
                      (np.array([1], np.int32), "int"))
    assert got == want == [exact]


def test_an_unknown_format_or_day_gives_nulls():
    d = (np.array([days(1994, 7, 23)], np.int32), "date")
    for cls, arg in (("TruncDate", "day"), ("TruncDate", "hour"),
                     ("NextDay", "xyz"), ("NextDay", "")):
        got, want = _both(cls, d, arg)
        assert got == want == [None]


def test_trunc_and_next_day_read_a_timestamp_as_days():
    """TruncDate and NextDay read their child's data as days, a
    timestamp's microseconds too (where Spark would take its date)."""
    t = np.array([days(1994, 7, 23) * DAY_US, 40, -3])
    got, want = _both("TruncDate", (t, "timestamp"), "month")
    as_days = _both("TruncDate", (t, "long"), "month")
    assert got == want and got[1:] == as_days[0][1:] == [
        days(1970, 2, 1), days(1969, 12, 1)]
    got, want = _both("NextDay", (t, "timestamp"), "MO")
    assert got == want and got[1:] == [days(1970, 2, 16),
                                       days(1970, 1, 5)]


@pytest.mark.parametrize("op", ["TruncDate", "NextDay"])
def test_trunc_and_next_day_need_a_string_literal(op, data):
    """The JAX package runs a format or day that is not a string literal
    on its CPU executor (device_supported is false); the port, which has
    none, raises when the plan is made."""
    assert not getattr(JD, op)(_arg("d", data, "jax"),
                               _arg("ds", data, "jax")).device_supported()
    df = port_df(TpuSession(device="cpu"),
                 {"d": data["d"], "ds": data["ds"]})
    for arg in (PL.col("ds"), PL.lit(3)):
        with pytest.raises(NotImplementedError, match="string literal"):
            df.select(PL.ColumnExpr(op, (PL.col("d"), arg)).alias("x")) \
                .physical_plan()


@pytest.mark.parametrize("op,args", [
    ("DateAdd", ("ds", 1)), ("DateSub", ("ds", 1)),
    ("DateDiff", ("d", "ds")), ("AddMonths", ("ds", 1)),
    ("MonthsBetween", ("ds", "d")), ("TruncDate", ("ds", "month")),
    ("NextDay", ("ds", "MO")), ("FromUnixTime", ("ds",)),
    ("TimeAdd", ("ds", 1))], ids=lambda v: v if isinstance(v, str) else "")
def test_a_string_child_raises_at_planning(op, args, data):
    """The JAX package fails when it evaluates these over a string
    column (a byte matrix holds no days); the port raises
    NotImplementedError when the plan is made."""
    def build(a):
        return a.ColumnExpr(op, tuple(
            a.col(x) if x in ("d", "ds") else a.lit(x)
            for x in args)).alias("x")
    two = {k: (data[k][0][16:20], np.ones(4, bool)) for k in ("d", "ds")}
    with pytest.raises(Exception):
        jax_df(two, types=ARITH_TYPES).select(build(JL)).to_arrow()
    df = port_df(TpuSession(device="cpu"), two, ARITH_TYPES)
    with pytest.raises(NotImplementedError, match="string column"):
        df.select(build(PL)).physical_plan()


# --------------------------------------------------------------------------
# the DSL, through both packages' sessions
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dsl_data(data):
    """Dates, timestamps, seconds and day and month counts whose results
    all have a Python value (no year past 9999)."""
    lo, hi = days(1600, 1, 1), days(2400, 12, 31)
    rng = np.random.default_rng(20)
    n = 1024
    return {"d": (rng.integers(lo, hi, n).astype(np.int32),
                  rng.random(n) > 0.1),
            "d2": (rng.integers(lo, hi, n).astype(np.int32),
                   rng.random(n) > 0.1),
            "t": (rng.integers(lo * DAY_US, hi * DAY_US, n),
                  rng.random(n) > 0.1),
            "i": (rng.integers(-50_000, 50_000, n).astype(np.int32),
                  rng.random(n) > 0.1),
            "mo": (rng.integers(-1200, 1201, n).astype(np.int32),
                   rng.random(n) > 0.1),
            "l": (rng.integers(lo * 86_400, hi * 86_400, n),
                  rng.random(n) > 0.1)}


def _frames(dsl_data):
    return (jax_df(dsl_data, types=ARITH_TYPES),
            port_df(TpuSession(device="cpu"), dsl_data, ARITH_TYPES))


def dsl_select(L):
    F, c, E = L.functions, L.col, L.ColumnExpr
    return [F.date_add(c("d"), c("i")).alias("add"),
            F.date_sub(c("d"), 30).alias("sub"),
            F.datediff(c("d"), c("d2")).alias("diff"),
            F.add_months(c("d"), c("mo")).alias("months"),
            F.months_between(c("d"), c("d2")).alias("between"),
            F.months_between(c("t"), c("d"), False).alias("between_raw"),
            F.trunc(c("d"), "quarter").alias("quarter"),
            F.next_day(c("d"), "fri").alias("friday"),
            E("UnixTimestamp", (c("t"),)).alias("unix"),
            E("FromUnixTime", (c("l"),)).alias("text"),
            E("TimeAdd", (c("t"), c("l"))).alias("later"),
            E("TimeSub", (c("t"), L.lit(86_400_000_000))).alias("earlier")]


def test_dsl_select_equals_the_jax_package(dsl_data):
    jdf, pdf = _frames(dsl_data)
    want = jdf.select(*dsl_select(JL)).collect()
    got = pdf.select(*dsl_select(PL)).collect()
    # under tests/compare.py: the JAX package's compiled stage divides by
    # 1e8 in MonthsBetween's rounding as a product with the reciprocal,
    # its eager class (test_class_equals_the_jax_class) and the port as
    # a division, a last-bit difference
    assert len(got) == 1024
    assert_rows_equal(want, got, ignore_order=False)


def dsl_filtered(L, df):
    F, c = L.functions, L.col
    return (df.filter((F.datediff(c("d"), c("d2")) > 1000)
                      & (F.trunc(c("d"), "year") >= "2000-01-01")
                      & (F.add_months(c("d"), c("mo")) > c("d2")))
            .select(c("d"), c("d2"), F.next_day(c("d2"), "MO").alias("n")))


def test_dsl_filter_equals_the_jax_package(dsl_data):
    jdf, pdf = _frames(dsl_data)
    want = dsl_filtered(JL, jdf).collect()
    got = dsl_filtered(PL, pdf).collect()
    assert len(got) > 20
    assert_rows_equal(want, got, ignore_order=False)


def dsl_grouped(L, df):
    F, c = L.functions, L.col
    return (df.group_by(F.trunc(c("d"), "year").alias("year"))
            .agg(F.count(L.lit(1)).alias("n"),
                 F.sum(F.datediff(c("d2"), c("d"))).alias("days"),
                 F.min(F.next_day(c("d"), "SU")).alias("first_sunday"),
                 F.max(F.date_add(c("d"), 7)).alias("last_week"))
            .order_by("year"))


def test_dsl_group_by_agg_equals_the_jax_package(dsl_data):
    jdf, pdf = _frames(dsl_data)
    want = dsl_grouped(JL, jdf).collect()
    got = dsl_grouped(PL, pdf).collect()
    assert len(got) > 500
    assert_rows_equal(want, got, ignore_order=False)


# --------------------------------------------------------------------------
# tpch.DATE_QUERIES
# --------------------------------------------------------------------------

def _jax_date_query(name, li):
    """tpch.DATE_QUERIES[name] written in the JAX package's DSL."""
    F, col, lit = JL.functions, JL.col, JL.lit
    if name == "q6_text":
        shipped = F.to_date(col("l_shiptext"))
        return (li.with_column("l_shiptext",
                               col("l_shipdate").cast("string"))
                .filter((shipped >= "1994-01-01")
                        & (shipped < "1995-01-01")
                        & col("l_discount").between(0.05, 0.07)
                        & (col("l_quantity") < 24))
                .agg(F.sum(col("l_extendedprice") * col("l_discount"))
                     .alias("revenue")))
    ship, commit = col("l_shipdate"), col("l_commitdate")
    receipt = col("l_receiptdate")
    return (li.group_by(F.trunc(ship, "month").alias("month"))
            .agg(F.count(lit(1)).alias("lines"),
                 F.sum(F.datediff(receipt, ship)).alias("transit_days"),
                 F.sum(F.datediff(receipt, commit)).alias("days_late"),
                 F.sum(F.when(receipt > F.date_add(commit, 14), 1)
                       .otherwise(0)).alias("late_over_14"),
                 F.min(F.next_day(ship, "MO")).alias("first_monday"))
            .order_by("month"))


_CONF = {"spark.rapids.sql.variableFloatAgg.enabled": "true"}


def test_date_queries_rows_equal_the_jax_package():
    """At SF0.01 of the JAX package's generator, both packages' rows of
    each of tpch.DATE_QUERIES."""
    from benchmarks.tpch import generate, load_tables
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    jli = load_tables(JaxSession(dict(_CONF)), sf=0.01)["lineitem"]
    li = generate(0.01)["lineitem"]
    t = {f.name: (np.array(li[f.name], dtype=str) if f.dtype.is_string
                  else np.array(li[f.name], dtype=f.dtype.np_dtype))
         for f in tpch.LINEITEM}
    pli = TpuSession(dict(_CONF), device="cpu").from_numpy(t, tpch.LINEITEM)
    for name, rows in (("ship_delay", 79), ("q6_text", 1)):
        want = _jax_date_query(name, jli).collect()
        got = tpch.DATE_QUERIES[name](pli).collect()
        assert len(got) == rows
        assert_rows_equal(want, got, ignore_order=False)


@pytest.mark.parametrize("name", list(tpch.DATE_QUERIES))
def test_date_query_matches_the_numpy_oracle(name):
    """The port's own generator and oracle (what chip_smoke.py runs at
    SF10), over several batches."""
    t = tpch.generate_lineitem(0.004)
    s = TpuSession(dict(_CONF, **{
        "spark.rapids.sql.reader.batchSizeRows": "3000"}), device="cpu")
    got = tpch.DATE_QUERIES[name](s.from_numpy(t, tpch.LINEITEM)).collect()
    assert got and tpch.rows_match(tpch.ORACLES[name](t), got)
