"""The port's casts to and from dates and timestamps
(spark_rapids_tpu_torch/ops/cast.py) against the JAX package's, value
for value and null for null, and the planner's use of them.

One seeded numpy table of 4096 rows: dates over 1600-2400 with the leap
days and years past 9999 and before 0 among them, timestamps over the
same years with the int64 extremes, seconds as long, double (NaN, +-inf,
values past the int64 range of microseconds) and float, int, short, byte
and boolean columns, and text: the dates and timestamps formatted, with
a share of rows made malformed (Feb 30, month 13, single-digit parts,
bytes <= 0x20 and other bytes around them, letters, extra dashes, other
time separators, no-break and full-width characters).  About 15% of
every column is null.  Each route runs the same input through the JAX
package's function and the port's, evaluated directly; the results must
have the same null mask and, at every row (null slots too), the same
value, or for text the same bytes up to each row's length and the same
lengths.

Step 0's case: the port folded a string literal compared with a date
through Python's `strip()` and a `\\d` regex, both of which accept
Unicode, where the JAX package's cast trims only bytes <= 0x20 and reads
ASCII digits; `test_a_string_literal_compared_with_a_date_gives_the_jax_rows`
holds the fold to the JAX package's rows for each string of
FOLD_STRINGS.
"""
import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.engine import TpuSession as JaxSession
from spark_rapids_tpu.ops import cast as JC
from spark_rapids_tpu.ops.expressions import Expression as JExpression
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu_torch import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import Column
from spark_rapids_tpu_torch.ops import cast as PC
from spark_rapids_tpu_torch.ops.expressions import Expression
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.plan.analysis import AnalysisError

N = 4096
_EPOCH = datetime.date(1970, 1, 1)
DAY_US = 86_400_000_000
TS_KEY = "spark.rapids.sql.castStringToTimestamp.enabled"
# column -> its type's name in both packages
TYPES = {"d": "date", "t": "timestamp", "l": "long", "i": "int",
         "s16": "short", "i8": "byte", "x": "double", "f": "float",
         "b": "boolean", "ds": "string", "ts": "string"}
JAX_TYPES = {t.name: t for t in (
    JT.DateType, JT.TimestampType, JT.LongType, JT.IntegerType,
    JT.ShortType, JT.ByteType, JT.DoubleType, JT.FloatType, JT.BooleanType,
    JT.StringType)}
# the routes the port has besides numeric -> numeric: (source column,
# target type)
ROUTES = [("d", "timestamp"), ("t", "date"), ("t", "long"),
          ("l", "timestamp"), ("i", "timestamp"), ("s16", "timestamp"),
          ("i8", "timestamp"), ("t", "double"), ("t", "float"),
          ("x", "timestamp"), ("f", "timestamp"), ("b", "timestamp"),
          ("i", "date"), ("s16", "date"), ("d", "int"), ("d", "long"),
          ("ds", "date"), ("ts", "timestamp"), ("d", "string"),
          ("t", "string")]
# the JAX package's routes that stay unported: none
UNPORTED = set()
FLOAT_KEY = "spark.rapids.sql.castStringToFloat.enabled"

# step 0: strings compared with a date column holding 1994-07-23
FOLD_STRINGS = {
    "plain": "1994-07-23", "fullwidth-digits": "１９９４-07-23",
    "trailing-nbsp": "1994-07-23\xa0", "leading-nbsp": "\xa01994-07-23",
    "ideographic-space": "1994-07-23　",
    "trailing-space": "1994-07-23 ", "leading-tab": "\t1994-07-23",
    "single-digit-month": "1994-7-23 ", "feb-30": "1994-02-30",
    "plus-sign": "+1994-07-23"}


def days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


EDGE_DAYS = [days(*ymd) for ymd in [
    (1900, 2, 28), (1900, 3, 1), (2000, 2, 29), (1600, 2, 29),
    (2400, 2, 29), (1969, 12, 31), (1970, 1, 1), (1994, 7, 23)]] + [
    3_000_000, -800_000, 2 ** 31 - 1, -2 ** 31]


def _bad_dates(s: str) -> list:
    """Malformed or edge forms of one `yyyy-MM-dd` text."""
    y, m, d = s[:4], s[5:7], s[8:10]
    return [f"{y}-02-30", f"{y}-13-{d}", f"{y}-{int(m)}-{int(d)}",
            f" \t{s}\n\x0b", f"\x00{s}\x00", f"{s[:8]}x{s[9:]}",
            f"{y}-{m}--{d}", f"{s}-", f"{y}{m}{d}", f"+{s}", f"-{s}",
            f"{s}\xa0", f"１{s[1:]}", f"{s} 12:34:56", f"{y}-{m}", "",
            "   ", f"0{s}", f"{y[1:]}-{m}-{d}", f"{s} ", f"{y}-0{m}-{d}"]


def _bad_stamps(s: str) -> list:
    """Malformed or edge forms of one `yyyy-MM-dd HH:mm:ss` text."""
    date, time = s[:10], s[11:]
    return [f"{date}", f"{date} {time[:2]}x{time[3:5]}y{time[6:]}",
            f"{date} 24:00:00", f"{date} {time[:5]}", f"{date}  {time}",
            f"{date}\t{time}", f"\t{date}\t {time} ", f"{date} {time}0",
            f"{date} {time[:2]}:6{time[4:]}", f"{date} 1:{time[3:]}",
            f"{date}T{time}", f"{date} {time[:7]}x",
            f"{date[:5]}13{date[7:]} {time}", f"{date} {time}\xa0"]


def table(seed: int = 18):
    """{column: (values, valid)} as numpy arrays, N rows; each column's
    first rows are its edge values, the rest drawn from the seed."""
    rng = np.random.default_rng(seed)
    lo, hi = days(1600, 1, 1), days(2400, 12, 31)
    d = rng.integers(lo, hi + 1, N).astype(np.int32)
    d[:len(EDGE_DAYS)] = EDGE_DAYS
    t = rng.integers(lo * DAY_US, (hi + 1) * DAY_US, N)
    t[:8] = [-1, 0, 1, -DAY_US, DAY_US - 1, -DAY_US + 1, -2 ** 63,
             2 ** 63 - 1]
    sec = rng.integers(lo * 86_400, (hi + 1) * 86_400, N)
    lng = sec.copy()
    lng[:5] = [-2 ** 63, 2 ** 63 - 1, -1, 0, 10 ** 13]
    i = rng.integers(lo, hi + 1, N).astype(np.int32)
    i[:4] = [-2 ** 31, 2 ** 31 - 1, -1, 0]
    x = sec + rng.random(N)
    x[:10] = [np.nan, np.inf, -np.inf, 1e300, -1e300, -0.5, 0.5, 9.3e12,
              -9.3e12, -0.0]
    f = (sec + rng.random(N)).astype(np.float32)
    f[:4] = [np.nan, np.inf, -1e20, 0.25]
    dates = np.datetime_as_string(
        rng.integers(lo, hi + 1, N).astype("datetime64[D]")).astype(object)
    stamps = np.char.replace(np.datetime_as_string(
        rng.integers(lo * 86_400, (hi + 1) * 86_400, N)
        .astype("datetime64[s]")), "T", " ").astype(object)
    for col, bad in ((dates, _bad_dates), (stamps, _bad_stamps)):
        rows = np.flatnonzero(rng.random(N) < 0.3)
        for r in rows:
            forms = bad(col[r])
            col[r] = forms[rng.integers(0, len(forms))]
    dates[:len(FOLD_STRINGS)] = list(FOLD_STRINGS.values())
    cols = {"d": d, "t": t, "l": lng, "i": i,
            "s16": rng.integers(-2 ** 15, 2 ** 15, N).astype(np.int16),
            "i8": rng.integers(-128, 128, N).astype(np.int8), "x": x,
            "f": f, "b": rng.random(N) < 0.5, "ds": dates, "ts": stamps}
    return {k: (v, rng.random(N) >= 0.15) for k, v in cols.items()}


@pytest.fixture(scope="module")
def data():
    return table()


class Given(Expression):
    """A child that hands back one given column."""

    def __init__(self, column: Column):
        self.column = column

    @property
    def dtype(self):
        return self.column.dtype

    def eval(self, batch):
        return self.column


class JaxGiven(JExpression):
    def __init__(self, column):
        self.column = column

    @property
    def dtype(self):
        return self.column.dtype

    def eval(self, batch):
        return self.column


def columns(data, name: str, types=TYPES):
    """Column `name` of `data` in both packages: (port Column, JAX
    Column), the same bytes for text; `types` maps a column to its
    type's name."""
    v, ok = data[name]
    jt = JAX_TYPES[types[name]]
    if jt is JT.StringType:
        jc = JColumn.from_strings([s if o else None for s, o in zip(v, ok)])
        pc = Column(torch.from_numpy(np.asarray(jc.data).copy()),
                    torch.from_numpy(np.asarray(jc.valid).copy()),
                    PT.StringType,
                    torch.from_numpy(np.asarray(jc.lengths).copy()))
        return pc, jc
    z = np.where(ok, v, np.zeros((), v.dtype)).astype(v.dtype)
    pc = Column(torch.from_numpy(z.copy()), torch.from_numpy(ok.copy()),
                PT.TYPES_BY_NAME[types[name]])
    return pc, JColumn(jnp.asarray(z), jnp.asarray(ok), jt)


def text_rows(data: np.ndarray, lens: np.ndarray) -> list:
    return [bytes(r[:n]) for r, n in zip(data, lens)]


def assert_same(got: Column, want, as_float32: bool = False):
    """Port column `got` equals JAX column `want` at every row: the same
    null mask and values, or text bytes up to each length and lengths.
    `as_float32`: the JAX package leaves float64 data under FloatType,
    which the port keeps as float32."""
    assert got.dtype.name == want.dtype.name
    g_ok, w_ok = got.valid.numpy(), np.asarray(want.valid)
    assert np.array_equal(g_ok, w_ok)
    if got.dtype is PT.StringType:
        g_len, w_len = got.lengths.numpy(), np.asarray(want.lengths)
        assert np.array_equal(g_len, w_len)
        assert text_rows(got.data.numpy(), g_len) == text_rows(
            np.asarray(want.data), w_len)
        return
    g, w = got.data.numpy(), np.asarray(want.data)
    if as_float32:
        w = w.astype(np.float32)
    assert g.dtype == w.dtype
    bad = np.flatnonzero(~((g == w) | (np.isnan(g) & np.isnan(w))
                           if g.dtype.kind == "f" else g == w))
    assert not len(bad), (bad[:4], g[bad[:4]], w[bad[:4]])


def test_the_table_holds_what_the_cases_need(data):
    pc, _ = columns(data, "ds")
    pd, _ = columns(data, "d")
    parsed = PC.cast_column(pc, PT.DateType)
    # some text parses and some does not, among the valid rows
    ok = pc.valid.numpy()
    assert 0.5 < parsed.valid.numpy()[ok].mean() < 0.95
    assert (pd.data.numpy() < 0).any() and pc.max_len >= 16
    for name, (_, valid) in data.items():
        assert 0.1 < 1 - valid.mean() < 0.2, name


@pytest.mark.parametrize("src,dst", ROUTES,
                         ids=[f"{TYPES[s]}-{d}" for s, d in ROUTES])
def test_cast_route_equals_the_jax_route(src, dst, data):
    pc, jc = columns(data, src)
    got = PC.Cast(Given(pc), PT.TYPES_BY_NAME[dst]).eval(None)
    want = JC.Cast(JaxGiven(jc), JAX_TYPES[dst]).eval(None)
    assert_same(got, want, as_float32=dst == "float")


def test_every_jax_route_is_ported_or_raises_not_implemented():
    """Over every pair of types: `supported_cast` answers as the JAX
    package's, the port's routes are the JAX package's `_DISPATCH` (the
    JAX routes the port lacks are UNPORTED, empty), every route besides
    numeric -> numeric has a parity case in ROUTES here or in
    test_torch_cast_text.ROUTES, and a Cast of a pair the JAX package
    lacks raises NotImplementedError naming it."""
    import test_torch_cast_text as XT
    assert set(JC._DISPATCH) - set(PC._ROUTES) == UNPORTED
    assert set(PC._ROUTES) <= set(JC._DISPATCH)
    cased = ({(TYPES[c], d) for c, d in ROUTES}
             | {(XT.TYPES[c], d) for c, d in XT.ROUTES})
    names = sorted(JAX_TYPES)
    for s in names:
        for d in names:
            ps, pd = PT.TYPES_BY_NAME[s], PT.TYPES_BY_NAME[d]
            has = JC.supported_cast(JAX_TYPES[s], JAX_TYPES[d])
            assert PC.supported_cast(ps, pd) == has, (s, d)
            child = Given(Column(torch.zeros(1), torch.ones(1), ps))
            if not has:
                with pytest.raises(NotImplementedError,
                                   match=f"cast {s} -> {d}"):
                    PC.Cast(child, pd)
                continue
            PC.Cast(child, pd)
            numeric = ps.is_numeric and pd.is_numeric
            assert s == d or numeric or (s, d) in cased, (s, d)


# the pairs the port once refused at planning, each now run through the
# planner in both packages (string -> double with castStringToFloat)
PLANNED = [("ds", "int"), ("ds", "double"), ("ds", "boolean"),
           ("b", "string"), ("l", "string"), ("i", "boolean"),
           ("b", "double")]


@pytest.mark.parametrize("src,dst", PLANNED)
def test_a_route_through_the_planner_gives_the_jax_rows(src, dst, data):
    conf = {FLOAT_KEY: "true"}
    assert JC.supported_cast(JAX_TYPES[TYPES[src]], JAX_TYPES[dst])
    want = jax_df({src: data[src]}, conf).select(
        JL.col(src).cast(dst).alias("x")).collect()
    got = port_df(TpuSession(dict(conf), device="cpu"),
                  {src: data[src]}).select(
        PL.col(src).cast(dst).alias("x")).collect()
    assert len(got) == N and got == want
    # no date text is a boolean word
    assert any(r[0] is not None for r in got) == ((src, dst)
                                                 != ("ds", "boolean"))


@pytest.mark.parametrize("src,dst", [("d", "boolean"), ("x", "string"),
                                     ("t", "int"), ("d", "double")])
def test_a_cast_neither_package_has_raises_analysis_error(src, dst, data):
    assert not JC.supported_cast(JAX_TYPES[TYPES[src]], JAX_TYPES[dst])
    df = port_df(TpuSession(device="cpu"), {src: data[src]})
    with pytest.raises(AnalysisError, match="not supported"):
        df.select(PL.col(src).cast(dst).alias("x")).physical_plan()


# --------------------------------------------------------------------------
# step 0: the fold of a string literal compared with a date
# --------------------------------------------------------------------------

_FOLD_DAYS = [days(1994, 7, 23), days(1994, 7, 22), days(1970, 1, 1)]
# what the JAX package's comparison of FOLD_STRINGS with a column of
# _FOLD_DAYS and a null gives (test_the_jax_package_s_fold_rows): the
# strings that parse equal the first row, the rest compare with a null
_MATCH, _NO_DATE = [True, False, False, None], [None, None, None, None]
FOLD_ROWS = {k: _MATCH if k in ("plain", "trailing-space", "leading-tab",
                                "single-digit-month") else _NO_DATE
             for k in FOLD_STRINGS}


def test_the_jax_package_s_fold_rows():
    """The JAX package's rows of each comparison, which FOLD_ROWS holds
    and the port's are held to."""
    df = JaxSession({}).from_pydict(
        {"d": _FOLD_DAYS + [None]},
        JT.Schema([JT.StructField("d", JT.DateType)]))
    rows = df.select(*[(JL.col("d") == s).alias(k)
                       for k, s in FOLD_STRINGS.items()]).collect()
    assert {k: [r[i] for r in rows]
            for i, k in enumerate(FOLD_STRINGS)} == FOLD_ROWS


@pytest.mark.parametrize("case", list(FOLD_STRINGS))
def test_a_string_literal_compared_with_a_date_gives_the_jax_rows(case):
    df = TpuSession(device="cpu").from_numpy(
        {"d": np.ma.masked_array(_FOLD_DAYS + [0],
                                 mask=[False] * 3 + [True]).astype(np.int32)},
        PT.Schema([PT.StructField("d", PT.DateType)]))
    got = [r[0] for r in df.select(
        (PL.col("d") == FOLD_STRINGS[case]).alias("x")).collect()]
    assert got == FOLD_ROWS[case]
    # and through a filter, the rows it keeps
    kept = df.filter(PL.col("d") == FOLD_STRINGS[case]).collect()
    assert len(kept) == FOLD_ROWS[case].count(True)


def test_the_fold_equals_the_column_cast():
    """Each string of FOLD_STRINGS folded into a date literal gives what
    the string -> date cast gives it as a column (the table's text column
    holds them too, so test_cast_route_equals_the_jax_route[string-date]
    holds that cast to the JAX package's)."""
    strings = list(FOLD_STRINGS.values())
    raw = [x.encode("utf-8") for x in strings]
    width = max(map(len, raw))
    col = PC.cast_column(Column(
        torch.tensor([list(x.ljust(width, b"\0")) for x in raw],
                     dtype=torch.uint8),
        torch.ones(len(raw), dtype=torch.bool), PT.StringType,
        torch.tensor([len(x) for x in raw], dtype=torch.int32)),
        PT.DateType)
    folded = [PC.fold_string(x, PT.DateType) for x in strings]
    column = [int(v) if ok else None for v, ok in
              zip(col.data.tolist(), col.valid.tolist())]
    assert folded == column == [
        _FOLD_DAYS[0] if FOLD_ROWS[k] == _MATCH else None
        for k in FOLD_STRINGS]


# --------------------------------------------------------------------------
# the DSL and the planner
# --------------------------------------------------------------------------

def port_df(session, data, types=TYPES):
    schema = PT.Schema([PT.StructField(n, PT.TYPES_BY_NAME[types[n]])
                        for n in data])
    cols = {}
    for n, (v, ok) in data.items():
        if types[n] == "string":
            v = np.array([s.encode("utf-8") for s in v])
        cols[n] = np.ma.masked_array(v, mask=~ok)
    return session.from_numpy(cols, schema)


def jax_df(data, conf=None, types=TYPES):
    schema = JT.Schema([JT.StructField(n, JAX_TYPES[types[n]])
                        for n in data])
    return JaxSession(dict(conf or {})).from_pydict(
        {n: [x if ok else None for x, ok in zip(v.tolist(), valid)]
         for n, (v, valid) in data.items()}, schema)


@pytest.mark.parametrize("spelling", ["bigint", "integer", "smallint",
                                      "tinyint", "DATE", " Timestamp ",
                                      "string", "double", "decimal"])
def test_cast_type_names_are_the_jax_package_s(spelling):
    if spelling == "decimal":
        for logical in (PL, JL):
            with pytest.raises(ValueError, match="not supported"):
                logical.col("x").cast(spelling)
        return
    assert (PL.col("x").cast(spelling).args[1].name
            == JL.col("x").cast(spelling).args[1].name)


def _text_casts(F, col):
    return [col("d").cast("string").alias("d_text"),
            col("t").cast("string").alias("t_text"),
            F.to_date(col("ds")).alias("ds_date"),
            col("d").cast("timestamp").alias("d_ts"),
            col("t").cast("date").alias("t_date"),
            (col("ds") == col("d")).alias("text_eq_date"),
            (col("t") > col("d")).alias("ts_gt_date"),
            (col("d") >= "2000-02-29").alias("date_ge_literal")]


@pytest.fixture(scope="module")
def dsl_data(data):
    """The date, timestamp and text columns past the edge rows: a date
    past 9999 or a timestamp at the int64 extremes has no Python value
    to collect."""
    return {k: (data[k][0][16:], data[k][1][16:])
            for k in ("d", "t", "ds", "ts")}


def test_dsl_casts_equal_the_jax_package(dsl_data):
    want = jax_df(dsl_data).select(*_text_casts(JL.functions, JL.col)) \
        .collect()
    got = port_df(TpuSession(device="cpu"), dsl_data).select(
        *_text_casts(PL.functions, PL.col)).collect()
    assert len(got) == N - 16 and got == want


def test_dsl_filter_and_group_by_over_casts_equal_the_jax_package(dsl_data):
    def q(F, col, df):
        parsed = F.to_date(col("ds"))
        return (df.filter((parsed >= "1700-01-01") & (parsed < "2300-01-01"))
                .with_column("decade", col("d").cast("string").substr(1, 3))
                .group_by(col("decade"))
                .agg(F.count(col("ds")).alias("n"),
                     F.max(parsed).alias("last"))
                .order_by("decade"))
    want = q(JL.functions, JL.col, jax_df(dsl_data)).collect()
    got = q(PL.functions, PL.col,
            port_df(TpuSession(device="cpu"), dsl_data)).collect()
    assert len(got) > 50 and got == want


def test_string_to_timestamp_needs_the_conf(dsl_data):
    """The JAX package runs string -> timestamp on its device only when
    castStringToTimestamp is true (its CPU executor otherwise); the port
    has no CPU executor, so it raises at planning time without the key,
    and with it gives the JAX package's rows."""
    def q(col, df):
        return df.select(col("ts").cast("timestamp").alias("x"),
                         (col("t") >= "1994-08-23").alias("y"))
    df = port_df(TpuSession(device="cpu"), dsl_data)
    with pytest.raises(NotImplementedError, match=TS_KEY):
        q(PL.col, df).physical_plan()
    want = q(JL.col, jax_df(dsl_data, {TS_KEY: "true"})).collect()
    got = q(PL.col, port_df(TpuSession({TS_KEY: "true"}, device="cpu"),
                            dsl_data)).collect()
    assert got == want and any(r[0] is not None for r in got)


def test_unix_timestamp_of_a_string_is_not_gated(dsl_data):
    """UnixTimestamp of a string parses it whatever castStringToTimestamp
    says (the JAX package gives the expression no rule)."""
    def q(a, df):
        return df.select(a.ColumnExpr("UnixTimestamp", (a.col("ts"),))
                         .alias("u"))
    want = q(JL, jax_df(dsl_data)).collect()
    got = q(PL, port_df(TpuSession(device="cpu"), dsl_data)).collect()
    assert got == want and any(r[0] is not None for r in got)


# --------------------------------------------------------------------------
# the JAX package's behaviour the port keeps, each pinned
# --------------------------------------------------------------------------

def _cast_text(strings, to: str):
    """(port values, JAX values) of `strings` cast to `to`, None where
    null."""
    jc = JColumn.from_strings(strings)
    want = JC.Cast(JaxGiven(jc), JAX_TYPES[to]).eval(None)
    got = PC.cast_column(Column(
        torch.from_numpy(np.asarray(jc.data).copy()),
        torch.ones(len(strings), dtype=torch.bool), PT.StringType,
        torch.from_numpy(np.asarray(jc.lengths).copy())),
        PT.TYPES_BY_NAME[to])

    def vals(d, ok):
        return [int(v) if o else None for v, o in zip(d, ok)]
    return (vals(got.data.tolist(), got.valid.tolist()),
            vals(np.asarray(want.data).tolist(),
                 np.asarray(want.valid).tolist()))


def test_parse_date_needs_two_dashes_and_a_four_digit_year():
    """`_parse_date`: exactly two dashes, a 4-digit year, a 1-2 digit
    month and day; it rejects a day past the month's last and trims only
    bytes <= 0x20."""
    cases = {"1994-07-23": days(1994, 7, 23), "1994-7-3": days(1994, 7, 3),
             "994-07-23": None, "19940-07-23": None, "1994-07": None,
             "1994-07-23-": None, "1994-007-23": None, "1994-07-023": None,
             "2000-02-29": days(2000, 2, 29), "1900-02-29": None,
             "1994-04-31": None, "1994-00-10": None, "1994-01-00": None,
             "\x01\x1f 1994-07-23\x20\x00": days(1994, 7, 23),
             "\x7f1994-07-23": None, "1994-07-23\xa0": None,
             "1994-07-23 00:00:00": None}
    got, want = _cast_text(list(cases), "date")
    assert got == want == list(cases.values())


def test_parse_timestamp_checks_no_colon_and_needs_eight_time_bytes():
    """`_parse_timestamp` checks neither `:` of the time, so
    "1994-08-23 12x34y56" parses; the time after the first space must be
    exactly 8 bytes, hour < 24, minute and second < 60."""
    base = days(1994, 8, 23) * DAY_US
    at = 45_296_000_000  # 12:34:56
    cases = {"1994-08-23 12:34:56": base + at,
             "1994-08-23 12x34y56": base + at,
             "1994-08-23": base, "1994-08-23 12:34": None,
             "1994-08-23 12:34:56.5": None, "1994-08-23 24:00:00": None,
             "1994-08-23 12:60:00": None, "1994-08-23  12:34:56": None,
             "1994-08-23\t 12:34:56": base + at,
             "1994-08-23T12:34:56": None, " 1994-08-23 12:34:56\n":
                 base + at}
    got, want = _cast_text(list(cases), "timestamp")
    assert got == want == list(cases.values())


def test_formatted_text_layout_is_the_jax_package_s():
    """`_format_date` clips the year to 0-9999 and writes 10 bytes into
    16-byte rows; `_format_timestamp` writes 19 bytes into 24-byte rows
    in the JAX package and 32-byte rows in the port, the same bytes up
    to each length."""
    d = np.array([days(1994, 7, 23), 3_000_000, -800_000, -1], np.int32)
    ok = np.ones(len(d), bool)
    pc = Column(torch.from_numpy(d), torch.from_numpy(ok), PT.DateType)
    jc = JColumn(jnp.asarray(d), jnp.asarray(ok), JT.DateType)
    got = PC.cast_column(pc, PT.StringType)
    want = JC.Cast(JaxGiven(jc), JT.StringType).eval(None)
    assert got.max_len == np.asarray(want.data).shape[1] == 16
    assert text_rows(got.data.numpy(), got.lengths.numpy()) == [
        b"1994-07-23", b"9999-09-21", b"0000-09-05", b"1969-12-31"]
    assert_same(got, want)
    t = d.astype(np.int64) * DAY_US + 3_723_000_001  # 01:02:03.000001
    pt = Column(torch.from_numpy(t), torch.from_numpy(ok), PT.TimestampType)
    jt = JColumn(jnp.asarray(t), jnp.asarray(ok), JT.TimestampType)
    got = PC.cast_column(pt, PT.StringType)
    want = JC.Cast(JaxGiven(jt), JT.StringType).eval(None)
    assert (got.max_len, np.asarray(want.data).shape[1]) == (32, 24)
    assert text_rows(got.data.numpy(), got.lengths.numpy())[0] == \
        b"1994-07-23 01:02:03"
    assert_same(got, want)
