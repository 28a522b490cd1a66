"""The port's null and NaN expressions (IsNull, IsNotNull, IsNaN,
EqualNullSafe, Coalesce, NaNvl, AtLeastNNonNulls, NormalizeNaNAndZero,
KnownFloatingPointNormalized) and its conditionals (If, CaseWhen, In,
Least, Greatest) against the JAX package, row by row.

One seeded numpy table with two columns of each type (int, long,
double, float, string, date, boolean), about 20% nulls, NaN of both
signs, +-0.0 and +-inf in the floats, strings of 0 to 20 bytes, goes
through both packages' DataFrame API (`filter` and `select`, so resolve
and type coercion run too).  The results must be equal: the same column
types in the schema, the same null masks, and at the valid rows the same
values, floats bit for bit (NaN equal to NaN).  Where the JAX package
raises, at analysis or when it evaluates, the port must raise when the
plan is made.

The JAX package is imported inside the functions that use it:
tests/test_torch_cuda.py reuses the table and the cases on a machine
without JAX.
"""
import datetime

import numpy as np
import pytest

from spark_rapids_tpu_torch import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.plan import logical as PL

N = 256
# column name prefix -> the type's name in both packages
TYPES = {"i": "int", "l": "long", "d": "double", "f": "float",
         "s": "string", "dt": "date", "b": "boolean"}
COLUMNS = [p + k for p in TYPES for k in ("", "2")]
_STRINGS = ["", "a", "ab", "MAIL", "SHIP", "héllo", "abcdefgh",
            "abcdefghi", "abcdefghijklmnop", "abcdefghijklmnopqrst"]
DAY = 9000  # 1994-08-23, in days since 1970-01-01


def _type_of(name: str) -> str:
    return TYPES[name.rstrip("2")]


def table(seed: int = 12):
    """{column: (values, valid)} as numpy arrays, N rows."""
    rng = np.random.default_rng(seed)
    specials = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf])
    out = {}
    for name in COLUMNS:
        t = _type_of(name)
        if t in ("double", "float"):
            pick = rng.random(N)
            v = np.where(pick < 0.3, rng.choice(specials, N),
                         np.where(pick < 0.7, rng.integers(-4, 5, N) * 0.5,
                                  rng.normal(0, 100, N)))
            v = v.astype(np.float32 if t == "float" else np.float64)
        elif t in ("int", "long"):
            dt = np.int32 if t == "int" else np.int64
            info = np.iinfo(dt)
            v = np.where(rng.random(N) < 0.05,
                         rng.choice([info.min, info.max], N),
                         rng.integers(-5, 6, N)).astype(dt)
        elif t == "string":
            letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
            rand = ["".join(rng.choice(letters, k))
                    for k in rng.integers(0, 21, N)]
            v = np.where(rng.random(N) < 0.6,
                         np.array(_STRINGS)[rng.integers(0, len(_STRINGS),
                                                         N)],
                         np.array(rand))
        elif t == "date":
            v = (DAY + rng.integers(-3, 4, N)).astype(np.int32)
        else:
            v = rng.random(N) < 0.5
        out[name] = (v, rng.random(N) >= 0.2)
    return out


def port_df(session, data):
    """The table as a port DataFrame (masked arrays: masked = null)."""
    schema = PT.Schema([PT.StructField(n, _PORT_TYPES[_type_of(n)])
                        for n in data])
    return session.from_numpy(
        {n: np.ma.masked_array(v, mask=~ok) for n, (v, ok) in data.items()},
        schema)


_PORT_TYPES = {t.name: t for t in (PT.IntegerType, PT.LongType,
                                   PT.DoubleType, PT.FloatType,
                                   PT.StringType, PT.DateType,
                                   PT.BooleanType)}


class Api:
    """One package's DSL, so one case builds the same tree in both."""

    def __init__(self, logical):
        self.col, self.lit, self.F = logical.col, logical.lit, \
            logical.functions
        self.E = logical.ColumnExpr


PORT = Api(PL)


def _nullsafe(a, x, y):
    return a.E("EqualNullSafe", (a.col(x), y if isinstance(y, a.E)
                                 else a.col(y)))


def _nanvl(a, x, y):
    return a.E("NaNvl", (a.col(x) if isinstance(x, str) else x,
                         a.col(y) if isinstance(y, str) else y))


def _at_least(a, n, cols):
    return a.E("AtLeastNNonNulls", (n, [a.col(c) for c in cols]))


def _unary(a, op, c):
    return a.E(op, (c if isinstance(c, a.E) else a.col(c),))


# id -> (select(api) -> [ColumnExpr], where(api) -> ColumnExpr or None)
CASES = {
    "IsNull": (lambda a: [a.col(c).is_null() for c in COLUMNS], None),
    "IsNotNull": (lambda a: [a.col(c).is_not_null() for c in COLUMNS],
                  lambda a: a.col("s").is_not_null()),
    "IsNaN": (lambda a: [a.F.isnan(a.col(c)) for c in
                         ("d", "d2", "f", "f2", "i", "l", "dt", "b")]
              + [a.F.isnan(a.lit(None))],
              lambda a: ~a.F.isnan(a.col("d2"))),
    "EqualNullSafe": (lambda a: [
        _nullsafe(a, x, y) for x, y in
        [("i", "i2"), ("i", "l"), ("l", "l2"), ("d", "d2"), ("f", "f2"),
         ("f", "d"), ("i", "d"), ("s", "s2"), ("dt", "dt2"), ("b", "b2")]]
        + [_nullsafe(a, "i", a.lit(None)), _nullsafe(a, "s", a.lit("MAIL")),
           _nullsafe(a, "dt", a.lit("1994-08-24")),
           _nullsafe(a, "d", a.lit(0))],
        lambda a: _nullsafe(a, "d", "d2") | _nullsafe(a, "s", "s2")),
    "Coalesce": (lambda a: [
        a.F.coalesce(*[a.col(c) for c in cs]) for cs in
        [("i", "i2"), ("i", "l"), ("f", "d"), ("d", "f"), ("f", "f2"),
         ("s", "s2"), ("dt", "dt2"), ("b", "b2"), ("d", "d2", "f2"),
         ("i",), ("s",)]]
        + [a.F.coalesce(a.col("l"), a.col("i"), a.lit(0)),
           a.F.coalesce(a.col("d"), a.lit(-1.5)),
           a.F.coalesce(a.col("s"), a.lit("a fallback of 24 bytes!")),
           a.F.coalesce(a.lit(None), a.col("i")),
           a.F.coalesce(a.col("i"), a.lit(None), a.col("i2"))],
        lambda a: a.F.coalesce(a.col("b"), a.col("b2"))),
    # a null left row reads the zero in its slot, not NaN: the result
    # keeps the left side's null there
    "NaNvl": (lambda a: [
        _nanvl(a, x, y) for x, y in
        [("d", "d2"), ("f", "f2"), ("f", "d"), ("d", "f"), ("i", "d"),
         ("d", a.lit(2.5)), (a.lit(float("nan")), "d"), ("dt", "dt2")]],
        None),
    "AtLeastNNonNulls": (lambda a: [_at_least(a, n, ["d", "f", "s", "i"])
                                    for n in range(5)]
                         + [_at_least(a, 1, [])],
                         lambda a: _at_least(a, 2, ["d", "d2", "s"])),
    "NormalizeNaNAndZero": (lambda a: [
        _unary(a, "NormalizeNaNAndZero", c) for c in
        ("d", "d2", "f", "f2", "i", "s", "dt", "b")], None),
    "KnownFloatingPointNormalized": (lambda a: [
        _unary(a, "KnownFloatingPointNormalized", c) for c in
        ("d", "f", "s")] + [_unary(a, "KnownFloatingPointNormalized",
                                   _unary(a, "NormalizeNaNAndZero", "d"))],
        None),
    # If is what CaseWhen evaluates: one branch and an else value
    "If": (lambda a: [
        a.F.when(a.col(p), a.col(t)).otherwise(a.col(o)) for p, t, o in
        [("b", "i", "i2"), ("b", "d", "f"), ("b2", "s", "s2"),
         ("b", "dt", "dt2"), ("i", "l", "i2"), ("d", "f", "f2"),
         ("b", "b2", "b")]]
        + [a.F.when(a.col("b"), a.col("i")).otherwise(a.lit(None)),
           a.F.when(a.col("b"), a.lit(None)).otherwise(a.col("d")),
           a.F.when(a.lit(None), a.col("i")).otherwise(a.col("i2")),
           a.F.when(a.col("i") > 0, a.lit("x")).otherwise(a.col("s")),
           # In holds true in a null row whose zeroed slot matches ("",
           # 0): a null predicate must still count as false
           a.F.when(a.col("s").isin("", "MAIL"), a.col("i"))
           .otherwise(a.col("i2")),
           a.F.when(a.col("l").isin(0, 1), a.col("s")).otherwise("x")],
        lambda a: a.F.when(a.col("b"), a.col("b2")).otherwise(a.col("b"))),
    "CaseWhen": (lambda a: [
        a.F.when(a.col("b"), 1).when(a.col("b2"), 2.5)
        .otherwise(a.col("l")),
        a.F.when(a.col("b"), a.col("s"))
        .when(a.col("b2"), "a much longer literal string"),
        a.F.when(a.col("d") > 0, "pos").when(a.col("d") < 0, "neg")
        .when(a.F.isnan(a.col("d")), "nan").otherwise("zero"),
        a.F.when(a.col("s").isin("MAIL", "SHIP"), 1).otherwise(0),
        a.F.when(a.col("i") > a.col("i2"), a.col("dt")),
        a.F.when(a.col("b"), a.col("i")),
        a.F.when(a.col("f").is_null(), a.col("f2"))
        .when(a.col("f") > 1, a.col("d")).otherwise(a.col("f"))],
        lambda a: a.F.when(a.col("i") > 0, a.col("b"))
        .when(a.col("i") < 0, a.col("b2"))),
    "In": (lambda a: [
        a.col("i").isin(1, 1.5, 3, -5), a.col("i").isin("3"),
        a.col("l").isin(2 ** 40, 1), a.col("l").isin(-1, None),
        a.col("d").isin(float("nan"), 0.0, float("inf"), 1.5),
        a.col("f").isin(0.1, -2.0, -0.0), a.col("i2").isin([]),
        a.col("s").isin("MAIL", "", "abcdefgh", "héllo"),
        a.col("s").isin(["MAIL", None]), a.col("s2").isin([]),
        a.col("s").isin("a string longer than every value"),
        a.col("dt").isin(DAY, DAY + 1), a.col("b").isin(True),
        a.col("i").isin(None), a.lit(None).isin(1),
        a.lit("MAIL").isin("MAIL", "x")],
        lambda a: a.col("s").isin("MAIL", "SHIP", "")),
    "Least": (lambda a: [
        a.F.least(*[a.col(c) for c in cs]) for cs in
        [("i", "i2"), ("i", "l", "d"), ("f", "d"), ("d", "d2"),
         ("f", "f2"), ("dt", "dt2"), ("b", "b2"), ("d", "d2", "f", "f2")]]
        + [a.F.least(a.col("i"), a.lit(None)),
           a.F.least(a.col("d"), a.lit(float("nan"))),
           a.F.least(a.col("d"), a.lit(float("inf"))),
           a.F.least(a.lit(float("inf")), a.col("f"))],
        lambda a: a.F.least(a.col("b"), a.col("b2"))),
    "Greatest": (lambda a: [
        a.F.greatest(*[a.col(c) for c in cs]) for cs in
        [("i", "i2"), ("i", "l", "d"), ("f", "d"), ("d", "d2"),
         ("f", "f2"), ("dt", "dt2"), ("b", "b2"), ("d", "d2", "f", "f2")]]
        + [a.F.greatest(a.col("i"), a.lit(None)),
           a.F.greatest(a.col("d"), a.lit(float("-inf"))),
           a.F.greatest(a.col("d"), a.lit(float("inf"))),
           a.F.greatest(a.lit(float("inf")), a.col("f"))],
        lambda a: a.F.greatest(a.col("b"), a.col("b2"))),
}


def query(df, api, case):
    """The case's query over a DataFrame of the table: the filter, then
    the select with each expression aliased apart."""
    select, where = CASES[case]
    if where is not None:
        df = df.filter(where(api))
    return df.select(*[e.alias(f"c{k}") for k, e in enumerate(select(api))])


def port_columns(df):
    """(type names, [(values, valid)]) of a port result."""
    out = []
    for v in df.to_pydict().values():
        out.append((np.ma.getdata(v), ~np.ma.getmaskarray(v)))
    return [f.dtype.name for f in df.schema], out


def same_values(a: np.ndarray, b: np.ndarray, valid: np.ndarray) -> bool:
    """Equal at the valid rows: floats bit for bit or both NaN, dates as
    days, strings as text."""
    a, b = a[valid], b[valid]
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        if a.dtype != b.dtype:
            return False
        bits = a.view(f"u{a.dtype.itemsize}") == b.view(f"u{b.dtype.itemsize}")
        return bool(np.all(bits | (np.isnan(a) & np.isnan(b))))
    if a.dtype.kind == "M" or b.dtype.kind == "M":
        return np.array_equal(a.astype("datetime64[D]"),
                              b.astype("datetime64[D]"))
    return a.tolist() == b.tolist()


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------

def _jax_df(data):
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    jtypes = {t.name: t for t in (JT.IntegerType, JT.LongType, JT.DoubleType,
                                  JT.FloatType, JT.StringType, JT.DateType,
                                  JT.BooleanType)}
    schema = JT.Schema([JT.StructField(n, jtypes[_type_of(n)])
                        for n in data])
    return JaxSession({}).from_pydict(
        {n: [x if ok else None for x, ok in zip(v.tolist(), valid)]
         for n, (v, valid) in data.items()}, schema)


def _jax_api():
    from spark_rapids_tpu.plan import logical as JL
    return Api(JL)


def jax_columns(df):
    """(type names, [(values, valid)]) of a JAX result, from its Arrow
    columns."""
    import pyarrow as pa
    table = df.to_arrow()
    out = []
    for arr in table.columns:
        arr = arr.combine_chunks()
        valid = ~np.asarray(arr.is_null())
        if pa.types.is_string(arr.type):
            vals = np.array(["" if x is None else x for x in arr.to_pylist()])
        elif pa.types.is_date32(arr.type):
            vals = arr.cast(pa.int32()).fill_null(0).to_numpy() \
                .astype("datetime64[D]")
        elif pa.types.is_boolean(arr.type):
            vals = arr.fill_null(False).to_numpy(zero_copy_only=False)
        else:
            vals = arr.fill_null(0).to_numpy()
        out.append((vals, valid))
    return [f.dtype.name for f in df.schema], out


@pytest.fixture(scope="module")
def data():
    return table()


@pytest.fixture(scope="module")
def jax_df(data):
    return _jax_df(data)


@pytest.fixture(scope="module")
def port_table(data):
    return port_df(TpuSession(device="cpu"), data)


def test_the_table_holds_what_the_cases_need(data):
    for name, (v, valid) in data.items():
        assert 0.1 < 1 - valid.mean() < 0.3, name
        if v.dtype.kind == "f":
            live = v[valid]
            assert np.isnan(live).any() and np.isinf(live).any()
            assert (np.signbit(live) & (live == 0)).any()
            assert (np.signbit(live) & np.isnan(live)).any()
            assert ((live == 0) & ~np.signbit(live)).any()
        if v.dtype.kind == "U":
            lens = [len(x.encode()) for x in v]
            assert min(lens) == 0 and max(lens) == 20


@pytest.mark.parametrize("case", list(CASES))
def test_expression_rows_equal_the_jax_package(case, jax_df, port_table):
    jtypes, want = jax_columns(query(jax_df, _jax_api(), case))
    ptypes, got = port_columns(query(port_table, PORT, case))
    assert ptypes == jtypes
    assert len(got) == len(want) > 0
    for k, ((wv, wok), (gv, gok)) in enumerate(zip(want, got)):
        assert len(wok) == len(gok) > 0, k
        assert np.array_equal(wok, gok), (case, k)
        assert same_values(wv, gv, wok), (case, k, wv[wok][:8], gv[gok][:8])


# trees the JAX package cannot run: it raises at analysis or when it
# evaluates them; the port raises when the plan is made
RAISES = {
    "In-date-column-string-item": lambda a: a.col("dt").isin("1994-08-23"),
    "In-string-column-int-item": lambda a: a.col("s").isin("MAIL", 1),
    "In-int-column-item-out-of-range": lambda a: a.col("i").isin(2 ** 40),
    "Least-strings": lambda a: a.F.least(a.col("s"), a.col("s2")),
    "Greatest-strings": lambda a: a.F.greatest(a.col("s"), a.col("s2")),
    "Least-nulls": lambda a: a.F.least(a.lit(None), a.lit(None)),
    "Coalesce-string-null": lambda a: a.F.coalesce(a.col("s"), a.lit(None)),
    "Coalesce-nulls": lambda a: a.F.coalesce(a.lit(None), a.lit(None)),
    "Coalesce-string-int": lambda a: a.F.coalesce(a.col("s"), a.col("i")),
    "IsNaN-string": lambda a: a.F.isnan(a.col("s")),
    "CaseWhen-string-null-branch":
        lambda a: a.F.when(a.col("b"), a.lit(None)).otherwise("x"),
    "CaseWhen-int-string": lambda a: a.F.when(a.col("b"), 1).otherwise("x"),
    "CaseWhen-only-nulls": lambda a: a.F.when(a.col("b"), a.lit(None)),
    "NaNvl-strings": lambda a: _nanvl(a, "s", "s2"),
    "NaNvl-date-int": lambda a: _nanvl(a, "dt", "i"),
}


# a null-typed output column: the JAX package has no Arrow type for null
# and fails when it collects one; the port raises NotImplementedError
# when the plan is made (a null inside the tree runs, as in CASES)
NULL_OUTPUTS = {
    "null-literal": lambda a: a.lit(None),
    "null-plus-null": lambda a: a.lit(None) + a.lit(None),
}


@pytest.mark.parametrize("case", list(RAISES) + list(NULL_OUTPUTS))
def test_what_the_jax_package_cannot_run_raises_at_planning(case, jax_df,
                                                             port_table):
    build = RAISES[case] if case in RAISES else NULL_OUTPUTS[case]
    with pytest.raises(Exception):
        jax_df.select(build(_jax_api()).alias("x")).to_arrow()
    df = port_table.select(build(PORT).alias("x"))
    with pytest.raises(NotImplementedError if case in NULL_OUTPUTS
                       else (TypeError, ValueError, OverflowError)):
        df.physical_plan()


def test_a_null_column_added_by_with_column_raises_at_planning(jax_df,
                                                               port_table):
    with pytest.raises(KeyError, match="null"):
        jax_df.with_column("z", _jax_api().lit(None)).to_arrow()
    with pytest.raises(NotImplementedError, match="null-typed"):
        port_table.with_column("z", PORT.lit(None)).collect()


# the casts the JAX package's coerce_pair inserts: a string side cast to
# the other side's type, and a date widened to a timestamp.  The port
# runs string -> timestamp only with castStringToTimestamp (off by
# default), so that one raises; the rest are ported (PORTED_CASTS) and
# give the JAX package's rows
CASTS = {
    "int-eq-string-literal": lambda a: a.col("i") == "2",
    "string-eq-int": lambda a: a.col("s") == a.col("i"),
    "string-plus-int": lambda a: a.col("s") + 1,
    "timestamp-gt-date": lambda a: a.col("t") > a.col("d"),
    "timestamp-ge-string-literal": lambda a: a.col("t") >= "1994-08-23",
}


PORTED_CASTS = ("int-eq-string-literal", "string-eq-int", "string-plus-int",
                "timestamp-gt-date")


@pytest.mark.parametrize("case", list(CASTS))
def test_a_cast_the_port_lacks_raises_not_implemented_at_planning(case):
    import datetime as dt
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    stamps = [dt.datetime(1994, 8, 23, 12), dt.datetime(1994, 8, 22)]
    jdf = JaxSession({}).from_pydict(
        {"i": [2, 3], "s": ["2", "x"], "t": stamps, "d": [DAY, DAY - 1]},
        JT.Schema([JT.StructField("i", JT.IntegerType),
                   JT.StructField("s", JT.StringType),
                   JT.StructField("t", JT.TimestampType),
                   JT.StructField("d", JT.DateType)]))
    rows = jdf.select(CASTS[case](_jax_api()).alias("x")).collect()
    assert len(rows) == 2 and rows[0][0] is not None
    pdf = TpuSession(device="cpu").from_numpy(
        {"i": np.array([2, 3], np.int32), "s": np.array(["2", "x"]),
         "t": np.array(stamps, dtype="datetime64[us]"),
         "d": np.array([DAY, DAY - 1], np.int32)},
        PT.Schema([PT.StructField("i", PT.IntegerType),
                   PT.StructField("s", PT.StringType),
                   PT.StructField("t", PT.TimestampType),
                   PT.StructField("d", PT.DateType)]))
    if case in PORTED_CASTS:
        assert pdf.select(CASTS[case](PORT).alias("x")).collect() == rows
        return
    with pytest.raises(NotImplementedError, match="cast"):
        pdf.select(CASTS[case](PORT).alias("x")).physical_plan()


@pytest.mark.parametrize("op", ["Divide", "IntegralDivide", "Remainder",
                                "Pmod"])
def test_arithmetic_on_a_string_column_gives_the_jax_rows(op, jax_df,
                                                          port_table):
    """The JAX package casts a string side to the other side's type and
    runs the op, and so does the port: over the string column (letters,
    null as an int) and over the int column's text."""
    def build(a):
        return [a.E(op, (a.col("s"), a.col("i"))).alias("x"),
                a.E(op, (a.col("i2").cast("string"), a.col("i"))).alias("y"),
                a.E(op, (a.col("l"), a.lit("3"))).alias("z")]
    jtypes, want = jax_columns(jax_df.select(*build(_jax_api())))
    ptypes, got = port_columns(port_table.select(*build(PORT)))
    assert ptypes == jtypes
    for k, ((wv, wok), (gv, gok)) in enumerate(zip(want, got)):
        assert len(gok) == N and np.array_equal(wok, gok), (op, k)
        assert same_values(wv, gv, wok), (op, k, wv[wok][:8], gv[gok][:8])
    assert got[1][1].any() and got[2][1].any()


@pytest.mark.parametrize("mixed", [False, True], ids=["alone", "mixed"])
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
def test_an_agg_entry_with_no_aggregate_raises_value_error(grouped, mixed,
                                                           jax_df,
                                                           port_table):
    """An agg entry must compute over an aggregate: a plain expression,
    alone or beside an aggregate, raises ValueError in both packages when
    the DataFrame is made, with the same message."""
    msgs = []
    for a, df in ((_jax_api(), jax_df), (PORT, port_table)):
        g = df.group_by("b") if grouped else df
        entries = ([a.F.sum(a.col("i"))] if mixed else []) \
            + [(a.col("i") * 2).alias("x")]
        with pytest.raises(ValueError, match="contains no aggregate") as e:
            g.agg(*entries)
        msgs.append(str(e.value).split(" contains")[1])
    assert msgs[0] == msgs[1]


def test_a_hand_built_aggregate_of_a_plain_expression_raises_at_planning(
        port_table):
    """agg() splits an entry over aggregates into an aggregate and a
    projection; a LogicalAggregate built by hand with a plain expression
    in its list still raises at planning."""
    df = port_table.group_by("b").agg(PL.functions.sum(PL.col("i")))
    bad = PL.LogicalAggregate(df.plan.grouping, [PL.col("i") * 2],
                              df.plan.children[0])
    with pytest.raises(NotImplementedError, match="not an aggregate"):
        type(df)(df.session, bad).physical_plan()


LITERALS = [None, True, False, 0, 1, -2 ** 31, 2 ** 31 - 1, 2 ** 31,
            -2 ** 31 - 1, 2 ** 62, np.int32(7), np.int64(2 ** 40), 1.5,
            float("nan"), -0.0, np.float32(0.25), np.float64(1e300), "",
            "MAIL", "héllo"]


def test_literal_types_agree_with_the_jax_package():
    from spark_rapids_tpu.ops.expressions import _infer_literal_type
    from spark_rapids_tpu_torch.ops.expressions import infer_literal_type
    for v in LITERALS:
        assert infer_literal_type(v).name == _infer_literal_type(v).name, v


def test_when_of_int_literals_is_an_int_and_its_sum_a_long(jax_df,
                                                          port_table):
    rows = []
    for a, df in ((_jax_api(), jax_df), (PORT, port_table)):
        hi = a.F.when(a.col("s").isin("MAIL", "SHIP"), 1).otherwise(0)
        assert [f.dtype.name for f in df.select(hi).schema] == ["int"]
        agg = df.group_by("b").agg(a.F.sum(hi).alias("n"))
        assert [f.dtype.name for f in agg.schema] == ["boolean", "long"]
        got = _jax_rows(agg) if a is not PORT else agg.collect()
        rows.append(sorted(got, key=lambda r: (r[0] is None, bool(r[0]))))
    assert rows[0] == rows[1] and len(rows[0]) == 3


def _jax_rows(df):
    table = df.to_arrow()
    return list(zip(*[c.to_pylist() for c in table.columns]))


def test_timestamp_lists_ingest_as_in_the_jax_package():
    """A list of datetime.datetime for a timestamp column: microseconds
    since the epoch (a naive value read as UTC, an aware one converted),
    None a null."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    plus2 = datetime.timezone(datetime.timedelta(hours=2))
    values = [datetime.datetime(2020, 1, 1, 12, 30), None,
              datetime.datetime(1969, 12, 31, 23, 59, 59, 999999),
              datetime.datetime(2020, 1, 1, 12, 30, tzinfo=plus2),
              datetime.datetime(1, 1, 1), None]
    want = JaxSession({}).from_pydict(
        {"t": values}, JT.Schema([JT.StructField("t", JT.TimestampType)])
    ).to_arrow().column(0).combine_chunks()
    got = TpuSession(device="cpu").from_numpy(
        {"t": values}, PT.Schema([PT.StructField("t", PT.TimestampType)])
    ).to_pydict()["t"]
    valid = ~np.ma.getmaskarray(got)
    assert valid.tolist() == [x is not None for x in values]
    assert np.array_equal(~np.asarray(want.is_null()), valid)
    import pyarrow as pa
    micros = want.cast(pa.int64()).fill_null(0).to_numpy()
    assert np.ma.getdata(got)[valid].astype(np.int64).tolist() \
        == micros[valid].tolist()


_WORDS = ["", "a", "ab", "abc", "abcde", "bcdef", "abcdefghijkl",
          "abcdefghijklmnop"]


def _string_batch(width, n=64):
    """A CPU batch of one string column whose byte matrix is `width` bytes
    wide, ~20% null; returns it with the values and the validity."""
    from spark_rapids_tpu_torch.columnar import batch_from_numpy
    rng = np.random.default_rng(width)
    vals = [w for w in _WORDS if len(w) <= width]
    pick = rng.integers(0, len(vals), n)
    data = np.zeros((n, width), np.uint8)
    for r, k in enumerate(pick):
        data[r, :len(vals[k])] = np.frombuffer(vals[k].encode(), np.uint8)
    valid = rng.random(n) < 0.8
    data[~valid] = 0
    lengths = np.where(valid, [len(vals[k]) for k in pick], 0)
    schema = PT.Schema([PT.StructField("s", PT.StringType)])
    batch = batch_from_numpy([(data, valid, lengths)], np.ones(n, bool),
                             schema, device="cpu")
    return batch, [vals[k] for k in pick], valid


@pytest.mark.parametrize("width", [1, 5, 8, 12, 16])
def test_string_in_at_any_byte_width(width):
    """In compares 8-byte words; a string column whose byte matrix is not
    a multiple of 8 wide (a batch from another package's leaves) is
    padded first.  Against Python's `in`."""
    import torch
    from spark_rapids_tpu_torch.ops import expressions as E
    batch, want_vals, valid = _string_batch(width)
    items = ["abc", "", "abcde", "abcdefghijkl", "zz"]
    out = E.In(E.BoundReference(0, PT.StringType), items).eval(batch)
    assert out.data.dtype == torch.bool
    assert out.valid.tolist() == valid.tolist()
    want = [w in items for w in want_vals]
    assert [h for h, ok in zip(out.data.tolist(), valid) if ok] \
        == [w for w, ok in zip(want, valid) if ok]


@pytest.mark.parametrize("width", [1, 5, 8, 12, 16])
def test_string_equal_to_literals_at_any_byte_width(width):
    """EqualTo and EqualNullSafe against string literals narrower and
    wider than the column, against Python's `==`; the literal padded to
    the column's width stays one broadcast row."""
    from spark_rapids_tpu_torch.ops import expressions as E
    batch, want_vals, valid = _string_batch(width)
    col = E.BoundReference(0, PT.StringType)
    for item in ["", "ab", "abcde", "abcdefghijkl", "abcdefghijklmnopq"]:
        lit = E.Literal(item)
        padded = lit.eval(batch).pad_strings_to(32)
        assert padded.data.stride(0) == 0
        assert bytes(padded.data[0].tolist()) == \
            item.encode().ljust(32, b"\0")
        want = [w == item for w in want_vals]
        eq = E.EqualTo(col, lit).eval(batch)
        assert eq.valid.tolist() == valid.tolist()
        assert [h for h, ok in zip(eq.data.tolist(), valid) if ok] \
            == [w for w, ok in zip(want, valid) if ok]
        ens = E.EqualNullSafe(col, lit).eval(batch)
        assert ens.valid.all()
        assert ens.data.tolist() == [bool(ok and w)
                                     for w, ok in zip(want, valid)]
