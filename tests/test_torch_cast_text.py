"""The port's casts between text and numbers or booleans and between
numbers and booleans (spark_rapids_tpu_torch/ops/cast.py) against the
JAX package's, bit for bit and null for null; the casts the planner
inserts for a string side, the fold of a string literal and the
castStringToFloat gate; and the two queries of `tpch.TEXT_QUERIES`.

One seeded numpy table of N rows (`table`): byte, short, int and long
columns whose first rows are each type's extremes, doubles with NaN,
+-0, +-inf, subnormals, 17-digit values and exponents of +-300, floats,
booleans, and three text columns: integers of every width with the
texts that wrap the JAX package's int64 sum, doubles written by numpy's
shortest round trip (subnormals, exponents to +-400, mantissas of more
than 19 digits) and boolean words in mixed case, each with about a
quarter of its rows made malformed (`MALFORMED`: a sign alone, two
dots, `1e5e`, `e5`, `0x10`, `1_000`, full-width digits, a no-break
space, bytes <= 0x20 around the text).  About 15% of every column is
null.  Each route runs the same column through the JAX package's
function and the port's, evaluated directly: the same null mask and,
at every row (null slots too), the same bits, or for text the same
bytes up to each row's length and the same lengths.

The JAX package's behaviour that parts from Spark's is kept and pinned
by a test of its own (`test_*_keeps_*`).  The JAX package is imported
inside the functions that use it: tests/test_torch_cuda.py reuses the
table and the routes on a machine without JAX.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import TpuSession, tpch
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import Column
from spark_rapids_tpu_torch.ops import cast as PC
from spark_rapids_tpu_torch.plan import logical as PL

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N = 4096
FLOAT_KEY = "spark.rapids.sql.castStringToFloat.enabled"
TS_KEY = "spark.rapids.sql.castStringToTimestamp.enabled"
AGG_KEY = "spark.rapids.sql.variableFloatAgg.enabled"
# column -> its type's name in both packages
TYPES = {"i8": "byte", "i16": "short", "i32": "int", "i64": "long",
         "x": "double", "f": "float", "b": "boolean", "it": "string",
         "ft": "string", "bt": "string"}
_NUMBERS = ("i8", "i16", "i32", "i64", "f", "x")
# every route of this slice, (source column, target type): the text
# columns parsed to each type they are read as, every integral type
# and the boolean formatted, every number to a boolean and back
ROUTES = ([("it", t) for t in ("byte", "short", "int", "long", "double")]
          + [("ft", t) for t in ("float", "double", "long")]
          + [("bt", "boolean")]
          + [(c, "string") for c in ("i8", "i16", "i32", "i64", "b")]
          + [(c, "boolean") for c in _NUMBERS]
          + [("b", TYPES[c]) for c in _NUMBERS])

# malformed forms of a text, one applied to about a quarter of the rows
MALFORMED = [lambda s: "+", lambda s: "-", lambda s: s + ".5.5",
             lambda s: s + "e5e", lambda s: "e5", lambda s: "0x10",
             lambda s: s[:1] + "_000", lambda s: "１２",
             lambda s: s + "\xa0", lambda s: " \t" + s + "\n\x0b",
             lambda s: "\x01" + s + "\x1f", lambda s: s + " x",
             lambda s: "", lambda s: "   ", lambda s: "+-" + s,
             lambda s: s + "d", lambda s: s + "f", lambda s: "." + s + "."]
WRAPPING = ["9999999999999999999", "9223372036854775808",
            "-9223372036854775809", "18446744073709551616",
            "-9223372036854775808", "9223372036854775807", "0000000000000000007",
            "12345678901234567890", "+0", "-0", " +7 ", "007"]
FLOAT_TEXT = ["3.14159265358979323846", "-9223372036854775808", "1e23",
              "4.9e-324", "1e-400", "1e400", "-1e-308", "2.5e-310",
              "1.7976931348623157e308", "1.8e308", "0.1", ".5", "5.",
              "1E+3", "+nan", "-NaN", "Infinity", "-inf", "+INF", "-0",
              "1.0000000596046448", "3.4028235e38", "1e-45", "1e-40",
              "123456789012345678901234e-5", "1e+", "1e-", "1.e5", "-.5e-3"]
BOOL_WORDS = ["true", "t", "yes", "y", "1", "false", "f", "no", "n", "0"]


def _mixed_case(rng, words):
    """Each word with each letter upper-cased at p = 0.3."""
    return ["".join(ch.upper() if rng.random() < 0.3 else ch for ch in w)
            for w in words]


def table(seed: int = 20):
    """{column: (values, valid)} as numpy arrays, N rows; each column's
    first rows are its edge values, the rest drawn from the seed."""
    rng = np.random.default_rng(seed)
    cols = {}
    for name, dt in (("i8", np.int8), ("i16", np.int16), ("i32", np.int32),
                     ("i64", np.int64)):
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, N, dtype=dt, endpoint=True)
        small = rng.random(N) < 0.3
        v[small] = rng.integers(-1000, 1000, int(small.sum())).astype(dt)
        v[:6] = [info.min, info.max, 0, -1, 1, info.min + 1]
        cols[name] = v
    x = rng.normal(0, 1, N) * 10.0 ** rng.integers(-300, 300, N)
    x = np.where(rng.random(N) < 0.05, rng.random(N) * 1e-310, x)
    x[:12] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, -2.5e-310,
              2.2250738585072014e-308, 1.7976931348623157e308, 1e23, 0.1,
              0.30000000000000004]
    cols["x"] = x
    with np.errstate(over="ignore"):
        f = x.astype(np.float32)
    f[:4] = [np.nan, -0.0, 1e-45, 3.4028235e38]
    cols["f"] = f
    cols["b"] = rng.random(N) < 0.5
    # text: integers of every width, doubles, boolean words
    ints = np.concatenate([cols[c] for c in ("i8", "i16", "i32", "i64")]
                          ).astype(np.int64)
    it = [str(v) for v in rng.choice(ints, N)]
    it[:len(WRAPPING)] = WRAPPING
    doubles = rng.choice(x, N)
    doubles = np.where(rng.random(N) < 0.3, rng.normal(0, 1e4, N), doubles)
    ft = np.char.decode(doubles.astype("S32"), "ascii").tolist()
    big = rng.random(N) < 0.1  # exponents past the table
    ft = [f"{s}e{int(rng.integers(-400, 400))}" if b and "e" not in s
          and "n" not in s else s for s, b in zip(ft, big)]
    ft[:len(FLOAT_TEXT)] = FLOAT_TEXT
    bt = _mixed_case(rng, rng.choice(BOOL_WORDS, N).tolist())
    for col, start in ((it, len(WRAPPING)), (ft, len(FLOAT_TEXT)),
                       (bt, 0)):
        for r in np.flatnonzero(rng.random(N) < 0.25):
            if r >= start:
                col[r] = MALFORMED[r % len(MALFORMED)](col[r])
    bt[:8] = [" TRUE ", "yes", "N", "+7", "truE\t", "nO", "y es", "1 "]
    cols.update(it=np.array(it, dtype=object), ft=np.array(ft, dtype=object),
                bt=np.array(bt, dtype=object))
    return {k: (v, rng.random(N) >= 0.15) for k, v in cols.items()}


@pytest.fixture(scope="module")
def data():
    return table()


def port_column(data, name: str, device) -> Column:
    """Column `name` of `data` for the port alone, on `device`."""
    v, ok = data[name]
    dtype = PT.TYPES_BY_NAME[TYPES[name]]
    if dtype is PT.StringType:
        enc = np.array([s.encode("utf-8") for s in v])
        return Column.from_strings(enc, ok, len(v), device)
    return Column.from_numpy(v, ok, dtype, len(v), device)


def port_route(data, src: str, dst: str, device) -> Column:
    return PC.cast_column(port_column(data, src, device),
                          PT.TYPES_BY_NAME[dst])


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------

def _both(data, name: str):
    """(port Column, JAX Column) of column `name`: the same bytes for
    text (the port's read off the JAX package's)."""
    from test_torch_cast import columns
    return columns(data, name, TYPES)


def _given(column):
    from test_torch_cast import Given
    return Given(column)


def _jax_cast(jc, dst: str):
    from spark_rapids_tpu.ops import cast as JC
    from test_torch_cast import JAX_TYPES, JaxGiven
    return JC.Cast(JaxGiven(jc), JAX_TYPES[dst]).eval(None)


def _subnormal(x: np.ndarray) -> np.ndarray:
    return (x != 0) & (np.abs(x) < np.finfo(x.dtype).tiny)


def assert_bits(got: Column, want, given: Column = None):
    """Port column `got` equals JAX column `want` at every row: the same
    null mask and bits, or text bytes up to each length and lengths.
    XLA's CPU backend flushes subnormals to zero where the port keeps
    IEEE's, as the JVM does (test_torch_arithmetic.unflush): a float
    row may part only where the port holds a subnormal and the JAX
    package the zero of its sign, and a boolean of a float input `given`
    only where that input is subnormal, true in the port and false in
    the JAX package."""
    from test_torch_arithmetic import unflush
    from test_torch_cast import text_rows
    assert got.dtype.name == want.dtype.name
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    if got.dtype is PT.StringType:
        g_len, w_len = got.lengths.numpy(), np.asarray(want.lengths)
        assert np.array_equal(g_len, w_len)
        assert text_rows(got.data.numpy(), g_len) == text_rows(
            np.asarray(want.data), w_len)
        return
    g, w = got.data.numpy(), np.asarray(want.data)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    w = unflush(w, g)
    if given is not None and given.dtype.is_floating:
        sub = _subnormal(given.data.numpy())
        assert g[sub].all() and not w[sub].any()
        w = np.where(sub, g, w)
    if g.dtype.kind == "f":
        g, w = g.view(f"u{g.itemsize}"), w.view(f"u{w.itemsize}")
    bad = np.flatnonzero(g != w)
    assert not len(bad), (bad[:4], g[bad[:4]], w[bad[:4]])


def _text_cast(strings, to: str):
    """(port values, JAX values) of `strings` cast to `to`, None where
    null: floats as floats (bits compared by the caller's `==` on repr
    where it matters)."""
    from spark_rapids_tpu.columnar import Column as JColumn
    jc = JColumn.from_strings(strings)
    want = _jax_cast(jc, to)
    got = PC.cast_column(Column(
        torch.from_numpy(np.asarray(jc.data).copy()),
        torch.ones(len(strings), dtype=torch.bool), PT.StringType,
        torch.from_numpy(np.asarray(jc.lengths).copy())),
        PT.TYPES_BY_NAME[to])
    assert_bits(got, want)

    def vals(d, ok):
        return [v if o else None for v, o in zip(d, ok)]
    return (vals(got.data.tolist(), got.valid.tolist()),
            vals(np.asarray(want.data).tolist(),
                 np.asarray(want.valid).tolist()))


# --------------------------------------------------------------------------
# every route, column against column
# --------------------------------------------------------------------------

def test_the_table_holds_what_the_cases_need(data):
    for name, (_, valid) in data.items():
        assert 0.1 < 1 - valid.mean() < 0.2, name
    # some text of each kind parses and some does not, among valid rows
    for src, dst in (("it", "long"), ("ft", "double"), ("bt", "boolean")):
        ok = data[src][1]
        parsed = port_route(data, src, dst, "cpu").valid.numpy()[ok]
        assert 0.5 < parsed.mean() < 0.95, src
    x = data["x"][0]
    assert (np.abs(x) < 2.2250738585072014e-308).sum() > 50
    assert np.isnan(x).any() and np.isinf(x).any()


@pytest.mark.parametrize("src,dst", ROUTES,
                         ids=[f"{TYPES[s]}-{d}" for s, d in ROUTES])
def test_cast_route_equals_the_jax_route(src, dst, data):
    pc, jc = _both(data, src)
    got = PC.Cast(_given(pc), PT.TYPES_BY_NAME[dst]).eval(None)
    assert_bits(got, _jax_cast(jc, dst), pc)


def test_formatted_integers_are_no_wider_than_their_type_needs(data):
    """The port's text rows of byte, short, int and long are 8, 8, 16 and
    32 bytes, the JAX package's 24 for every type, with the same bytes
    up to each length (test_cast_route_equals_the_jax_route)."""
    widths = {}
    for c in ("i8", "i16", "i32", "i64", "b"):
        pc, jc = _both(data, c)
        widths[c] = (PC.cast_column(pc, PT.StringType).max_len,
                     np.asarray(_jax_cast(jc, "string").data).shape[1])
    assert widths == {"i8": (8, 24), "i16": (8, 24), "i32": (16, 24),
                      "i64": (32, 24), "b": (8, 8)}


# --------------------------------------------------------------------------
# the JAX package's behaviour the port keeps, each pinned
# --------------------------------------------------------------------------

def test_parse_integral_keeps_the_jax_package_s_wrap():
    """The digits sum in int64 and wrap; 19 digits pass the length check,
    so "9999999999999999999" is a long (Spark: null) and the type's
    range is checked after the wrap."""
    got, want = _text_cast(["9999999999999999999", "9223372036854775808",
                            "-9223372036854775808", "1.5"], "long")
    assert got == want == [-8446744073709551617, -2 ** 63, -2 ** 63, None]
    got, want = _text_cast(["9999999999999999999", "2147483648",
                            "-2147483648", "4294967296"], "int")
    assert got == want == [None, None, -2 ** 31, None]


def test_parse_integral_accepts_a_sign_and_1_to_19_digits():
    """It trims only bytes <= 0x20, so a no-break space and full-width
    digits are null; it accepts " +7 " and "007" and rejects "1.5", a
    sign alone, "" and more than 19 digits."""
    cases = {" +7 ": 7, "007": 7, "-0": 0, "\t-12\x00": -12, "1.5": None,
             "+": None, "-": None, "": None, "   ": None,
             "12345678901234567890": None, "0000000000000000001": 1,
             "12\xa0": None, "１２": None, "1_000": None, "0x10": None,
             "+-1": None, "1 2": None, "127": 127, "128": None,
             "-128": -128, "-129": None}
    got, want = _text_cast(list(cases), "byte")
    assert got == want == list(cases.values())


def _bits(values):
    return [None if v is None else np.float64(v).view(np.uint64).item()
            for v in values]


def test_parse_float_keeps_the_jax_package_s_arithmetic():
    """The mantissa's digits sum in int64 and wrap (a sign flips, more
    than 19 digits go astray), 10^23 is Python's 10.0 ** 23, and the
    scale stops at 10^308."""
    cases = {"-9223372036854775808": 9.223372036854776e18,
             "3.14159265358979323846": 0.005646161059169464,
             "1e23": 1.0000000000000001e23, "4.9e-324": 4.9e-307}
    got, want = _text_cast(list(cases), "double")
    assert _bits(got) == _bits(want) == _bits(cases.values())


def test_parse_float_keeps_the_jax_package_s_grammar():
    """`.5`, `5.`, `1E+3`, `+nan` and `Infinity` parse; `-0` is -0.0
    and `1e400` inf; `e5`, `1e5e`, `1.2.3`, `1d` and `2f` are null."""
    cases = {".5": 0.5, "5.": 5.0, "1E+3": 1000.0, "+nan": float("nan"),
             "Infinity": float("inf"), "-infinity": float("-inf"),
             "-0": -0.0, "25e-2": 0.25, "1e400": float("inf"),
             "0e999": 0.0, "e5": None, "1e5e": None, "1.2.3": None,
             "1d": None, "2f": None, "1e": None, "-": None, ".": None,
             " 7.25\n": 7.25}
    got, want = _text_cast(list(cases), "double")
    assert _bits(got) == _bits(want) == _bits(cases.values())


def test_parse_float_keeps_a_subnormal_result_where_xla_flushes_it():
    """A subnormal double or float result is IEEE's, where the JAX
    package's, under XLA, is the zero of its sign.  With the scale
    clipped at 10^308, "1e-400" is 1 / 10^308 = 1e-308 (JAX: 0.0, Spark:
    0.0); "1e-308" is 1e-308, as in Spark.  As floats, "1e-40" and
    "-1e-45" are the subnormal floats Spark gives."""
    got, want = _text_cast(["1e-308", "-1e-308", "1e-400", "1e-40"],
                           "double")
    assert _bits(got) == _bits([1e-308, -1e-308, 1e-308, 1e-40])
    assert _bits(want) == _bits([0.0, -0.0, 0.0, 1e-40])
    got, want = _text_cast(["1e-40", "-1e-45", "1.2e-38"], "float")
    f32 = [float(np.float32(v)) for v in (1e-40, -1e-45, 1.2e-38)]
    assert got == f32 and _subnormal(np.float32(f32[:2])).all()
    assert _bits(want) == _bits([0.0, -0.0, f32[2]])


def test_parse_float_as_a_float_rounds_the_double():
    """A float parses the double first and rounds that: "0.1" is
    float32(0.1), and "1.0000000596046448", whose double is the midpoint
    of two floats, rounds to even, 1.0 (straight to a float it would be
    the float above)."""
    got, want = _text_cast(["0.1", "1.0000000596046448", "3.5e38"],
                           "float")
    assert got == want == [float(np.float32(0.1)), 1.0, float("inf")]


def test_parse_bool_keeps_the_jax_package_s_words():
    """After the trim, the whole text one of true t yes y 1 / false f no
    n 0 in any case; "+7" and a word inside other text are null."""
    cases = {" TRUE ": True, "yes": True, "N": False, "+7": None,
             "FaLsE": False, "0": False, "1": True, "tru": None,
             "yes!": None, "y es": None, "\xa0y": None, "": None}
    got, want = _text_cast(list(cases), "boolean")
    assert got == want == list(cases.values())


def test_null_rows_come_out_zeroed():
    """A null input row's data is zero after a parse (mask_invalid), and
    formatted it keeps the text of zero: "0" and "false"."""
    from spark_rapids_tpu.columnar import Column as JColumn
    import jax.numpy as jnp
    from spark_rapids_tpu import types as JT
    jc = JColumn.from_strings(["12", None, "1.5"])
    pc = Column(torch.from_numpy(np.asarray(jc.data).copy()),
                torch.from_numpy(np.asarray(jc.valid).copy()), PT.StringType,
                torch.from_numpy(np.asarray(jc.lengths).copy()))
    for to in ("int", "double", "boolean"):
        got = PC.cast_column(pc, PT.TYPES_BY_NAME[to])
        assert_bits(got, _jax_cast(jc, to))
        assert got.data.tolist()[1] == 0
    for dtype, jt, v in ((PT.LongType, JT.LongType, np.int64),
                         (PT.BooleanType, JT.BooleanType, np.bool_)):
        z = np.zeros(2, v)
        ok = np.array([True, False])
        got = PC.cast_column(Column(torch.from_numpy(z), torch.from_numpy(ok),
                                    dtype), PT.StringType)
        assert_bits(got, _jax_cast(JColumn(jnp.asarray(z), jnp.asarray(ok),
                                           jt), "string"))
        assert bytes(got.data[1, :got.lengths[1]].tolist()) == (
            b"0" if dtype is PT.LongType else b"false")


def test_num_to_bool_keeps_the_jax_package_s_zeros():
    """NaN is true and -0.0 false; a subnormal is true, as in Spark and
    as `x != 0` in the port, where XLA reads it as zero (false)."""
    from spark_rapids_tpu.columnar import Column as JColumn
    import jax.numpy as jnp
    from spark_rapids_tpu import types as JT
    for v, pt, jt in ((np.float64, PT.DoubleType, JT.DoubleType),
                      (np.float32, PT.FloatType, JT.FloatType)):
        z = np.array([np.nan, -0.0, 0.0, 1e-45, -1e-39, -np.inf, 1.0,
                      5e-324], v)
        ok = np.ones(len(z), bool)
        pc = Column(torch.from_numpy(z), torch.from_numpy(ok), pt)
        got = PC.cast_column(pc, PT.BooleanType)
        want = _jax_cast(JColumn(jnp.asarray(z), jnp.asarray(ok), jt),
                         "boolean")
        assert_bits(got, want, pc)
        assert got.data.tolist() == [True, False, False, True, True, True,
                                     True, v is np.float64]
        # 1e-45 and -1e-39 are subnormal as floats, normal as doubles;
        # 5e-324 is a subnormal double and a float's zero
        wide = v is np.float64
        assert np.asarray(want.data).tolist() == [
            True, False, False, wide, wide, True, True, False]


def test_the_jax_plan_runs_the_integral_parse_on_its_device():
    """The JAX package does not gate string -> integral casts, so its
    plan parses on its device: the wrapped value of
    "9999999999999999999", where its CPU executor gives null; the port
    gives the device's."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    from spark_rapids_tpu.plan import logical as JL
    texts = ["9999999999999999999", "12"]
    want = JaxSession({}).from_pydict(
        {"s": texts}, JT.Schema([JT.StructField("s", JT.StringType)])
    ).select(JL.col("s").cast("long").alias("x")).collect()
    got = TpuSession(device="cpu").from_numpy(
        {"s": np.array(texts, dtype="S")},
        PT.Schema([PT.StructField("s", PT.StringType)])
    ).select(PL.col("s").cast("long").alias("x")).collect()
    assert got == want == [(-8446744073709551617,), (12,)]


def test_string_to_double_placement_is_the_jax_package_s():
    """With castStringToFloat false the JAX package runs the cast on its
    CPU executor, whose answer for "-9223372036854775808" keeps the sign
    (as Spark's), and the port refuses the plan; with the key true both
    run the device parse, whose sign flips."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    from spark_rapids_tpu.plan import logical as JL
    texts = ["-9223372036854775808"]

    def jax_rows(conf):
        return JaxSession(conf).from_pydict(
            {"s": texts}, JT.Schema([JT.StructField("s", JT.StringType)])
        ).select(JL.col("s").cast("double").alias("x")).collect()

    def port(conf):
        return TpuSession(conf, device="cpu").from_numpy(
            {"s": np.array(texts, dtype="S")},
            PT.Schema([PT.StructField("s", PT.StringType)])
        ).select(PL.col("s").cast("double").alias("x"))
    assert jax_rows({}) == [(-9.223372036854776e18,)]
    with pytest.raises(NotImplementedError, match=FLOAT_KEY):
        port({}).physical_plan()
    on = {FLOAT_KEY: "true"}
    assert port(on).collect() == jax_rows(on) == [(9.223372036854776e18,)]


# --------------------------------------------------------------------------
# the planner: coerce_pair's casts, the literal fold and the gates
# --------------------------------------------------------------------------

def _dsl_frames(data, conf):
    """The table's columns (past the edge rows, whose extremes have no
    Python float to collect bit for bit) in both packages."""
    from test_torch_cast import jax_df, port_df
    cut = {k: (v[16:], ok[16:]) for k, (v, ok) in data.items()}
    return (jax_df(cut, conf, TYPES),
            port_df(TpuSession(dict(conf), device="cpu"), cut, TYPES))


def _coerced(a):
    c, lit = a.col, a.lit
    return [(c("i8") == " 2 ").alias("byte_eq_lit"),
            (c("i16") > lit("-5")).alias("short_gt_lit"),
            (c("it") > c("i64")).alias("text_gt_long"),
            (c("it") + 1).alias("text_plus_1"),
            (c("i16") - c("it")).alias("short_minus_text"),
            (c("b") == c("bt")).alias("bool_eq_text"),
            (c("b") == "yes").alias("bool_eq_lit"),
            (c("x") < "1.5").alias("double_lt_lit"),
            (c("f") >= c("ft")).alias("float_ge_text"),
            (c("ft") * 2).alias("text_times_2")]


def test_coerced_casts_and_folds_give_the_jax_rows(data):
    """coerce_pair casts a string side to the number or boolean on the
    other side, a string literal folded (castStringToFloat set in both
    sessions)."""
    jdf, pdf = _dsl_frames(data, {FLOAT_KEY: "true"})
    from spark_rapids_tpu.plan import logical as JL
    from test_torch_expressions import Api
    want = jdf.select(*_coerced(Api(JL))).collect()
    got = pdf.select(*_coerced(Api(PL))).collect()
    assert len(got) == N - 16
    # the comparisons hold in some rows
    assert all(any(r[k] for r in got) for k in (0, 1, 2, 7, 8))
    # float_ge_text: XLA reads a subnormal float as zero, where the port
    # keeps IEEE's subnormals: the rows whose float or whose text parsed
    # as a float is subnormal, and only those, may part
    k = 8
    f, f_ok = data["f"][0][16:], data["f"][1][16:]
    ft = port_route({"ft": (data["ft"][0][16:], data["ft"][1][16:])},
                    "ft", "float", "cpu")
    sub = f_ok & (_subnormal(f) | _subnormal(ft.data.numpy()))
    parted = [i for i, (g, w) in enumerate(zip(got, want)) if g[k] != w[k]]
    assert sub.any() and set(parted) <= set(np.flatnonzero(sub))
    assert _same_rows([r[:k] + r[k + 1:] for r in got],
                      [r[:k] + r[k + 1:] for r in want])


def _same_rows(got, want) -> bool:
    """Equal rows, floats by bits (NaN equal to NaN)."""
    def key(v):
        return ("f", np.float64(v).view(np.uint64).item()) \
            if isinstance(v, float) else v
    return [tuple(map(key, r)) for r in got] == \
        [tuple(map(key, r)) for r in want]


FOLD_TEXTS = (["2", " +2 ", "2.0", "-0", "1.5", "yes", "N", "", "1e23",
               "9999999999999999999", "nan", "1e-400", "\xa02"]
              + WRAPPING + FLOAT_TEXT)


@pytest.mark.parametrize("to", ["byte", "int", "long", "float", "double",
                                "boolean", "date", "timestamp"])
def test_the_fold_equals_the_column_cast(to):
    """A string literal's cast, folded on the CPU when the Cast is made,
    gives what the cast of a column holding the same text gives, and
    evaluates as that literal over a batch."""
    raw = np.array([t.encode("utf-8") for t in FOLD_TEXTS])
    dtype = PT.TYPES_BY_NAME[to]
    col = PC.cast_column(Column.from_strings(raw, None, len(raw), "cpu"),
                         dtype)
    column = [v if ok else None for v, ok in
              zip(col.data.tolist(), col.valid.tolist())]
    folded = [PC.fold_string(t, dtype) for t in FOLD_TEXTS]
    assert _same_rows([tuple(folded)], [tuple(column)])
    from spark_rapids_tpu_torch.ops.expressions import Literal
    batch = TpuSession(device="cpu").from_numpy(
        {"k": np.zeros(3, np.int32)}).plan.table
    for t, v in zip(FOLD_TEXTS, folded):
        out = PC.Cast(Literal(t), dtype).eval(batch)
        assert out.valid.tolist() == [v is not None] * batch.capacity
        if v is not None:
            assert _same_rows([(out.data[0].item(),)], [(v,)])


@pytest.mark.parametrize("build,key", [
    (lambda a: a.col("ft").cast("double"), FLOAT_KEY),
    (lambda a: a.col("bt").cast("float"), FLOAT_KEY),
    (lambda a: a.col("x") < "1.5", FLOAT_KEY),
    (lambda a: a.lit("1.5").cast("double"), FLOAT_KEY),
    (lambda a: a.col("ft") / a.col("x"), FLOAT_KEY),
    (lambda a: a.lit("1994-08-23").cast("timestamp"), TS_KEY),
    (lambda a: a.col("i64").cast("timestamp")
     > a.lit("1994-08-23 12:00:00"), TS_KEY)], ids=["column-double", "column-float", "double-lt-literal",
                    "literal-double", "text-divided-by-double",
                    "literal-timestamp", "literal-timestamp-in-a-tree"])
def test_a_gated_cast_raises_naming_its_key_even_folded(build, key, data):
    """string -> float or double and string -> timestamp raise at planning
    unless their key is true, when the string is a literal folded at
    analysis too; with the key the plan runs."""
    from test_torch_cast import port_df
    from test_torch_expressions import Api
    off = port_df(TpuSession(device="cpu"), data, TYPES)
    with pytest.raises(NotImplementedError, match=key):
        off.select(build(Api(PL)).alias("x")).physical_plan()
    with pytest.raises(NotImplementedError, match=key):
        off.filter(build(Api(PL)).is_not_null()).collect()
    on = port_df(TpuSession({key: "true"}, device="cpu"), data, TYPES)
    assert len(on.select(build(Api(PL)).alias("x")).collect()) == N


# --------------------------------------------------------------------------
# tpch.TEXT_QUERIES
# --------------------------------------------------------------------------

_CONF = {AGG_KEY: "true", FLOAT_KEY: "true"}


def _jax_text_query(name, li):
    """tpch.TEXT_QUERIES[name] written in the JAX package's DSL."""
    from spark_rapids_tpu.plan import logical as JL
    F, col, lit = JL.functions, JL.col, JL.lit
    if name == "q1_text":
        from benchmarks.tpch.queries import QUERIES
        li = li.select(col("l_returnflag"), col("l_linestatus"),
                       col("l_shipdate"),
                       col("l_quantity").cast("int").alias("l_quantity"),
                       *[col(k).cast("double").alias(k) for k in
                         ("l_extendedprice", "l_discount", "l_tax")])
        return QUERIES[1]({"lineitem": li})
    key = col("l_orderkey")
    return li.agg(
        F.count(lit(1)).alias("lines"),
        F.sum((key.cast("string").cast("long") == key).cast("int"))
        .alias("keys_back"),
        F.sum((col("l_quantity") > 24).cast("string").cast("boolean")
              .cast("long")).alias("over_24"),
        F.count(col("l_returnflag").cast("boolean")).alias("flags_read"))


def _jax_lineitem():
    """The JAX package's SF0.01 lineitem as numpy arrays (tpch.LINEITEM's
    columns)."""
    from benchmarks.tpch import generate
    li = generate(0.01)["lineitem"]
    return {f.name: (np.array(li[f.name], dtype="S") if f.dtype.is_string
                     else np.array(li[f.name], dtype=f.dtype.np_dtype))
            for f in tpch.LINEITEM}


def test_text_queries_rows_equal_the_jax_package():
    """At SF0.01 of the JAX package's generator, both packages' rows of
    each of tpch.TEXT_QUERIES: q1_text over the text tpch.text_lineitem
    makes of it, text_roundtrip over the lineitem itself."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    from compare import assert_rows_equal
    t = _jax_lineitem()
    tables = {"lineitem": t, "lineitem_text": tpch.text_lineitem(t)}
    schemas = {"lineitem": tpch.LINEITEM,
               "lineitem_text": tpch.LINEITEM_TEXT}
    s = TpuSession(dict(_CONF), device="cpu")
    js = JaxSession(dict(_CONF))
    for name, rows in (("q1_text", 6), ("text_roundtrip", 1)):
        table = tables[tpch.TEXT_INPUTS[name]]
        schema = schemas[tpch.TEXT_INPUTS[name]]
        jdf = js.from_pydict(
            {f.name: (np.char.decode(table[f.name], "utf-8").tolist()
                      if f.dtype.is_string else table[f.name].tolist())
             for f in schema},
            JT.Schema([JT.StructField(f.name, _jax_type(f.dtype))
                       for f in schema]))
        want = _jax_text_query(name, jdf).collect()
        got = tpch.TEXT_QUERIES[name](s.from_numpy(table, schema)).collect()
        assert len(got) == rows
        assert_rows_equal(want, got, ignore_order=False)
        assert tpch.rows_match(tpch.ORACLES[name](t), got), name


def _jax_type(dtype):
    from spark_rapids_tpu import types as JT
    return {t.name: t for t in JT.ALL_TYPES}[dtype.name]


@pytest.mark.parametrize("name", list(tpch.TEXT_QUERIES))
def test_text_query_matches_the_numpy_oracle(name):
    """The port's own generator and oracle (what chip_smoke.py runs at
    SF10), over several batches; q1_text's sum_qty is an integer."""
    t = tpch.generate_lineitem(0.004)
    tables = {"lineitem": t, "lineitem_text": tpch.text_lineitem(t)}
    schemas = {"lineitem": tpch.LINEITEM,
               "lineitem_text": tpch.LINEITEM_TEXT}
    s = TpuSession(dict(_CONF, **{
        "spark.rapids.sql.reader.batchSizeRows": "3000"}), device="cpu")
    src = tpch.TEXT_INPUTS[name]
    got = tpch.TEXT_QUERIES[name](s.from_numpy(tables[src],
                                               schemas[src])).collect()
    want = tpch.ORACLES[name](t)
    assert got and tpch.rows_match(want, got)
    if name == "q1_text":
        assert all(isinstance(r[2], int) for r in got)
        assert [r[2] for r in got] == [r[2] for r in want]


def test_text_lineitem_parses_back_to_the_generator_s_doubles():
    """Each text number of tpch.text_lineitem (8 bytes at most) parses,
    through the port's cast, to exactly the generator's value."""
    t = tpch.generate_lineitem(0.002)
    text = tpch.text_lineitem(t)
    for k, to in (("l_quantity", PT.IntegerType),
                  ("l_extendedprice", PT.DoubleType),
                  ("l_discount", PT.DoubleType), ("l_tax", PT.DoubleType)):
        assert text[k].dtype.itemsize <= 8, k
        c = PC.cast_column(Column.from_strings(text[k], None, len(text[k]),
                                               "cpu"), to)
        assert bool(c.valid.all()), k
        assert np.array_equal(c.data.numpy().astype(np.float64), t[k]), k
