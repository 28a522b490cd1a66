"""The port's bitwise expressions (BitwiseAnd/Or/Xor/Not, ShiftLeft,
ShiftRight, ShiftRightUnsigned) and math expressions
(spark_rapids_tpu_torch/ops/math.py) against the JAX package's, their
DSL entries, and the trees the JAX package cannot evaluate.

One seeded numpy table of N rows (`table`): byte, short, int and long
columns whose first rows are each type's extremes; two doubles whose
first rows pair every special value with every other (NaN, +-0, +-inf,
+-1, 0.5, -2.5, 2, a subnormal), then NaN, +-1e19, subnormals, values a
bit off +-1, and values on the x.5 boundaries of the round scales;
their float; two booleans; a date and a timestamp; and shift counts:
an int of -70..70 (every width's edge), a long beyond the int range, a
byte, and a double with fractions, NaN and infinities.  About 10% of
every column past the edge rows is null.

Each case evaluates one class of each package directly over a batch
holding the same columns.  Bitwise, shifts, Floor, Ceil, Rint, Round,
BRound, Signum, Sqrt, ToDegrees and ToRadians must give the same null
mask and the same bits on every row (null slots too; any NaN equal to
any NaN).  The transcendental classes (Cbrt, Exp, Expm1, the logs,
trig and hyperbolic functions, Pow, Atan2, Hypot, Cot, Logarithm) must
give the same null mask, NaN and infinite positions, and, where both
are finite, values within REL (1e-13, relative).  XLA's CPU backend
reads a subnormal input as zero and flushes a subnormal result to zero
where the port keeps IEEE's values; a row may part only there
(`flushed`), and each case that holds such rows asserts which.

The JAX package's behaviour that parts from Spark's is kept and pinned
by a test of its own (`test_*_keeps_*`).  The JAX package is imported
inside the functions that use it: tests/test_torch_cuda.py reuses the
table and the cases on a machine without JAX.
"""
import math
import os

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch_from_numpy
from spark_rapids_tpu_torch.ops import expressions as PE
from spark_rapids_tpu_torch.ops import math as PM
from spark_rapids_tpu_torch.plan import logical as PL


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Under xdist, one torch thread a worker: six workers each running an
    intra-op pool over every core slow one another down."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

N = 2048
REL = 1e-13
TYPES = {"i8": "byte", "i16": "short", "i32": "int", "i64": "long",
         "x": "double", "x2": "double", "f": "float", "b": "boolean",
         "b2": "boolean", "d": "date", "t": "timestamp", "n": "int",
         "nl": "long", "n8": "byte", "xc": "double"}
COLUMNS = list(TYPES)
_NP = {"byte": np.int8, "short": np.int16, "int": np.int32,
       "long": np.int64, "double": np.float64, "float": np.float32,
       "boolean": np.bool_, "date": np.int32, "timestamp": np.int64}
# every special double against every other (x against x2)
SPECIAL = [np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 0.5, -2.5, 2.0,
           5e-324]
EDGES = [-np.nan, 1e19, -1e19, 5e-324, -2.5e-310, 1e-310,
         2.2250738585072014e-308, np.nextafter(1.0, 2.0),
         np.nextafter(1.0, 0.0), -np.nextafter(1.0, 2.0),
         -np.nextafter(1.0, 0.0), 1.5, 2.5, -0.5, 0.125, 0.375, 1.005,
         2.675, 0.15, 12345.5, -12345.5, 4503599627370495.5, 710.0,
         -710.0, 709.9, 1e308, -1e308, 1.7976931348623157e308,
         math.pi, math.pi / 2, 1e-16, 8.0, -27.0, 1e22, 1e-306, -745.5,
         9.223372036854775807e18, -9.223372036854775808e18, 1e-40]
SHIFT_COUNTS = [0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, -1,
                -8, -32, -64, 70, -70]
LONG_COUNTS = [2 ** 32 + 5, -2 ** 40 - 1, 2 ** 63 - 1, -2 ** 63, 64, 0,
               2 ** 31, -2 ** 31 - 1]
FLOAT_COUNTS = [-1e-20, 0.0, -0.0, np.nan, np.inf, -np.inf, 31.9, 32.0,
                63.5, -0.5, 64.0, 1e19, -70.7, 7.999999, 8.0]
N_EDGE = len(SPECIAL) ** 2 + len(EDGES)


def table(seed: int = 21):
    """{column: (values, valid)} as numpy arrays, N rows, null slots
    holding zeros (as both packages store them)."""
    rng = np.random.default_rng(seed)
    cols = {}
    for name in ("i8", "i16", "i32", "i64", "n8"):
        dt = _NP[TYPES[name]]
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, N, dtype=dt, endpoint=True)
        small = rng.random(N) < 0.3
        v[small] = rng.integers(-1000, 1000, int(small.sum())).astype(dt)
        v[:8] = [info.min, info.max, 0, -1, 1, info.min + 1, 7, -7]
        cols[name] = v
    k = len(SPECIAL) ** 2

    def doubles():
        pick = rng.random(N)
        half = ((rng.integers(-10 ** 6, 10 ** 6, N) + 0.5)
                / 10.0 ** rng.integers(0, 5, N))
        return np.where(pick < 0.3, half, np.where(
            pick < 0.6, rng.uniform(-50, 50, N),
            rng.normal(0, 1, N) * 10.0 ** rng.integers(-30, 30, N)))
    x, x2 = doubles(), doubles()
    x[:k] = np.repeat(SPECIAL, len(SPECIAL))
    x2[:k] = np.tile(SPECIAL, len(SPECIAL))
    x[k:N_EDGE] = EDGES
    x2[k:N_EDGE] = EDGES[::-1]
    cols["x"], cols["x2"] = x, x2
    with np.errstate(over="ignore"):
        cols["f"] = x.astype(np.float32)
    cols["b"] = rng.random(N) < 0.5
    cols["b2"] = rng.random(N) < 0.5
    cols["d"] = rng.integers(-150_000, 150_000, N).astype(np.int32)
    cols["t"] = rng.integers(-2 ** 62, 2 ** 62, N)
    n = rng.integers(-70, 71, N).astype(np.int32)
    n[:len(SHIFT_COUNTS)] = SHIFT_COUNTS
    cols["n"] = n
    nl = rng.integers(-2 ** 63, 2 ** 63 - 1, N, dtype=np.int64)
    nl[:len(LONG_COUNTS)] = LONG_COUNTS
    cols["nl"] = nl
    xc = rng.uniform(-70, 70, N)
    xc[:len(FLOAT_COUNTS)] = FLOAT_COUNTS
    cols["xc"] = xc
    out = {}
    for name in COLUMNS:
        valid = rng.random(N) >= 0.1
        valid[:N_EDGE] = True
        v = cols[name]
        out[name] = (np.where(valid, v, np.zeros((), v.dtype)).astype(
            v.dtype), valid)
    return out


# --------------------------------------------------------------------------
# the cases: (class name, operands), an operand a column or ("lit", value)
# --------------------------------------------------------------------------

BITWISE = ["BitwiseAnd", "BitwiseOr", "BitwiseXor"]
SHIFTS = ["ShiftLeft", "ShiftRight", "ShiftRightUnsigned"]
UNARY = ["Sqrt", "Cbrt", "Exp", "Expm1", "Log", "Log2", "Log10", "Log1p",
         "Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh",
         "Tanh", "Asinh", "Acosh", "Atanh", "ToDegrees", "ToRadians",
         "Signum", "Rint", "Cot"]
BINARY = ["Pow", "Atan2", "Hypot", "Logarithm"]
# the classes held bit for bit; the rest within REL
EXACT = set(BITWISE + SHIFTS + ["BitwiseNot", "Floor", "Ceil", "Rint",
                                "Round", "BRound", "Signum", "Sqrt",
                                "ToDegrees", "ToRadians"])

_BITWISE_PAIRS = [("i32", "n"), ("i64", "nl"), ("i8", "i16"), ("i32", "i64"),
                  ("n8", "i8"), ("b", "b2"), ("d", "d"), ("i64", ("lit", -1)),
                  (("lit", 0x0F), "i8")]
_SHIFT_PAIRS = [("i8", "n"), ("i16", "n"), ("i32", "n"), ("i64", "n"),
                ("i32", "nl"), ("i64", "nl"), ("i8", "nl"), ("i16", "n8"),
                ("i64", "n8"), ("i32", "xc"), ("i64", "xc"), ("i8", "xc"),
                ("d", "n"), ("t", "n"), ("b", "n"), ("b", "b2"),
                ("b", "xc"), ("i32", "b"), ("i32", ("lit", 33)),
                ("i64", ("lit", -1)), (("lit", -8), "n")]
_BINARY_PAIRS = [("x", "x2"), ("x", "i32"), ("f", "i32"), ("i64", ("lit", 2)),
                 (("lit", 10.0), "x"), ("f", "x"), ("b", "b2")]
_ROUND_SCALES = {"x": [0, 1, 2, 3, 10, -1, -2, 300, -300, 308],
                 "f": [0, 1, 2, -1, 40],
                 "i8": [0, 2, -1, -2, -3], "i16": [-1, -3, -4, -5],
                 "i32": [5, -1, -2, -5, -9, -10],
                 "i64": [0, -1, -2, -9, -18, -19, -20],
                 "b": [0, -1], "d": [-2, 1], "t": [-3, 2]}


def _label(x) -> str:
    return x if isinstance(x, str) else f"lit({x[1]!r})"


CASES = {}
for _op in BITWISE:
    CASES.update({f"{_op}-{_label(a)}-{_label(b)}": (_op, (a, b))
                  for a, b in _BITWISE_PAIRS})
CASES.update({f"BitwiseNot-{c}": ("BitwiseNot", (c,))
              for c in ("i8", "i16", "i32", "i64", "b", "d")})
for _op in SHIFTS:
    CASES.update({f"{_op}-{_label(a)}-{_label(b)}": (_op, (a, b))
                  for a, b in _SHIFT_PAIRS})
CASES.update({f"{_op}-{c}": (_op, (c,)) for _op in UNARY
              for c in ("x", "f", "i64")})
CASES.update({f"{_op}-{c}": (_op, (c,)) for _op in ("Floor", "Ceil")
              for c in ("x", "f", "i32", "b", "d")})
for _op in BINARY:
    CASES.update({f"{_op}-{_label(a)}-{_label(b)}": (_op, (a, b))
                  for a, b in _BINARY_PAIRS})
for _op in ("Round", "BRound"):
    CASES.update({f"{_op}-{c}-{s}": (_op, (c, ("lit", s)))
                  for c, scales in _ROUND_SCALES.items() for s in scales})


def build(E, M, T, case):
    """The case's expression in one package: E its expressions module, M
    its math module, T its types module."""
    op, operands = CASES[case]

    def operand(x):
        if isinstance(x, str):
            return E.BoundReference(COLUMNS.index(x),
                                    _type(T, TYPES[x]), x)
        return E.Literal(x[1])
    cls = getattr(M, op, None) or getattr(E, op)
    return cls(*[operand(x) for x in operands])


def _type(T, name: str):
    return {t.name: t for t in (
        T.BooleanType, T.ByteType, T.ShortType, T.IntegerType, T.LongType,
        T.FloatType, T.DoubleType, T.DateType, T.TimestampType,
        T.StringType)}[name]


def port_schema():
    return PT.Schema([PT.StructField(n, _type(PT, TYPES[n]))
                      for n in COLUMNS])


def port_batch(data, device="cpu"):
    return batch_from_numpy([data[n] for n in COLUMNS], np.ones(N, bool),
                            port_schema(), device=device)


def port_eval(data, case, device="cpu"):
    """(type name, data, valid) of the case on a port batch of `data`,
    as numpy arrays."""
    out = build(PE, PM, PT, case).eval(port_batch(data, device))
    return (out.dtype.name, out.data.cpu().numpy(),
            out.valid.cpu().numpy())


def jax_eval(data, case):
    import jax.numpy as jnp
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.columnar import Column as JColumn
    from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
    from spark_rapids_tpu.ops import expressions as JE
    from spark_rapids_tpu.ops import math as JM
    schema = JT.Schema([JT.StructField(n, _type(JT, TYPES[n]))
                        for n in COLUMNS])
    batch = JBatch([JColumn(jnp.asarray(data[n][0]), jnp.asarray(data[n][1]),
                            _type(JT, TYPES[n])) for n in COLUMNS],
                   jnp.ones(N, dtype=jnp.bool_), schema)
    out = build(JE, JM, JT, case).eval(batch)
    return out.dtype.name, np.asarray(out.data), np.asarray(out.valid)


def subnormal(x: np.ndarray) -> np.ndarray:
    if x.dtype.kind != "f":
        return np.zeros(x.shape, bool)
    return (x != 0) & (np.abs(x) < np.finfo(x.dtype).tiny)


def flushed(data, case, got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """The rows where XLA's flush may part the packages: a float operand
    is subnormal (XLA reads zero), or the port's result is subnormal
    where the JAX package's is the zero of its sign."""
    rows = np.zeros(N, bool)
    for x in CASES[case][1]:
        if isinstance(x, str):
            rows |= subnormal(data[x][0])
        elif isinstance(x[1], float):
            rows |= subnormal(np.asarray([x[1]]))
    if got.dtype.kind == "f" and want.dtype == got.dtype:
        # a result at the subnormal range's edge where the JAX package
        # has a zero of either sign (an intermediate flushed)
        edge = 2.0 ** (-1020 if got.dtype == np.float64 else -124)
        rows |= (np.abs(got) < edge) & (want == 0)
    return rows


def parted(case, got, want, exact: bool) -> np.ndarray:
    """The rows where port result `got` and JAX result `want` (type,
    data, valid) differ under the case's rule."""
    g, w = got[1], want[1]
    if g.dtype == np.bool_ and w.dtype.kind == "i":
        # a boolean shift: jnp's int64 under the boolean type, which its
        # collect reads as not zero
        w = w != 0
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    bad = got[2] != want[2]
    if g.dtype.kind != "f":
        return bad | (g != w)
    nan = np.isnan(g) & np.isnan(w)
    if exact:
        u = f"u{g.itemsize}"
        return bad | ~(nan | (g.view(u) == w.view(u)))
    fin = np.isfinite(g) & np.isfinite(w)
    with np.errstate(invalid="ignore", over="ignore"):
        rel = np.abs(g - w) / np.maximum(np.abs(w), np.finfo(w.dtype).tiny)
    same_class = nan | (g == w) | fin
    return bad | ~same_class | (fin & (rel > REL))


@pytest.fixture(scope="module")
def data():
    return table()


def test_the_table_holds_what_the_cases_need(data):
    for name, (v, valid) in data.items():
        assert 0.05 < 1 - valid.mean() < 0.15, name
        live = v[valid]
        if v.dtype.kind == "i" and name not in ("d", "t", "n", "nl"):
            info = np.iinfo(v.dtype)
            assert info.min in live and info.max in live and 0 in live
    x, x2 = data["x"][0], data["x2"][0]
    pairs = {(a.tobytes(), b.tobytes()) for a, b in zip(x, x2)}
    assert all((np.float64(a).tobytes(), np.float64(b).tobytes()) in pairs
               for a in SPECIAL for b in SPECIAL)
    assert subnormal(x).sum() >= 4 and subnormal(data["f"][0]).any()
    assert set(SHIFT_COUNTS) <= set(data["n"][0].tolist())
    # values on the x.5 boundaries of the round scales
    for s in (0, 1, 2):
        y = x[np.isfinite(x) & (np.abs(x) < 1e300)] * 10.0 ** s
        assert np.sum(y - np.floor(y) == 0.5) > 20, s


@pytest.mark.parametrize("case", list(CASES))
def test_expression_equals_the_jax_package(case, data):
    """Every case: the same type and null mask; exact classes bit for
    bit, the others within REL; only flushed rows part."""
    want = jax_eval(data, case)
    got = port_eval(data, case)
    assert got[0] == want[0]
    bad = parted(case, got, want, CASES[case][0] in EXACT)
    allowed = flushed(data, case, got[1], want[1])
    assert not np.any(bad & ~allowed), (
        case, [(i, data["x"][0][i], got[1][i], want[1][i], got[2][i],
                want[2][i]) for i in np.flatnonzero(bad & ~allowed)[:5]])
    # every parted row is one XLA flushes (named, and asserted as such)
    for i in np.flatnonzero(bad):
        assert allowed[i], i


# --------------------------------------------------------------------------
# the JAX quirks the port keeps, each pinned
# --------------------------------------------------------------------------

def _one(op, values, dtype="double", *extra):
    """Port class `op` of a one-column batch of `values` (no nulls) and
    any literal arguments `extra`: (values as a list, valid)."""
    t = _type(PT, dtype)
    batch = batch_from_numpy([(np.array(values, dtype=_NP[dtype]),
                               np.ones(len(values), bool))],
                             np.ones(len(values), bool),
                             PT.Schema([PT.StructField("v", t)]),
                             device="cpu")
    cls = getattr(PM, op, None) or getattr(PE, op)
    out = cls(PE.BoundReference(0, t), *[PE.Literal(e) for e in extra]) \
        .eval(batch)
    n = len(values)
    return out.data[:n].tolist(), out.valid[:n].tolist()


def test_floor_and_ceil_keep_the_jax_package_s_saturation():
    """A floating child goes to a long as jnp converts: NaN to 0, +inf
    and 1e19 to the long maximum, -inf and -1e19 to its minimum (Spark
    gives the same saturation, and 0 for NaN)."""
    lo, hi = -2 ** 63, 2 ** 63 - 1
    vals = [np.nan, np.inf, 1e19, -np.inf, -1e19, -0.5, 2.5]
    assert _one("Floor", vals)[0] == [0, hi, hi, lo, lo, -1, 2]
    assert _one("Ceil", vals)[0] == [0, hi, hi, lo, lo, 0, 3]
    assert _one("Floor", vals, "float")[0] == [0, hi, hi, lo, lo, -1, 2]


def test_signum_keeps_nan_and_negative_zero():
    got = _one("Signum", [np.nan, -0.0, 0.0, -3.0, 5e-324])[0]
    assert math.isnan(got[0])
    assert [math.copysign(1, v) for v in got[1:3]] == [-1.0, 1.0]
    assert got[1:] == [0.0, 0.0, -1.0, 1.0]


def test_byte_and_short_shift_within_8_and_16_bits():
    """The count is taken modulo the left type's width: a byte shifted
    by 9 moves 1 bit, a short by 17 moves 1 (Spark's shifts widen a byte
    or short to an int first, so its counts wrap at 32)."""
    assert _one("ShiftLeft", [1, -128], "byte", 9)[0] == [2, 0]
    assert _one("ShiftLeft", [1], "short", 17)[0] == [2]
    assert _one("ShiftRight", [-128], "byte", 15)[0] == [-1]
    # a byte read as an unsigned int, sign-extended, shifted, wrapped back
    assert _one("ShiftRightUnsigned", [-128, -1], "byte", 1)[0] == [-64, -1]
    assert _one("ShiftRightUnsigned", [-1], "long", 64)[0] == [-1]
    assert _one("ShiftRightUnsigned", [-1], "long", 1)[0] == [2 ** 63 - 1]


def test_a_long_shift_count_wraps_to_int32():
    """ShiftLeft and ShiftRight convert the count to the left type
    first: a long count of 2^32 + 5 shifts an int by 5 (Spark's count
    is an int)."""
    got = _one("ShiftLeft", [1], "int", 2 ** 32 + 5)[0]
    assert got == [32]
    # ShiftRightUnsigned takes the count modulo 32 in the count's type
    assert _one("ShiftRightUnsigned", [-1], "int", 2 ** 32 + 5)[0] == [
        2 ** 27 - 1]


def test_round_of_an_integral_past_its_digits_keeps_the_jax_zero():
    """Round at a negative scale whose 10^-scale exceeds the type's
    maximum gives 0 (as Spark's BigDecimal), and a scale within the
    digits rounds by floor division in the type."""
    assert _one("Round", [127, -128, 55], "byte", -3)[0] == [0, 0, 0]
    assert _one("Round", [125, -125, 55], "byte", -1)[0] == [-126, 126, 60]
    assert _one("BRound", [25, 35, -25], "int", -1)[0] == [20, 40, -20]
    assert _one("Round", [2 ** 63 - 1], "long", -19)[0] == [0]


def test_round_of_a_float_stays_a_float_rounded_in_double():
    got = _one("Round", [2.5, 0.125, np.inf], "float", 2)
    assert got[0][:2] == [np.float32(2.5), np.float32(0.13)]
    assert got[0][2] == np.inf


def test_a_boolean_shift_is_true_where_jnp_s_int64_is_not_zero(data):
    """jnp shifts a boolean as an int64 and leaves that under the
    boolean type; collect reads it as not zero, which the port holds:
    ShiftLeft(b, n) is b, ShiftRight(b, n) is b where n is 0."""
    (b, b_ok), (n, n_ok) = data["b"], data["n"]
    ok = b_ok & n_ok
    for op, want in (("ShiftLeft", b), ("ShiftRight", b & (n == 0))):
        _, got, valid = port_eval(data, f"{op}-b-n")
        assert np.array_equal(valid, ok)
        assert np.array_equal(got, want & ok), op
        assert np.array_equal(jax_eval(data, f"{op}-b-n")[1] != 0,
                              want & ok), op


# --------------------------------------------------------------------------
# the DSL: select, with_column and group_by through both planners
# --------------------------------------------------------------------------

class Api:
    """One package's DSL: its functions, col, lit and ColumnExpr."""

    def __init__(self, logical):
        self.F = logical.functions
        self.col = logical.col
        self.lit = logical.lit
        self.E = logical.ColumnExpr


def _dsl(a):
    F, c = a.F, a.col
    return [F.sqrt(c("x")).alias("sqrt"), F.exp(c("x")).alias("exp"),
            F.log(c("x")).alias("log"), F.pow(c("x"), 2).alias("pow"),
            F.floor(c("x")).alias("floor"), F.ceil(c("f")).alias("ceil"),
            F.round(c("x"), 2).alias("round"),
            F.bround(c("x"), 1).alias("bround"),
            F.round(c("i32"), -2).alias("round_int"),
            F.hypot(c("x"), c("x2")).alias("hypot"),
            F.cot(c("x")).alias("cot"),
            F.log_base(c("x2"), c("x")).alias("log_base"),
            F.asinh(c("x")).alias("asinh"), F.acosh(c("x")).alias("acosh"),
            F.atanh(c("x")).alias("atanh"),
            F.hash(c("i32"), c("x"), c("b")).alias("hash"),
            a.E("Sin", (c("x"),)).alias("sin"),
            a.E("Log10", (c("x"),)).alias("log10"),
            a.E("ShiftLeft", (c("i64"), c("n"))).alias("shl"),
            a.E("ShiftRightUnsigned", (c("i32"), c("n"))).alias("shru"),
            a.E("BitwiseAnd", (c("i32"), a.lit(255))).alias("and"),
            a.E("BitwiseNot", (c("i16"),)).alias("not")]


def _dsl_data(data):
    """The table past its edge rows, the rows with no subnormal or
    +-1e19 double (the flush and XLA's fused stages part there), in
    both packages' DataFrames."""
    from test_torch_cast import jax_df, port_df
    keep = np.ones(N, bool)
    keep[:N_EDGE] = False
    for k in ("x", "x2", "f"):
        keep &= ~subnormal(data[k][0])
    cut = {k: (v[keep], ok[keep]) for k, (v, ok) in data.items()}
    return (jax_df(cut, None, TYPES),
            port_df(TpuSession(device="cpu"), cut, TYPES))


def rows_close(want, got, rel: float = REL) -> bool:
    """Same rows in the same order: ints, booleans and None exact,
    floats within `rel` (NaN equal to NaN, infinities equal); a JAX zero
    where the port holds a result at the subnormal range's edge is
    XLA's flush (`flushed`)."""
    if len(want) != len(got):
        return False
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            if isinstance(a, float) and isinstance(b, float):
                if a == 0 and abs(b) < 2.0 ** -1020:
                    continue
                if math.isnan(a) or math.isnan(b):
                    if not (math.isnan(a) and math.isnan(b)):
                        return False
                elif not math.isclose(a, b, rel_tol=rel, abs_tol=0.0):
                    return False
            elif a != b or type(a) is not type(b):
                return False
    return True


def test_dsl_select_with_column_and_group_by_equal_the_jax_package(data):
    """The DSL's math, hash and bitwise entries through select, the same
    through with_column, and a group_by over Floor and a hash bucket
    with aggregates over Sqrt and Round: the same rows as the JAX
    package's."""
    from spark_rapids_tpu.plan import logical as JL
    jdf, pdf = _dsl_data(data)
    ja, pa = Api(JL), Api(PL)
    want = jdf.select(*_dsl(ja)).collect()
    got = pdf.select(*_dsl(pa)).collect()
    assert len(got) > 1500 and rows_close(want, got)
    want = jdf.with_column("y", ja.F.round(ja.F.sqrt(ja.col("x")), 3)) \
        .select("i32", "y").collect()
    got = pdf.with_column("y", pa.F.round(pa.F.sqrt(pa.col("x")), 3)) \
        .select("i32", "y").collect()
    assert rows_close(want, got)

    def grouped(a, df):
        bucket = a.E("Pmod", (a.F.hash(a.col("i64")), a.lit(7)))
        # xc / 8: XLA's compiled stage divides by a constant through its
        # reciprocal, exact only for a power of two
        return (df.group_by(a.F.floor(a.col("xc") / 8).alias("fl"),
                            bucket.alias("bucket"))
                .agg(a.F.count(a.lit(1)).alias("n"),
                     a.F.sum(a.col("i32")).alias("s"),
                     a.F.max(a.F.round(a.col("x"), 1)).alias("r"),
                     a.F.min(a.F.bround(a.col("x2"), -1)).alias("br"))
                .order_by("fl", "bucket").collect())
    assert rows_close(grouped(ja, jdf), grouped(pa, pdf))


# --------------------------------------------------------------------------
# what the JAX package cannot evaluate raises when the plan is made
# --------------------------------------------------------------------------

RAISES = {
    "BitwiseAnd-double": lambda a: a.E("BitwiseAnd", (a.col("x"),
                                                      a.col("i32"))),
    "BitwiseOr-float": lambda a: a.E("BitwiseOr", (a.col("f"), a.col("f"))),
    "BitwiseNot-double": lambda a: a.E("BitwiseNot", (a.col("x"),)),
    "BitwiseNot-string": lambda a: a.E("BitwiseNot", (a.col("s"),)),
    "ShiftLeft-double": lambda a: a.E("ShiftLeft", (a.col("x"), a.col("n"))),
    "ShiftRight-by-string": lambda a: a.E("ShiftRight", (a.col("n"),
                                                         a.col("s"))),
    "Sqrt-string": lambda a: a.F.sqrt(a.col("s")),
    "Pow-string": lambda a: a.F.pow(a.col("s"), 2),
    "Round-400-double": lambda a: a.F.round(a.col("x"), 400),
}
# placed on the JAX package's CPU executor, which runs them; the port
# has none
CPU_PLACED = {
    "Round-column-scale": lambda a: a.F.round(a.col("x"), a.col("n")),
    "BRound-float-scale": lambda a: a.F.bround(a.col("x"), 2.5),
}


def _small_frames():
    from test_torch_cast import jax_df, port_df
    data = {"x": (np.array([1.5, -2.25, 7.0]), np.array([1, 1, 0], bool)),
            "f": (np.array([1.5, 2.5, 0.0], np.float32), np.ones(3, bool)),
            "n": (np.array([1, 2, 3], np.int32), np.ones(3, bool)),
            "i32": (np.array([4, 5, 6], np.int32), np.ones(3, bool)),
            "s": (np.array(["a", "bb", ""], dtype=object), np.ones(3, bool))}
    types = {"x": "double", "f": "float", "n": "int", "i32": "int",
             "s": "string"}
    return (jax_df(data, None, types),
            port_df(TpuSession(device="cpu"), data, types))


@pytest.mark.parametrize("case", list(RAISES) + list(CPU_PLACED))
def test_what_the_jax_device_cannot_run_raises_at_planning(case):
    from spark_rapids_tpu.plan import logical as JL
    jdf, pdf = _small_frames()
    build = {**RAISES, **CPU_PLACED}[case]
    if case in RAISES:
        with pytest.raises(Exception):
            jdf.select(build(Api(JL)).alias("o")).collect()
    else:
        assert len(jdf.select(build(Api(JL)).alias("o")).collect()) == 3
    with pytest.raises(NotImplementedError):
        pdf.select(build(Api(PL)).alias("o")).physical_plan()


def test_the_dsl_adds_no_function_the_jax_package_lacks():
    from spark_rapids_tpu.plan import logical as JL
    port = {k for k in vars(PL.functions) if not k.startswith("_")}
    jax = {k for k in vars(JL.functions) if not k.startswith("_")}
    assert port <= jax, port - jax
    assert {"sqrt", "exp", "log", "pow", "floor", "ceil", "round", "bround",
            "hypot", "cot", "log_base", "asinh", "acosh", "atanh",
            "hash"} <= port


# --------------------------------------------------------------------------
# tpch.MATH_QUERIES' math half (test_torch_hash.py holds the hash half and
# every query against its numpy oracle)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["price_dispersion", "price_decades"])
def test_price_query_rows_equal_the_jax_package(name):
    """At SF0.01 of the JAX package's generator (100 suppliers, so
    price_dispersion keeps them all), the same rows as the JAX package's
    query built from its own DSL, each within the query's rule, and both
    equal to the numpy oracle."""
    from test_torch_hash import jax_math_rows
    from spark_rapids_tpu_torch import tpch
    t, got, want = jax_math_rows(name)
    assert len(got) == len(want) > 10
    assert tpch.match_math_query(name, want, got)
    oracle = tpch.ORACLES[name](t)
    assert tpch.match_math_query(name, oracle, got)
    assert tpch.match_math_query(name, oracle, want)
