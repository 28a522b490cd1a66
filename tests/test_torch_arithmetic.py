"""The port's arithmetic (Add, Subtract, Multiply, Divide, IntegralDivide,
Remainder, Pmod, UnaryMinus, UnaryPositive, Abs) and its split of an agg
entry computed over aggregates, against the JAX package.

One seeded numpy table holds two columns of each numeric type (int,
long, float, double) and a long grouping key `g`, about 20% nulls.  Its
first rows pair every edge value with every other: for the integers the
type's minimum and maximum, -1, 0, 1, 7 and -7 (so INT_MIN div -1 and a
zero divisor both occur); for the floats NaN of both signs, +-0.0,
+-inf, +-2.5 and the type's largest value.  The rest are random.

Each expression is evaluated by both packages' classes over a batch
holding the same leaves, on operand pairs of every type, mixed types and
literals on either side.  The results must be equal on every row, null
slots included: the same null masks, integers equal and floats bit for
bit (-0.0 apart from 0.0), any NaN equal to any NaN, and a subnormal
result the only place where they may part: the JAX package's CPU backend
flushes it to zero, the port keeps it (`unflush`).  The same expressions written in each package's DSL go through
`select` (resolve and type coercion run), and aggregates with entries
over aggregates through `group_by().agg()` and `agg()`: the same rows,
the same output names and the same plan shape.

The JAX package is imported inside the functions that use it:
tests/test_torch_cuda.py reuses the table and the cases on a machine
without JAX.
"""
import numpy as np
import pytest

from spark_rapids_tpu_torch import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch_from_numpy
from spark_rapids_tpu_torch.ops import expressions as PE
from spark_rapids_tpu_torch.plan import logical as PL

N = 512
TYPES = {"i": "int", "l": "long", "f": "float", "d": "double", "g": "long"}
COLUMNS = ["i", "i2", "l", "l2", "f", "f2", "d", "d2", "g"]
_NP = {"int": np.int32, "long": np.int64, "float": np.float32,
       "double": np.float64}
_INT_EDGES = [0, 1, -1, 7, -7]     # and the type's minimum and maximum
FLOAT_EDGES = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 2.5, -2.5]
# and the type's largest finite value
INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
CONF = {"spark.rapids.sql.variableFloatAgg.enabled": "true"}


def _type_of(name: str) -> str:
    return TYPES[name.rstrip("2")]


def _edges(t: str) -> np.ndarray:
    if t in ("float", "double"):
        return np.array(FLOAT_EDGES + [np.finfo(_NP[t]).max], dtype=_NP[t])
    info = np.iinfo(_NP[t])
    return np.array([info.min, info.max] + _INT_EDGES, dtype=_NP[t])


def table(seed: int = 14):
    """{column: (values, valid)} as numpy arrays, N rows, null slots
    holding zeros (as both packages store them)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in COLUMNS:
        t = _type_of(name)
        if name == "g":
            v = rng.integers(0, 5, N).astype(np.int64)
        elif t in ("float", "double"):
            pick = rng.random(N)
            v = np.where(pick < 0.3, rng.choice(_edges(t), N),
                         np.where(pick < 0.6, rng.integers(-4, 5, N) * 0.5,
                                  rng.normal(0, 100, N)).astype(_NP[t]))
        else:
            info = np.iinfo(_NP[t])
            pick = rng.random(N)
            v = np.where(pick < 0.2, rng.choice(_edges(t), N),
                         np.where(pick < 0.6, rng.integers(-5, 6, N),
                                  rng.integers(info.min, info.max, N,
                                               dtype=_NP[t])))
            v = v.astype(_NP[t])
        valid = rng.random(N) >= 0.2
        if name != "g":
            # every edge against every edge, all valid: the first column
            # of a pair cycles slowly, the second fast
            e = _edges(t)
            k = len(e) ** 2
            v[:k] = np.repeat(e, len(e)) if not name.endswith("2") \
                else np.tile(e, len(e))
            valid[:k] = True
        v = np.where(valid, v, 0).astype(v.dtype)
        out[name] = (v, valid)
    return out


# --------------------------------------------------------------------------
# the expression classes over one batch
# --------------------------------------------------------------------------

# operands: a column name or ("lit", value)
_PAIRS = [("i", "i2"), ("l", "l2"), ("f", "f2"), ("d", "d2"), ("i", "l"),
          ("l", "i"), ("i", "d"), ("d", "f"), ("l", "f"), ("f", "i"),
          ("i", ("lit", 0)), (("lit", 7), "i"), ("l", ("lit", -1)),
          (("lit", INT_MIN), "i"), ("i", ("lit", -1)),
          ("d", ("lit", -0.0)), ("d", ("lit", float("nan"))),
          ("f", ("lit", float("inf"))), (("lit", float("-inf")), "d"),
          (("lit", 2.5), "f"), ("l", ("lit", 2 ** 40))]
_UNARY_OPERANDS = ["i", "l", "f", "d", ("lit", INT_MIN),
                   ("lit", -0.0), ("lit", float("nan"))]
BINARY_OPS = ["Add", "Subtract", "Multiply", "Divide", "IntegralDivide",
              "Remainder", "Pmod"]
UNARY_OPS = ["UnaryMinus", "UnaryPositive", "Abs"]


def _label(x) -> str:
    return x if isinstance(x, str) else f"lit({x[1]!r})"


CASES = {f"{op}-{_label(a)}-{_label(b)}": (op, (a, b))
         for op in BINARY_OPS for a, b in _PAIRS}
CASES.update({f"{op}-{_label(a)}": (op, (a,))
              for op in UNARY_OPS for a in _UNARY_OPERANDS})


def build(E, T, case):
    """The case's expression in one package: E its expressions module, T
    its types module."""
    op, operands = CASES[case]

    def operand(x):
        if isinstance(x, str):
            t = {"int": T.IntegerType, "long": T.LongType,
                 "float": T.FloatType, "double": T.DoubleType}[_type_of(x)]
            return E.BoundReference(COLUMNS.index(x), t, x)
        return E.Literal(x[1])
    return getattr(E, op)(*[operand(x) for x in operands])


def port_schema():
    return PT.Schema([PT.StructField(n, {
        "int": PT.IntegerType, "long": PT.LongType, "float": PT.FloatType,
        "double": PT.DoubleType}[_type_of(n)]) for n in COLUMNS])


def port_eval(data, case, device="cpu"):
    """(type name, data, valid) of the case on a port batch of `data`,
    as numpy arrays."""
    batch = batch_from_numpy([data[n] for n in COLUMNS], np.ones(N, bool),
                             port_schema(), device=device)
    out = build(PE, PT, case).eval(batch)
    return (out.dtype.name, out.data.cpu().numpy(),
            out.valid.cpu().numpy())


def _jax_eval(data, case):
    import jax.numpy as jnp
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.columnar import Column as JColumn
    from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
    from spark_rapids_tpu.ops import expressions as JE
    jt = {"int": JT.IntegerType, "long": JT.LongType, "float": JT.FloatType,
          "double": JT.DoubleType}
    schema = JT.Schema([JT.StructField(n, jt[_type_of(n)])
                        for n in COLUMNS])
    batch = JBatch([JColumn(jnp.asarray(data[n][0]), jnp.asarray(data[n][1]),
                            jt[_type_of(n)]) for n in COLUMNS],
                   jnp.ones(N, dtype=jnp.bool_), schema)
    out = build(JE, JT, case).eval(batch)
    return out.dtype.name, np.asarray(out.data), np.asarray(out.valid)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """The same dtype and the same bits on every row, where any NaN equals
    any NaN: which operand's NaN payload and sign an op passes on is the
    compiler's choice (Add of two NaNs differs between the packages
    already), and Spark tells no NaN from another."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    u = f"u{a.dtype.itemsize}"
    same = a.view(u) == b.view(u)
    if a.dtype.kind == "f":
        same |= np.isnan(a) & np.isnan(b)
    return bool(np.all(same))


def unflush(want: np.ndarray, got: np.ndarray) -> np.ndarray:
    """`want` (the JAX result) with the port's value where the port holds
    a subnormal float and `want` the zero of its sign: XLA's CPU backend
    runs with subnormals flushed to zero (2.5 / DBL_MAX is 0.0 there),
    the port keeps IEEE's subnormals, as the JVM does.  Asserts that is
    the only way they part."""
    if want.dtype.kind != "f" or got.dtype != want.dtype:
        return want
    sub = (got != 0) & (np.abs(got) < np.finfo(got.dtype).tiny)
    assert np.all(want[sub] == 0)
    assert np.array_equal(np.signbit(want[sub]), np.signbit(got[sub]))
    return np.where(sub, got, want)


@pytest.fixture(scope="module")
def data():
    return table()


def test_the_table_holds_what_the_cases_need(data):
    for name, (v, valid) in data.items():
        assert 0.1 < 1 - valid.mean() < 0.3, name
        if name == "g":
            continue
        live = v[valid]
        if v.dtype.kind == "f":
            assert np.isnan(live).any() and np.isinf(live).any()
            assert (np.signbit(live) & (live == 0)).any()
            assert (np.signbit(live) & np.isnan(live)).any()
        else:
            info = np.iinfo(v.dtype)
            assert info.min in live and info.max in live and 0 in live
        # the two columns of a type meet at every pair of edges
    for t in ("i", "l", "f", "d"):
        pairs = {(a.tobytes(), b.tobytes())
                 for a, b in zip(data[t][0], data[t + "2"][0])}
        e = _edges(_type_of(t))
        assert all((a.tobytes(), b.tobytes()) in pairs for a in e for b in e)


@pytest.mark.parametrize("case", list(CASES))
def test_expression_equals_the_jax_package_bit_for_bit(case, data):
    want = _jax_eval(data, case)
    got = port_eval(data, case)
    assert got[0] == want[0]
    assert np.array_equal(got[2], want[2]), case
    wv = unflush(want[1], got[1])
    assert same_bits(got[1], wv), (
        case, [(w, g) for w, g in zip(wv, got[1])
               if not same_bits(np.asarray([w]), np.asarray([g]))][:6])


def test_division_by_zero_is_null_and_int_min_edges_wrap(data):
    """What the edge rows give: a zero divisor (0 or -0.0) is a null, a
    NaN or infinite divisor is not; INT64_MIN div -1 and abs(INT_MIN)
    keep the type's minimum, as the JAX package computes them."""
    _, q, ok = port_eval(data, "Divide-d-d2")
    d2 = data["d2"][0]
    live = data["d"][1] & data["d2"][1]
    assert not ok[live & (d2 == 0)].any()
    assert ok[live & (np.isnan(d2) | np.isinf(d2))].all()
    assert np.all(q[~ok] == 0)
    _, q, ok = port_eval(data, "IntegralDivide-l-l2")
    lmin = np.iinfo(np.int64).min
    hit = (data["l"][0] == lmin) & (data["l2"][0] == -1)
    assert hit.any() and ok[hit].all() and np.all(q[hit] == lmin)
    _, a, _ = port_eval(data, f"Abs-lit({INT_MIN})")
    assert np.all(a == INT_MIN)
    _, r, ok = port_eval(data, "Remainder-i-i2")
    hit = (data["i"][0] == INT_MIN) & (data["i2"][0] == -1)
    assert hit.any() and np.all(r[hit] == 0)


def test_unary_positive_is_not_resolved_in_either_package(data):
    """The JAX package's resolve has no UnaryPositive (its class runs, as
    the cases above show); the port's resolve leaves it out too."""
    from spark_rapids_tpu.plan.analysis import AnalysisError
    jdf = _jax_df(data)
    with pytest.raises(AnalysisError, match="UnaryPositive"):
        jdf.select(_jax_api().E("UnaryPositive", (_jax_api().col("i"),))
                   ).collect()
    df = port_df(TpuSession(device="cpu"), data)
    with pytest.raises(NotImplementedError, match="UnaryPositive"):
        df.select(PL.ColumnExpr("UnaryPositive", (PL.col("i"),))) \
            .physical_plan()


@pytest.mark.parametrize("op", ["UnaryMinus", "Abs"])
def test_unary_arithmetic_of_a_string_raises_at_planning(op):
    """The JAX package fails when it collects -s or abs(s) of a string
    column (its result has no string layout); the port raises when the
    plan is made."""
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    values = ["ab", None, "c"]
    with pytest.raises(Exception):
        JaxSession({}).from_pydict({"s": values}).select(
            _jax_api().E(op, (_jax_api().col("s"),)).alias("x")).collect()
    df = TpuSession(device="cpu").from_numpy(
        {"s": np.ma.masked_array(["ab", "", "c"], mask=[False, True, False])})
    with pytest.raises(TypeError, match="string"):
        df.select(PL.ColumnExpr(op, (PL.col("s"),)).alias("x")) \
            .physical_plan()


# --------------------------------------------------------------------------
# the DSL through select
# --------------------------------------------------------------------------

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


_DSL_PAIRS = [("i", "i2"), ("l", "l2"), ("f", "f2"), ("d", "d2"),
              ("i", "l"), ("i", "d"), ("l", "f"), ("f", "d")]


def _dsl_binary(op):
    def exprs(a):
        fn = {"Divide": lambda x, y: x / y, "Remainder": lambda x, y: x % y,
              "IntegralDivide": lambda x, y: a.E("IntegralDivide", (x, y)),
              "Pmod": lambda x, y: a.E("Pmod", (x, y))}[op]
        out = [fn(a.col(x), a.col(y)) for x, y in _DSL_PAIRS]
        # a literal on either side, and a null literal
        out += [fn(a.col("i"), a.lit(0)), fn(a.lit(7), a.col("l")),
                fn(a.col("d"), a.lit(-0.0)), fn(a.lit(-1), a.col("i")),
                fn(a.col("f"), a.lit(None))]
        if op == "Divide":
            out += [a.col("i") / 2, 100.0 / a.col("d"), 7 / a.col("l")]
        if op == "Remainder":
            out += [a.col("l") % 3, a.col("d") % 2.5]
        return out
    return exprs


DSL_CASES = {op: _dsl_binary(op) for op in
             ("Divide", "IntegralDivide", "Remainder", "Pmod")}
DSL_CASES.update({
    "UnaryMinus": lambda a: [-a.col(c) for c in ("i", "l", "f", "d")]
    + [-(a.col("i") + 1), -a.lit(2.5)],
    "Abs": lambda a: [a.F.abs(a.col(c)) for c in ("i", "l", "f", "d")]
    + [a.F.abs(a.col("i") - a.col("i2")), a.F.abs(-3)],
    "nested": lambda a: [(a.col("l") * 3 + a.col("i")) / (a.col("d") - 1.5),
                         -(a.col("i") % 4) / a.F.abs(a.col("f")),
                         a.E("Pmod", (a.col("l") - 9, a.col("i2") % 5))],
})


def port_df(session, data):
    """The table as a port DataFrame (masked arrays: masked = null)."""
    return session.from_numpy(
        {n: np.ma.masked_array(v, mask=~ok) for n, (v, ok) in data.items()},
        port_schema())


def _jax_df(data):
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    jt = {"int": JT.IntegerType, "long": JT.LongType, "float": JT.FloatType,
          "double": JT.DoubleType}
    schema = JT.Schema([JT.StructField(n, jt[_type_of(n)]) for n in data])
    return JaxSession(dict(CONF)).from_pydict(
        {n: [x if ok else None for x, ok in zip(v.tolist(), valid)]
         for n, (v, valid) in data.items()}, schema)


def dsl_query(df, api, case):
    return df.select(*[e.alias(f"c{k}")
                       for k, e in enumerate(DSL_CASES[case](api))])


@pytest.fixture(scope="module")
def jax_df(data):
    return _jax_df(data)


@pytest.fixture(scope="module")
def port_table(data):
    return port_df(TpuSession(dict(CONF), device="cpu"), data)


@pytest.mark.parametrize("case", list(DSL_CASES))
def test_dsl_rows_equal_the_jax_package(case, jax_df, port_table):
    import test_torch_expressions as X
    jtypes, want = X.jax_columns(dsl_query(jax_df, _jax_api(), case))
    ptypes, got = X.port_columns(dsl_query(port_table, PORT, case))
    assert ptypes == jtypes
    assert len(got) == len(want) > 0
    for k, ((wv, wok), (gv, gok)) in enumerate(zip(want, got)):
        assert np.array_equal(wok, gok), (case, k)
        assert X.same_values(unflush(wv, gv), gv, wok), (case, k)


def test_operators_build_the_jax_package_trees():
    """Each operator and function builds the op the JAX DSL builds."""
    J = _jax_api()
    for a in (J, PORT):
        x = a.col("x")
        got = [(x / 2).op, (2 / x).op, (x % 3).op, (-x).op,
               a.F.abs(x).op, (2 / x).args[0].op]
        assert got == ["Divide", "Divide", "Remainder", "UnaryMinus", "Abs",
                       "lit"]


# --------------------------------------------------------------------------
# the aggregate split
# --------------------------------------------------------------------------

def _agg_entries(a):
    F, c = a.F, a.col
    return {
        "sum-over-sum": [(F.sum(c("d")) / F.sum(c("l"))).alias("ratio")],
        "avg-times-literal": [(F.avg(c("i")) * 0.2).alias("limit")],
        "sum-over-literal": [(F.sum(c("f")) / 7.0).alias("per_week")],
        "nested": [((F.sum(c("l")) + F.max(c("i"))) % (F.count(c("d")) + 3)
                    - F.abs(F.min(c("i2")) / 2)).alias("n")],
        "mixed": [F.sum(c("i")).alias("s"),
                  (F.count(a.lit(1)) * 100 / F.count(c("d"))).alias("pct"),
                  F.max(c("d2")),
                  -F.avg(c("l2"))],
        "unnamed": [F.sum(c("i")) / F.count(c("i")),
                    F.min(c("l")) - F.max(c("l"))],
    }


AGG_CASES = list(_agg_entries(PORT))


def _plan_shape(df):
    """(node names from the top, the aggregate's output names, the
    output names)."""
    p, names = df.plan, []
    while type(p).__name__ in ("LogicalProject", "LogicalAggregate"):
        names.append(type(p).__name__)
        agg = p
        p = p.children[0]
    return (names, [e.output_name for e in agg.aggregates],
            list(df.schema.names))


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("case", AGG_CASES)
def test_agg_over_aggregates_equals_the_jax_package(case, grouped, jax_df,
                                                    port_table):
    from compare import assert_rows_equal
    J = _jax_api()
    dfs = []
    for a, df in ((J, jax_df), (PORT, port_table)):
        entries = _agg_entries(a)[case]
        dfs.append(df.group_by("g").agg(*entries) if grouped
                   else df.agg(*entries))
    jdf, pdf = dfs
    assert _plan_shape(pdf) == _plan_shape(jdf)
    assert [f.dtype.name for f in pdf.schema] == \
        [f.dtype.name for f in jdf.schema]
    want = list(zip(*[col.to_pylist() for col in jdf.to_arrow().columns]))
    got = pdf.collect()
    assert len(got) == (6 if grouped else 1)
    assert_rows_equal(want, got)
    if grouped:
        # `g` is a grouping key kept ahead of the projections
        assert pdf.schema.names[0] == "g"


def test_a_plain_agg_list_stays_one_aggregate(port_table):
    F = PL.functions
    df = port_table.group_by("g").agg(F.sum(PL.col("i")).alias("s"),
                                      F.count(PL.lit(1)))
    assert type(df.plan).__name__ == "LogicalAggregate"
    assert df.schema.names == ["g", "s", "count"]
