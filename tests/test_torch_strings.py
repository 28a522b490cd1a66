"""The port's string predicates (StartsWith, EndsWith, Contains, Like) and
Substring against the JAX package, row by row.

One seeded numpy table goes through both packages' DataFrame API: a
string column `s` (about 15% nulls, empty strings, strings at and over
the patterns' lengths, multi-byte UTF-8, `%`, `_` and `\\` in the text),
a column `t` of strings of at most 8 bytes (so longer patterns exceed its
width), int columns `p` and `n` and a long column `q` with nulls and
extreme values for Substring's position and length.  The results must be
equal: the same null masks and, at the valid rows, the same booleans and
the same bytes (a substring may cut a UTF-8 character in both packages,
so strings are compared as bytes, not decoded).  Where the JAX package
fails, the port must raise when the plan is made.

The JAX package is imported inside the functions that use it:
tests/test_torch_cuda.py reuses the table and the cases on a machine
without JAX.
"""
import numpy as np
import pytest

from spark_rapids_tpu_torch import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.plan import logical as PL

N = 300
_EDGE = ["", "a", "ab", "abc", "c", "abcdefgh", "abcdefghi",
         "abcdefghabcdefgh", "special", "requests", "special requests",
         "requests special", "xspecialrequestsx", "héllo", "日本語", "ß",
         "é", "%", "_", "\\", "a%b_c\\", "xyz\\", "hello",
         "carefully final deposits"]
_SHORT = ["", "a", "ab", "abc", "é", "abcdefgh", "%_", "\\", "héllo"]
_INT32 = (-2 ** 31, 2 ** 31 - 1)
_TYPES = {"s": "string", "t": "string", "p": "int", "n": "int",
          "q": "long"}

# the patterns of StartsWith, EndsWith and Contains: "ha" would match
# across the end of an 8-byte `t` value and the start of the next row's,
# "c\0" the zero padding after a value; the last is longer than every
# value of `s`
PATTERNS = ["", "a", "ab", "abc", "c", "é", "héllo", "llo", "abcdefgh",
            "abcdefghi", "special", "requests", "%", "\\", "日本", "ab%",
            "ha", "c\0", "x" * 70]
# `%` any run, `_` one byte, `\` escapes the next byte, a trailing `\`
# is a literal one; "%\0a%" would match where a zero byte after one row
# ran on into the next
LIKE_PATTERNS = ["", "%", "%%", "_", "__", "a%", "%a", "%ab%", "a_c",
                 "a%c", "%special%requests%", "\\%%", "%\\_%", "%\\\\%",
                 "abc\\", "xyz\\", "_é%", "h_llo", "h__llo", "%é", "日%",
                 "%_%_%_%", "a\\bc", "%\0a%", "x" * 70]
# (pos, len): literals, or the names of int columns holding nulls
SUBSTR_ARGS = [(1, 2), (0, 3), (1, 0), (2, -1), (-3, 2), (-1, 5),
               (-50, 2), (5, 100), (100, 2), (3, 1), ("p", "n"), ("p", 3),
               (1, "n"), ("q", 4), (2 ** 31 - 1, 1), (-2 ** 31, 3),
               (1, 2 ** 31 - 1), (2 ** 32 + 2, 3)]


def table(seed: int = 21):
    """{column: (values, valid)} as numpy arrays, N rows."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abc%_\\é s"))
    rand = ["".join(rng.choice(alphabet, k)) for k in rng.integers(0, 25, N)]
    s = np.where(rng.random(N) < 0.6,
                 np.array(_EDGE)[rng.integers(0, len(_EDGE), N)],
                 np.array(rand))
    t = np.array(_SHORT)[rng.integers(0, len(_SHORT), N)]

    def ints(dtype, extremes):
        v = rng.integers(-12, 13, N)
        pick = rng.random(N) < 0.1
        v[pick] = rng.choice(extremes, int(pick.sum()))
        return v.astype(dtype)
    cols = {"s": s, "t": t, "p": ints(np.int32, _INT32),
            "n": ints(np.int32, _INT32),
            "q": ints(np.int64, (2 ** 32 + 2, -2 ** 40))}
    return {k: (v, rng.random(N) >= 0.15) for k, v in cols.items()}


_PORT_TYPES = {"string": PT.StringType, "int": PT.IntegerType,
               "long": PT.LongType}


def port_df(session, data):
    schema = PT.Schema([PT.StructField(n, _PORT_TYPES[_TYPES[n]])
                        for n in data])
    return session.from_numpy(
        {n: np.ma.masked_array(v, mask=~ok) for n, (v, ok) in data.items()},
        schema)


def _jax_df(data):
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    jtypes = {"string": JT.StringType, "int": JT.IntegerType,
              "long": JT.LongType}
    schema = JT.Schema([JT.StructField(n, jtypes[_TYPES[n]])
                        for n in data])
    return JaxSession({}).from_pydict(
        {n: [x if ok else None for x, ok in zip(v.tolist(), valid)]
         for n, (v, valid) in data.items()}, schema)


def _arg(a, x):
    return a.col(x) if isinstance(x, str) else a.lit(x)


def predicate_case(cls, pattern):
    """The predicate over `s` and over the narrow `t`."""
    def build(a):
        return [getattr(a.col(c), cls)(pattern) for c in ("s", "t")]
    return build


def substr_case(pos, length):
    def build(a):
        return [a.col(c).substr(_arg(a, pos), _arg(a, length))
                for c in ("s", "t")]
    return build


# id -> select(api) -> [ColumnExpr]
CASES = {}
for _cls in ("startswith", "endswith", "contains"):
    for _i, _p in enumerate(PATTERNS):
        CASES[f"{_cls}-{_i}"] = predicate_case(_cls, _p)
for _i, _p in enumerate(LIKE_PATTERNS):
    CASES[f"like-{_i}"] = predicate_case("like", _p)
for _i, (_pos, _len) in enumerate(SUBSTR_ARGS):
    CASES[f"substr-{_i}"] = substr_case(_pos, _len)
# the predicates over a substring
CASES["composite"] = lambda a: [
    a.col("s").substr(2, 6).startswith("b"),
    a.col("s").substr(-4, 4).endswith("c"),
    a.col("s").substr(a.col("p"), a.col("n")).contains("a"),
    a.col("s").substr(2, 30).like("%b%"),
    a.col("s").substr(1, 2) == "ab"]


class Api:
    """One package's DSL, so one case builds the same tree in both."""

    def __init__(self, logical):
        self.col, self.lit = logical.col, logical.lit


PORT = Api(PL)


def _jax_logical():
    from spark_rapids_tpu.plan import logical as JL
    return JL


def query(df, api, case):
    return df.select(*[e.alias(f"c{k}")
                       for k, e in enumerate(CASES[case](api))])


def port_rows(df):
    """Each output column of a port result as a list, None for null and
    strings as their raw bytes."""
    plan = df.physical_plan()
    ctx = ExecContext(df.session.conf, df.session.device)
    cols = [[] for _ in df.schema]
    for batch in plan.execute(ctx):
        rows = batch.live_rows()
        for out, c in zip(cols, batch.columns):
            valid = c.valid[rows].tolist()
            if c.dtype.is_string:
                data = c.data[rows].cpu().numpy()
                vals = [bytes(d[:k]) for d, k in
                        zip(data, c.lengths[rows].tolist())]
            else:
                vals = c.data[rows].tolist()
            out.extend(v if ok else None for v, ok in zip(vals, valid))
    return cols


def jax_rows(df):
    """The same from a JAX result's Arrow columns (strings cast to
    binary, so bytes that are not UTF-8 survive)."""
    import pyarrow as pa
    out = []
    for arr in df.to_arrow().columns:
        if pa.types.is_string(arr.type):
            arr = arr.cast(pa.binary())
        out.append(arr.to_pylist())
    return out


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
    s, ok = data["s"]
    live = [x.encode() for x in s[ok]]
    assert 0.1 < 1 - ok.mean() < 0.2
    assert b"" in live and any(len(x) != len(x.decode()) for x in live)
    # at, under and over 8 and 9 bytes; every value shorter than the
    # longest pattern
    assert {7, 8, 9} <= {len(x) for x in live}
    assert max(len(x) for x in live) < len(PATTERNS[-1].encode())
    assert max(len(x.encode()) for x in data["t"][0]) <= 8
    for name in ("p", "n", "q"):
        v, ok = data[name]
        assert not ok.all() and (v[ok] < 0).any() and (v[ok] == 0).any()


@pytest.mark.parametrize("case", list(CASES))
def test_string_expression_rows_equal_the_jax_package(case, jax_df,
                                                      port_table):
    want = jax_rows(query(jax_df, Api(_jax_logical()), case))
    got = port_rows(query(port_table, PORT, case))
    assert len(got) == len(want) > 0
    for k, (w, g) in enumerate(zip(want, got)):
        assert len(w) == N and g == w, (case, k)


@pytest.mark.parametrize("cond", ["q13", "like", "substr"])
def test_string_filters_keep_the_jax_package_rows(cond, jax_df,
                                                  port_table):
    def where(a):
        s = a.col("s")
        return {"q13": ~(s.contains("special") & s.contains("requests")),
                "like": s.like("%a%b%") | s.startswith("%"),
                "substr": s.substr(-3, 3).endswith("c")}[cond]
    want = jax_rows(jax_df.filter(where(Api(_jax_logical())))
                    .select("s", "p"))
    got = port_rows(port_table.filter(where(PORT)).select("s", "p"))
    assert 0 < len(got[0]) < N
    assert got == want


_PATTERN_CLASSES = ["startswith", "endswith", "contains", "like"]
# patterns the JAX package's predicates reject when they evaluate
_BAD_PATTERNS = {"column": lambda a: a.col("t"),
                 "null": lambda a: a.lit(None),
                 "int": lambda a: a.lit(5)}


@pytest.mark.parametrize("kind", list(_BAD_PATTERNS))
@pytest.mark.parametrize("cls", _PATTERN_CLASSES)
def test_a_pattern_that_is_not_a_string_literal_raises_at_planning(
        cls, kind, jax_df, port_table):
    japi = Api(_jax_logical())
    with pytest.raises(ValueError, match="string literal"):
        jax_df.select(getattr(japi.col("s"), cls)(
            _BAD_PATTERNS[kind](japi)).alias("x")).to_arrow()
    df = port_table.select(getattr(PORT.col("s"), cls)(
        _BAD_PATTERNS[kind](PORT)).alias("x"))
    with pytest.raises(NotImplementedError, match="string literal"):
        df.physical_plan()
    # inside a filter too: planning fails, the query never runs
    with pytest.raises(NotImplementedError, match="string literal"):
        port_table.filter(getattr(PORT.col("s"), cls)(
            _BAD_PATTERNS[kind](PORT))).collect()


@pytest.mark.parametrize("cls", _PATTERN_CLASSES + ["substr"])
def test_a_column_that_is_not_a_string_raises_at_planning(cls, jax_df,
                                                          port_table):
    def build(a):
        c = a.col("p")
        return c.substr(1, 2) if cls == "substr" else getattr(c, cls)("a")
    with pytest.raises(AssertionError):
        jax_df.select(build(Api(_jax_logical())).alias("x")).to_arrow()
    with pytest.raises(TypeError, match="int column"):
        port_table.select(build(PORT).alias("x")).physical_plan()


def test_a_substring_position_that_is_not_integral_raises_at_planning(
        port_table):
    df = port_table.select(PORT.col("s").substr(PORT.lit(1.5), 2))
    with pytest.raises(NotImplementedError, match="double substring"):
        df.physical_plan()


def test_substring_quirks_are_the_jax_package_s(port_table):
    """A negative position past the start clips to the first byte
    (Spark gives ""), and the nulls of a column position are ignored."""
    df = TpuSession(device="cpu").from_numpy(
        {"s": np.array(["abc", "abc"]),
         "p": np.ma.masked_array(np.array([2, 2], np.int32),
                                 mask=[False, True])})
    rows = df.select(PL.col("s").substr(-5, 2).alias("a"),
                     PL.col("s").substr(PL.col("p"), 1).alias("b")).collect()
    assert rows == [("ab", "b"), ("ab", "a")]


def test_substring_routes_count_the_rows_numpy_counts():
    """The filters that tools/substring_routes.py times, on the CPU at
    SF0.01: the slice route (a literal position) and the gather route
    (`coalesce(lit(1))`) count the rows numpy counts."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.tools import substring_routes
    tables = tpch.generate(0.01)
    s = TpuSession(device="cpu")
    dfs = {n: s.from_numpy(tables[n], tpch.SCHEMAS[n])
           for n in ("orders", "customer")}
    comment = tables["orders"]["o_comment"]
    phone = tables["customer"]["c_phone"].astype("S2")
    want = {"o_comment": int((comment.astype("S7") == b"special").sum()),
            "c_phone": int(np.isin(phone, [c.encode() for c in
                                           tpch.Q22_CODES]).sum())}
    got = {k: q() for k, q in substring_routes._filters(dfs).items()}
    assert sorted(route for _, route in got) == ["gather"] * 2 + ["slice"] * 2
    assert all(want[name.split()[0]] > 0 for name, _ in got)
    assert got == {k: [(want[k[0].split()[0]],)] for k in got}
