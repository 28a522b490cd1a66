"""The port's Spark murmur3 (`spark_hash_column`, `spark_hash_columns`
and the Murmur3Hash expression of spark_rapids_tpu_torch/ops/hashing.py)
against the JAX package's, bit for bit, and against `tpch.murmur3_np`,
a numpy uint32 oracle written from Spark's hashInt, hashLong and
hashUnsafeBytes; `hash` in the DSL; and `tpch.MATH_QUERIES` at SF0.01
against the JAX package and the port's numpy oracles.

One seeded numpy table of N rows (`table`): byte, short, int and long
columns whose first rows are each type's extremes, a date and a
timestamp (pre-epoch rows among them), booleans, floats and doubles
with +-0.0, NaNs of several payloads, +-inf and subnormals, and two
string columns of 0 to 64 UTF-8 bytes, bytes >= 0x80 among them (every
length mod 4, so every tail).  About 10% of every column past the edge
rows is null.

The JAX package is imported inside the functions that use it:
tests/test_torch_cuda.py reuses the table and the cases on a machine
without JAX.
"""
import os

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import TpuSession, tpch
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import Column, ColumnarBatch
from spark_rapids_tpu_torch.ops import expressions as PE
from spark_rapids_tpu_torch.ops import hashing as PH
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

N = 1024
TYPES = {"i8": "byte", "i16": "short", "i32": "int", "i64": "long",
         "d": "date", "t": "timestamp", "b": "boolean", "f": "float",
         "x": "double", "s": "string", "s2": "string"}
COLUMNS = list(TYPES)
_NP = {"byte": np.int8, "short": np.int16, "int": np.int32,
       "long": np.int64, "date": np.int32, "timestamp": np.int64,
       "boolean": np.bool_, "float": np.float32, "double": np.float64}
# NaN of other payloads and signs: every one hashes as the canonical NaN
_NANS = [np.nan, -np.nan, np.frombuffer(np.uint64(0x7FF0000000000001)
                                        .tobytes(), np.float64)[0],
         np.frombuffer(np.uint64(0xFFF8000000000123).tobytes(),
                       np.float64)[0]]
FLOAT_EDGES = _NANS + [0.0, -0.0, np.inf, -np.inf, 5e-324, -1e-310, 1e-40,
                       1.0, -1.0, 0.1, 1e300]
_CHARS = list("abcXYZ019 -_") + ["é", "€", "ß", "ÿ", "𝄞", "中"]
N_EDGE = 32


def _strings(rng, n):
    """Strings of 0-64 UTF-8 bytes: every length from 0 to 20 first, then
    random ones of mixed one- to four-byte characters."""
    out = ["x" * k for k in range(21)]
    while len(out) < n:
        s = "".join(rng.choice(_CHARS, int(rng.integers(0, 40))))
        while len(s.encode("utf-8")) > 64:
            s = s[:-1]
        out.append(s)
    out[21:25] = ["é", "€", "𝄞", "aé€𝄞中"]
    return np.array(out[:n], dtype=object)


def table(seed: int = 22):
    """{column: (values, valid)}, N rows, null slots holding zeros (the
    empty string for text)."""
    rng = np.random.default_rng(seed)
    cols = {}
    for name in ("i8", "i16", "i32", "i64"):
        dt = _NP[TYPES[name]]
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, N, dtype=dt, endpoint=True)
        v[:6] = [info.min, info.max, 0, -1, 1, 42]
        cols[name] = v
    cols["d"] = rng.integers(-200_000, 200_000, N).astype(np.int32)
    cols["t"] = rng.integers(-2 ** 60, 2 ** 60, N)
    cols["b"] = rng.random(N) < 0.5
    x = rng.normal(0, 1, N) * 10.0 ** rng.integers(-300, 300, N)
    x[:len(FLOAT_EDGES)] = FLOAT_EDGES
    cols["x"] = x
    with np.errstate(over="ignore"):
        f = x.astype(np.float32)
    f[:4] = np.array([0x7FC00000, 0xFFC00001, 0x7F800001, 0x80000000],
                     np.uint32).view(np.float32)
    cols["f"] = f
    cols["s"] = _strings(rng, N)
    cols["s2"] = _strings(rng, N)[::-1].copy()
    out = {}
    for name in COLUMNS:
        valid = rng.random(N) >= 0.1
        valid[:N_EDGE] = True
        v = cols[name]
        zero = "" if v.dtype == object else np.zeros((), v.dtype)
        out[name] = (np.where(valid, v, zero).astype(v.dtype), valid)
    return out


def port_column(data, name: str, device="cpu") -> Column:
    v, ok = data[name]
    t = PT.TYPES_BY_NAME[TYPES[name]]
    if t is PT.StringType:
        enc = np.array([s.encode("utf-8") for s in v], dtype=object)
        width = max(len(e) for e in enc)
        return Column.from_strings(enc.astype(f"S{max(width, 1)}"), ok, N,
                                   device)
    return Column.from_numpy(v, ok, t, N, device)


def port_batch(data, device="cpu") -> ColumnarBatch:
    return ColumnarBatch([port_column(data, n, device) for n in COLUMNS],
                         torch.ones(N, dtype=torch.bool, device=device),
                         PT.Schema([PT.StructField(n, PT.TYPES_BY_NAME[
                             TYPES[n]]) for n in COLUMNS]))


# every single column, then folds over several (the running hash as the
# next column's seed), all of them, none, and a null literal
CASES = {c: (c,) for c in COLUMNS}
CASES.update({"i64,x,d,s": ("i64", "x", "d", "s"), "s,s2": ("s", "s2"),
              "b,f,t": ("b", "f", "t"), "x,i32,s,i8,i16": ("x", "i32", "s",
                                                           "i8", "i16"),
              "all": tuple(COLUMNS), "none": (), "null,i32": (None, "i32")})


def build(E, H, T, case):
    def child(c):
        if c is None:
            return E.Literal(None)
        return E.BoundReference(COLUMNS.index(c), _type(T, TYPES[c]), c)
    return H.Murmur3Hash(*[child(c) for c in CASES[case]])


def _type(T, name):
    return {t.name: t for t in (
        T.BooleanType, T.ByteType, T.ShortType, T.IntegerType, T.LongType,
        T.FloatType, T.DoubleType, T.DateType, T.TimestampType,
        T.StringType)}[name]


def port_hash(data, case, device="cpu") -> np.ndarray:
    out = build(PE, PH, PT, case).eval(port_batch(data, device))
    assert out.dtype is PT.IntegerType and bool(out.valid.all())
    return out.data.cpu().numpy()


def jax_hash(data, case) -> np.ndarray:
    import jax.numpy as jnp
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.columnar import Column as JColumn
    from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
    from spark_rapids_tpu.ops import expressions as JE
    from spark_rapids_tpu.ops import hashing as JH
    cols = []
    for n in COLUMNS:
        v, ok = data[n]
        t = _type(JT, TYPES[n])
        if t is JT.StringType:
            cols.append(JColumn.from_strings(
                [s if o else None for s, o in zip(v, ok)]))
        else:
            cols.append(JColumn(jnp.asarray(v), jnp.asarray(ok), t))
    batch = JBatch(cols, jnp.ones(N, dtype=jnp.bool_),
                   JT.Schema([JT.StructField(n, _type(JT, TYPES[n]))
                              for n in COLUMNS]))
    out = build(JE, JH, JT, case).eval(batch)
    assert bool(np.asarray(out.valid).all())
    return np.asarray(out.data)


@pytest.fixture(scope="module")
def data():
    return table()


def test_the_table_holds_what_the_cases_need(data):
    for name, (v, valid) in data.items():
        assert 0.05 < 1 - valid.mean() < 0.15, name
    lens = [len(s.encode("utf-8")) for s in data["s"][0]]
    assert min(lens) == 0 and max(lens) >= 60
    assert {n % 4 for n in lens} == {0, 1, 2, 3}
    assert any(max(s.encode("utf-8"), default=0) >= 0x80
               for s in data["s"][0])
    f, x = data["f"][0], data["x"][0]
    assert len({v.tobytes() for v in f[np.isnan(f)]}) >= 3
    assert len({v.tobytes() for v in x[np.isnan(x)]}) >= 3
    assert (np.signbit(x) & (x == 0)).any() and (np.signbit(f) & (f == 0)).any()


@pytest.mark.parametrize("case", list(CASES))
def test_murmur3_hash_equals_the_jax_package_bit_for_bit(case, data):
    got, want = port_hash(data, case), jax_hash(data, case)
    assert got.dtype == want.dtype == np.int32
    bad = np.flatnonzero(got != want)
    assert not len(bad), (case, bad[:4], got[bad[:4]], want[bad[:4]])


@pytest.mark.parametrize("name", ["i64", "x", "d", "s", "i32", "i8"])
def test_murmur3_equals_the_numpy_oracle(name, data):
    """Each non-null column against tpch.murmur3_np (seed 42), and the
    fold of all four that hash_sample's types cover."""
    v, ok = data[name]
    col = port_column(data, name)
    got = PH.spark_hash_column(col, 42).numpy()
    if TYPES[name] == "string":
        v = np.array([s.encode("utf-8") for s in v])
    want = tpch.murmur3_np(v, 42).view(np.int32)
    assert np.array_equal(got[ok], want[ok])
    assert np.all(got[~ok] == 42)


def test_a_fold_equals_the_numpy_oracle(data):
    names = ("i64", "x", "d", "s")
    ok = np.logical_and.reduce([data[n][1] for n in names])
    got = PH.spark_hash_columns([port_column(data, n) for n in names])
    h = 42
    for n in names:
        v = data[n][0]
        if TYPES[n] == "string":
            v = np.array([s.encode("utf-8") for s in v])
        h = tpch.murmur3_np(v, h)
    assert ok.sum() > N // 2
    assert np.array_equal(got.numpy()[ok], h.view(np.int32)[ok])


def test_spark_s_hash_of_one_is_its_known_value():
    """Spark's `SELECT hash(1)` is -559580957; a null passes the seed."""
    col = Column.from_numpy(np.array([1, 0], np.int32),
                            np.array([True, False]), PT.IntegerType, 2,
                            "cpu")
    assert PH.spark_hash_column(col, 42).tolist() == [-559580957, 42]


def test_murmur3_s_string_tail_bytes_are_sign_extended():
    """Spark's hashUnsafeBytes mixes each byte past the last 4-byte block
    as a sign-extended int (0x80 as 0xFFFFFF80), not as murmur3's
    standard tail word; the JAX package and the port keep that."""
    text = np.array([b"\x80", b"abcd\xff", b"\x7f"])
    col = Column.from_strings(text, None, 3, "cpu")
    got = PH.spark_hash_column(col, 42).numpy().view(np.uint32)
    assert np.array_equal(got, tpch.murmur3_np(text, 42))

    def one(k, n):  # the tail byte mixed as word k, then finalised
        h = tpch._mix_h_np(np.full(1, 42, np.uint32), np.array([k],
                                                              np.uint32))
        h = h ^ np.uint32(n)
        for shift, mul in ((16, 0x85ebca6b), (13, 0xc2b2ae35)):
            h = (h ^ (h >> np.uint32(shift))) * np.uint32(mul)
        return h ^ (h >> np.uint32(16))
    assert got[0] == one(0xFFFFFF80, 1)[0] != one(0x80, 1)[0]
    assert got[2] == one(0x7F, 1)[0]


# --------------------------------------------------------------------------
# the DSL: hash in select, with_column and group_by through both planners
# --------------------------------------------------------------------------

def _frames(data):
    from test_torch_cast import jax_df, port_df
    return (jax_df(data, None, TYPES),
            port_df(TpuSession(device="cpu"), data, TYPES))


def test_dsl_hash_equals_the_jax_package(data):
    from spark_rapids_tpu.plan import logical as JL
    jdf, pdf = _frames(data)

    def rows(L, df):
        F, c = L.functions, L.col
        part = L.ColumnExpr("Pmod", (F.hash(c("i64"), c("s")), L.lit(16)))
        return [
            df.select(F.hash(c("x")).alias("h1"),
                      F.hash(c("s"), c("d"), c("b")).alias("h2"),
                      F.hash().alias("h0")).collect(),
            df.with_column("h", F.hash(*[c(n) for n in COLUMNS]))
            .select("h").collect(),
            df.group_by(part.alias("p")).agg(
                L.functions.count(L.lit(1)).alias("n"),
                L.functions.sum(c("i32")).alias("s"))
            .order_by("p").collect()]
    want, got = rows(JL, jdf), rows(PL, pdf)
    assert [len(r) for r in got] == [N, N, 16]
    assert got == want


# --------------------------------------------------------------------------
# tpch.MATH_QUERIES
# --------------------------------------------------------------------------

CONF = {"spark.rapids.sql.variableFloatAgg.enabled": "true"}
HASH_QUERIES = ("hash_partitions", "hash_sample")


def jax_math_rows(name):
    """(port rows, JAX rows) of tpch.MATH_QUERIES[name] over the JAX
    package's SF0.01 lineitem, the JAX query built by the same function
    from the JAX package's DSL."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    from spark_rapids_tpu.plan import logical as JL
    from test_torch_cast_text import _jax_lineitem, _jax_type
    t = _jax_lineitem()
    jdf = JaxSession(dict(CONF)).from_pydict(
        {f.name: (np.char.decode(t[f.name], "utf-8").tolist()
                  if f.dtype.is_string else t[f.name].tolist())
         for f in tpch.LINEITEM},
        JT.Schema([JT.StructField(f.name, _jax_type(f.dtype))
                   for f in tpch.LINEITEM]))
    pdf = TpuSession(dict(CONF), device="cpu").from_numpy(t, tpch.LINEITEM)
    q = tpch.MATH_QUERIES[name]
    return t, q(pdf).collect(), q(jdf, JL).collect()


@pytest.mark.parametrize("name", HASH_QUERIES)
def test_hash_query_rows_equal_the_jax_package(name):
    t, got, want = jax_math_rows(name)
    assert got == want and len(got) == {"hash_partitions": 200,
                                        "hash_sample": 8}[name]
    assert tpch.match_math_query(name, tpch.ORACLES[name](t), got)


@pytest.mark.parametrize("name", list(tpch.MATH_QUERIES))
def test_math_query_matches_the_numpy_oracle(name):
    """The port's own generator and oracle (what chip_smoke.py runs at
    SF10), over several batches."""
    t = tpch.generate_lineitem(0.01)
    s = TpuSession(dict(CONF, **{
        "spark.rapids.sql.reader.batchSizeRows": "20000"}), device="cpu")
    got = tpch.MATH_QUERIES[name](s.from_numpy(t, tpch.LINEITEM)).collect()
    want = tpch.ORACLES[name](t)
    assert got and tpch.match_math_query(name, want, got)
    if name == "hash_sample":  # about 1 in 64 lines
        assert abs(sum(r[1] for r in got) * 64 / len(t["l_orderkey"])
                   - 1) < 0.1
