"""First, Last, the distinct forms of Count, Sum and Average, and Min/Max
over strings, through the port's TpuSession and the JAX package's, on the
CPU, from one seeded table: rows equal in order (ints, strings and dates
exact, floats under tests/compare.py), grouped and global, in one batch
and in batches of 64 rows behind a filter with a merge fan-in of 2.
Also: what both packages refuse for the device (Percentile, two distinct
children, distinct First), the three AnalysisErrors of Percentile, the
single-batch coalesce both plans put under a distinct aggregate, the
port's (group, value) grouping and string order keys against the JAX
package's, and `tpch.AGG_QUERIES` at SF0.01 against the JAX package (the
same query function built from either package's DSL: `dsl=`) and the
port's numpy oracles.

The JAX package places string Min/Max on its CPU executor (its device
kernel exists but its tagging refuses it), so those rows are its CPU
executor's."""
import os

import numpy as np
import pytest
import torch

from compare import assert_rows_equal
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.engine import TpuSession as JaxSession
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu_torch import TpuSession, tpch
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.exec import aggregate as A
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.plan.analysis import AnalysisError

CONF = {"spark.rapids.sql.variableFloatAgg.enabled": "true"}
# small batches behind a filter: several partial states, merged two at a
# time, and batches that are not compacted
BATCHED = dict(CONF, **{"spark.rapids.sql.reader.batchSizeRows": "64",
                        "spark.rapids.sql.tpu.agg.mergeFanIn": "2"})
N = 700
_TYPES = {"k": "int", "i": "int", "l": "long", "x": "double", "d": "date",
          "s": "string"}
_JT = {"int": JT.IntegerType, "long": JT.LongType, "double": JT.DoubleType,
       "date": JT.DateType, "string": JT.StringType}
_PT = {"int": PT.IntegerType, "long": PT.LongType, "double": PT.DoubleType,
       "date": PT.DateType, "string": PT.StringType}
# strings: empty, multi-byte, and shared prefixes of different lengths
_WORDS = ["", "a", "ab", "abc", "abcdefgh", "abcdefghi", "abcdefghé",
          "é", "€", "\U0001d11e", "zz", "z", "b" * 17, "b" * 16,
          "中文", "ab\x7f"]


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


def _table(seed: int = 7, n: int = N) -> dict:
    """Python columns: k of 23 keys (key 22 holds only null strings and
    null doubles), i, l, x (NaN, +-0.0), d and s with about 10% nulls."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 23, n)
    null = rng.random((5, n)) < 0.1
    xs = rng.choice([0.0, -0.0, np.nan, 1.5, -2.25, 7.0, 1e300], n)
    cols = {"k": k.tolist(),
            "i": rng.integers(-40, 40, n).tolist(),
            "l": rng.integers(-(1 << 62), 1 << 62, n).tolist(),
            "x": xs.tolist(),
            "d": rng.integers(-800, 20000, n).tolist(),
            "s": [_WORDS[j] for j in rng.integers(0, len(_WORDS), n)]}
    for j, name in enumerate(("i", "l", "x", "d", "s")):
        cols[name] = [None if null[j, r] or (name in ("s", "x")
                                             and k[r] == 22) else v
                      for r, v in enumerate(cols[name])]
    return cols


def _frames(conf: dict, data: dict = None):
    """(JAX DataFrame, port DataFrame) over the same table."""
    data = _table() if data is None else data
    jdf = JaxSession(dict(conf)).from_pydict(data, JT.Schema(
        [JT.StructField(c, _JT[_TYPES[c]]) for c in data]))
    pdf = TpuSession(dict(conf), device="cpu").from_numpy(
        data, PT.Schema([PT.StructField(c, _PT[_TYPES[c]]) for c in data]))
    return jdf, pdf


def _both(query, conf=CONF, data=None):
    """`query(df, dsl)` through both packages: the port's rows, asserted
    equal in order to the JAX package's."""
    jdf, pdf = _frames(conf, data)
    want = query(jdf, JL).collect()
    got = query(pdf, PL).collect()
    assert_rows_equal(want, got, ignore_order=False)
    return got


def _batched(df, dsl):
    """The filter of the batched cases: drops about a seventh of the rows
    and every null i, and leaves every batch some live row."""
    return df.filter(dsl.col("i") % 7 != 3)


def _first_last(df, dsl):
    F, col = dsl.functions, dsl.col
    return [f(col(c)).alias(f"{f.__name__}_{c}")
            for c in ("i", "l", "x", "d", "s") for f in (F.first, F.last)]


def _grouped(aggs):
    def q(df, dsl, pre=None):
        df = pre(df, dsl) if pre else df
        return df.group_by(dsl.col("k")).agg(*aggs(df, dsl)).order_by("k")
    return q


def _global(aggs):
    def q(df, dsl, pre=None):
        df = pre(df, dsl) if pre else df
        return df.agg(*aggs(df, dsl))
    return q


_SHAPES = {"grouped": _grouped, "global": _global}


@pytest.mark.parametrize("batches", ["one", "64_filtered"])
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_first_last_rows_equal(shape, batches):
    """First and Last of int, long, double with NaN, date and string,
    nulls included (ignoreNulls false)."""
    q = _SHAPES[shape](_first_last)
    if batches == "one":
        got = _both(q)
    else:
        got = _both(lambda df, dsl: q(df, dsl, _batched), BATCHED)
    assert any(v is None for r in got for v in r) or shape == "global"


def _distinct(value):
    def aggs(df, dsl):
        F, col = dsl.functions, dsl.col
        v = col(value)
        out = [F.count_distinct(v).alias("cd"), F.count(v).alias("c")]
        if value in ("i", "l", "x"):
            out += [F._agg("Sum", v, distinct=True).alias("sd"),
                    F._agg("Average", v, distinct=True).alias("ad"),
                    F.sum(v).alias("s")]
        else:
            out.append(F._agg("Max", v, distinct=True).alias("md"))
        return out
    return aggs


@pytest.mark.parametrize("batches", ["one", "64_filtered"])
@pytest.mark.parametrize("shape", list(_SHAPES))
@pytest.mark.parametrize("value", ["i", "l", "x", "s", "d"])
def test_distinct_rows_equal(value, shape, batches):
    """count, sum and average distinct beside non-distinct aggregates of
    the same column: a null is never counted, NaN equals NaN and -0.0
    equals 0.0; the batched input is coalesced into one batch."""
    q = _SHAPES[shape](_distinct(value))
    if batches == "one":
        got = _both(q)
    else:
        got = _both(lambda df, dsl: q(df, dsl, _batched), BATCHED)
    cd = 0 if shape == "global" else 1
    assert got and all(r[cd] <= r[cd + 1] for r in got)


def _string_bounds(df, dsl):
    F, col = dsl.functions, dsl.col
    return [F.min(col("s")).alias("mn"), F.max(col("s")).alias("mx"),
            F.count(col("s")).alias("c")]


@pytest.mark.parametrize("batches", ["one", "64_filtered"])
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_string_min_max_rows_equal(shape, batches):
    """Byte-order min and max: empty strings, multi-byte text, prefixes
    of different lengths, and a group whose strings are all null."""
    q = _SHAPES[shape](_string_bounds)
    if batches == "one":
        got = _both(q)
    else:
        got = _both(lambda df, dsl: q(df, dsl, _batched), BATCHED)
    if shape == "grouped":
        assert got[-1][0] == 22 and got[-1][1:] == (None, None, 0)


_FAMILIES = {"first_last": _first_last, "distinct": _distinct("l"),
             "strings": _string_bounds}


@pytest.mark.parametrize("family", list(_FAMILIES))
def test_global_aggregate_over_an_empty_table(family):
    """One row of nulls, with count 0, as the JAX package gives."""
    got = _both(_global(_FAMILIES[family]), data=_table(n=0))
    assert len(got) == 1 and set(got[0]) <= {None, 0}


@pytest.mark.parametrize("family", list(_FAMILIES))
def test_global_aggregate_over_rows_all_filtered(family):
    """One row of nulls, with count 0, in the port.  The JAX package's
    First/Last there take a row the filter dropped (its global kernel
    picks the last row of a batch with no live row, valid as it was):
    the port does not keep that quirk; the other families agree."""
    def q(df, dsl):
        return _global(_FAMILIES[family])(
            df, dsl, lambda d, m: d.filter(m.col("k") > 100))
    jdf, pdf = _frames(CONF)
    got = q(pdf, PL).collect()
    assert len(got) == 1 and set(got[0]) <= {None, 0}
    want = q(jdf, JL).collect()
    if family == "first_last":
        assert any(v is not None for v in want[0])
    else:
        assert_rows_equal(want, got, ignore_order=False)


def _find(node, name):
    if type(node).__name__ == name:
        return node
    for c in node.children:
        found = _find(c, name)
        if found is not None:
            return found
    return None


@pytest.mark.parametrize("shape", list(_SHAPES))
def test_distinct_plans_coalesce_one_batch_under_the_aggregate(shape):
    jdf, pdf = _frames(BATCHED)
    q = _SHAPES[shape](_distinct("i"))
    for df, dsl in ((jdf, JL), (pdf, PL)):
        agg = _find(q(df, dsl).physical_plan(), "TpuHashAggregateExec")
        child = agg.children[0]
        assert type(child).__name__ == "TpuCoalesceBatchesExec"
        assert child.goal == "single"
    # and none without a distinct aggregate
    plain = _SHAPES[shape](_first_last)(pdf, PL).physical_plan()
    assert _find(plain, "TpuCoalesceBatchesExec") is None


_REFUSED = {
    "percentile": (lambda F, col: [F.percentile(col("i"), 0.5)],
                   "percentile is not supported"),
    "two_distinct_children": (
        lambda F, col: [F.count_distinct(col("i")),
                        F.count_distinct(col("l"))],
        "multiple distinct aggregate children"),
    "distinct_first": (lambda F, col: [F._agg("First", col("i"),
                                              distinct=True)],
                       "distinct First is not supported"),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_refused_at_planning_time(case):
    """The JAX package places these on its CPU executor; the port, which
    has none, raises when it plans."""
    build, reason = _REFUSED[case]
    jdf, pdf = _frames(CONF)
    jq = jdf.group_by(JL.col("k")).agg(*build(JL.functions, JL.col))
    assert reason in jq.explain()
    pq = pdf.group_by(PL.col("k")).agg(*build(PL.functions, PL.col))
    with pytest.raises(NotImplementedError, match=reason):
        pq.physical_plan()


_ANALYSIS = {"distinct": ("s", True, 0.5, "percentile\\(DISTINCT\\)"),
             "p_above_one": ("i", False, 1.5, "outside \\[0, 1\\]"),
             "string_child": ("s", False, 0.5, "percentile over string")}


@pytest.mark.parametrize("case", list(_ANALYSIS))
def test_percentile_analysis_errors_equal(case):
    child, distinct, p, message = _ANALYSIS[case]
    jdf, pdf = _frames(CONF)
    for df, dsl in ((jdf, JL), (pdf, PL)):
        expr = dsl.ColumnExpr("Percentile", (dsl.col(child), distinct, p))
        with pytest.raises(Exception, match=message) as err:
            df.agg(expr).physical_plan()
        assert type(err.value).__name__ == "AnalysisError"
    with pytest.raises(AnalysisError):
        pdf.agg(PL.ColumnExpr("Percentile", (PL.col(child), distinct,
                                              p))).schema


@pytest.mark.parametrize("aggs", ["first", "last", "count_distinct",
                                  "string_min"])
def test_never_takes_the_bucket_path(aggs):
    """With 23 keys every batch's bucket check would come back clean:
    these aggregates must sort all the same."""
    build = {"first": lambda F, c: F.first(c("i")),
             "last": lambda F, c: F.last(c("s")),
             "count_distinct": lambda F, c: F.count_distinct(c("i")),
             "string_min": lambda F, c: F.min(c("s"))}[aggs]
    _, pdf = _frames(BATCHED)
    df = pdf.group_by(PL.col("k")).agg(build(PL.functions, PL.col),
                                       PL.functions.sum(PL.col("l")))
    df.collect()
    agg = _find(df.session.last_plan, "TpuHashAggregateExec")
    assert agg.update_paths["bucket"] == 0 and agg.update_paths["sort"] > 0
    assert not agg._bucketable()


def test_first_last_positions_survive_the_shrink():
    """A selective filter over batches of 2^14 rows: the aggregate
    shrinks each batch (live rows gathered to the front) before its
    update, and First/Last still pick each key's first and last
    surviving row of the whole input."""
    n = 40000
    rng = np.random.default_rng(3)
    k = rng.integers(0, 5, n)
    v = np.arange(n, dtype=np.int64)
    keep = rng.random(n) < 0.05
    s = TpuSession(dict(CONF, **{
        "spark.rapids.sql.reader.batchSizeRows": "10000",
        "spark.rapids.sql.tpu.agg.mergeFanIn": "2"}), device="cpu")
    df = s.from_numpy({"k": k, "v": v, "keep": keep})
    got = (df.filter(PL.col("keep")).group_by(PL.col("k"))
           .agg(PL.functions.first(PL.col("v")),
                PL.functions.last(PL.col("v"))).order_by("k").collect())
    want = [(g, int(v[keep & (k == g)][0]), int(v[keep & (k == g)][-1]))
            for g in range(5)]
    assert got == want


@pytest.mark.parametrize("keys", [["k"], ["k", "s"], []])
def test_group_rows_with_values_identical(keys):
    """The (group, value) order of the distinct dedup: the same
    permutation, boundaries and group count as the JAX package's."""
    from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
    from spark_rapids_tpu.exec import aggregate as JA
    from test_torch_aggregate import _port_batch
    data = {c: v for c, v in _table().items() if c != "d"}
    jb = JBatch.from_pydict(data, JT.Schema(
        [JT.StructField(c, _JT[_TYPES[c]]) for c in data]))
    pb = _port_batch(jb)
    names = list(data)
    kj = [jb.columns[names.index(c)] for c in keys]
    kp = [pb.columns[names.index(c)] for c in keys]
    vj, vp = jb.columns[names.index("x")], pb.columns[names.index("x")]
    j_order, _jg, j_bound, j_n = JA.group_rows(kj, jb.sel, [vj])
    p_order, _pg, p_bound, p_n = A.group_rows(kp, pb.sel, True, [vp])
    assert np.array_equal(p_order.numpy(), np.asarray(j_order))
    assert np.array_equal(p_bound.numpy(), np.asarray(j_bound))
    assert int(p_n) == int(j_n)


def test_string_order_keys_identical():
    from spark_rapids_tpu.columnar import Column as JColumn
    from spark_rapids_tpu.exec import aggregate as JA
    from spark_rapids_tpu_torch.columnar import Column
    words = _WORDS * 3
    jc = JColumn.from_strings(words, capacity=64)
    pc = Column(torch.from_numpy(np.array(jc.data)),
                torch.from_numpy(np.array(jc.valid)), PT.StringType,
                torch.from_numpy(np.array(jc.lengths, dtype=np.int32)))
    want = JA._string_order_keys(jc)
    got = list(A._string_order_keys(pc))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# tpch.AGG_QUERIES
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sf001():
    """The port's tables at SF0.01."""
    return tpch.generate(0.01)


def _jax_frames(tables: dict) -> dict:
    """The port's numpy tables as JAX DataFrames (dates as day counts)."""
    js = JaxSession(dict(CONF))
    out = {}
    for name, cols in tables.items():
        schema = tpch.SCHEMAS[name]
        out[name] = js.from_pydict(
            {f.name: (np.char.decode(cols[f.name], "utf-8").tolist()
                      if f.dtype.is_string else cols[f.name].tolist())
             for f in schema},
            JT.Schema([JT.StructField(f.name, _JT[f.dtype.name])
                       for f in schema]))
    return out


def _port_frames(tables: dict, conf=CONF) -> dict:
    s = TpuSession(dict(conf), device="cpu")
    return {n: s.from_numpy(t, tpch.SCHEMAS[n]) for n, t in tables.items()}


@pytest.mark.parametrize("name", list(tpch.AGG_QUERIES))
def test_agg_query_rows_equal_the_jax_package(sf001, name):
    q = tpch.AGG_QUERIES[name]
    want = q(_jax_frames(sf001), JL).collect()
    got = q(_port_frames(sf001)).collect()
    assert got
    assert_rows_equal(want, got, ignore_order=False)


@pytest.mark.parametrize("name", list(tpch.AGG_QUERIES))
def test_agg_query_matches_the_numpy_oracle(sf001, name):
    """Over batches of 20,000 rows (lineitem and orders take several), so
    the coalesce and the First/Last merge run."""
    pt = _port_frames(sf001, dict(CONF, **{
        "spark.rapids.sql.reader.batchSizeRows": "20000"}))
    got = tpch.AGG_QUERIES[name](pt).collect()
    assert got and tpch.match_agg_query(name, tpch.ORACLES[name](sf001),
                                        got)
    if name in ("q16_distinct", "q21_distinct"):
        base = tpch.JOIN_QUERIES[name.split("_")[0]](pt).collect()
        assert got == base
    if name == "priority_migration":
        assert len(got) == 25


def test_priority_migration_keeps_the_sort_under_the_aggregate(sf001):
    """First/Last read the sorted order: both planners keep the sort
    below the per-customer aggregate."""
    for dfs, dsl in ((_jax_frames(sf001), JL), (_port_frames(sf001), PL)):
        plan = tpch.priority_migration(dfs, dsl).physical_plan()
        aggs = []
        node = plan
        while node is not None:
            node = _find(node, "TpuHashAggregateExec")
            if node is not None:
                aggs.append(node)
                node = node.children[0]
        assert len(aggs) == 2
        assert _find(aggs[1], "TpuSortExec") is not None
