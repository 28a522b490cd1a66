"""Union, Distinct and Expand (rollup and cube) through the port's
TpuSession and the JAX package's, on the CPU, from one seeded table: rows
equal in order (ints, strings and dates exact, floats under
tests/compare.py), in one batch and at `batchSizeRows` 64.  Also: the
JAX package's own rollup and cube cases (tests/test_aggregate.py)
replayed on the port, the Expand's names, types and grouping ids, its
one batch per projection, the plans (TpuUnionExec, TpuExpandExec with its
projection count, Distinct as an aggregate with no aggregate expression,
the scan columns pruning leaves under an Expand and a Union, the build
side of a join over a union or a rollup), the unions the port refuses at
planning time, and `tpch.SET_QUERIES` at SF0.01 against the JAX package
(the same query function built from either package's DSL: `dsl=`) and
the port's numpy oracles."""
import os

import numpy as np
import pytest
import torch

from compare import assert_rows_equal
from test_torch_agg_functions import _jax_frames, _port_frames
from test_torch_join import join_nodes
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.engine import DataFrame as JaxDataFrame
from spark_rapids_tpu.engine import GroupedData as JaxGroupedData
from spark_rapids_tpu.engine import TpuSession as JaxSession
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu_torch import DataFrame, TpuSession, tpch
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.engine import GroupedData
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.plan import logical as PL

CONF = {"spark.rapids.sql.variableFloatAgg.enabled": "true"}
BATCHED = dict(CONF, **{"spark.rapids.sql.reader.batchSizeRows": "64",
                        "spark.rapids.sql.tpu.agg.mergeFanIn": "2"})
# (conf, rows of the seeded table): one batch, or batches of 64 merged
# two at a time over fewer rows (each batch adds an update and a merge)
CONFS = {"one": (CONF, 600), "64": (BATCHED, 256)}
NO_BROADCAST = dict(CONF, **{"spark.sql.autoBroadcastJoinThreshold": "-1"})
N = 600
N_BATCHED = 256
_TYPES = {"k": "int", "s": "string", "t": "string", "x": "double",
          "d": "date", "b": "boolean", "l": "long", "v": "double"}
_JT = {"int": JT.IntegerType, "long": JT.LongType, "double": JT.DoubleType,
       "date": JT.DateType, "string": JT.StringType,
       "boolean": JT.BooleanType}
_PT = {"int": PT.IntegerType, "long": PT.LongType, "double": PT.DoubleType,
       "date": PT.DateType, "string": PT.StringType,
       "boolean": PT.BooleanType}
# up to 17 bytes (a width of 32); `t` stays within 8
_WORDS = ["", "a", "ab", "abcdefghi", "é", "€", "zz", "b" * 17, "中文"]
_SHORT = ["", "a", "b", "cd"]


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


def _table(seed: int = 11, n: int = N) -> dict:
    """Python columns, about 10% of each null: k of 12 keys, s and t
    text, x doubles with NaN and +-0.0, d dates of 9 days, b booleans, l
    longs over 8 values, v doubles without NaN."""
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 12, n).tolist(),
            "s": [_WORDS[j] for j in rng.integers(0, len(_WORDS), n)],
            "t": [_SHORT[j] for j in rng.integers(0, len(_SHORT), n)],
            "x": rng.choice([0.0, -0.0, np.nan, 1.5, -2.25, 7.0],
                            n).tolist(),
            "d": rng.integers(18000, 18009, n).tolist(),
            "b": (rng.random(n) < 0.5).tolist(),
            "l": (rng.integers(-4, 4, n) * (1 << 60)).tolist(),
            "v": np.round(rng.uniform(-100, 100, n), 2).tolist()}
    null = rng.random((len(cols), n)) < 0.1
    return {c: [None if null[j, r] else v for r, v in enumerate(vals)]
            for j, (c, vals) in enumerate(cols.items())}


def _sessions(conf: dict):
    return JaxSession(dict(conf)), TpuSession(dict(conf), device="cpu")


def _make(js, ps, data: dict):
    """(JAX DataFrame, port DataFrame) of one table in the two sessions."""
    names = list(data)
    return (js.from_pydict(data, JT.Schema(
        [JT.StructField(c, _JT[_TYPES[c]]) for c in names])),
        ps.from_numpy(data, PT.Schema(
            [PT.StructField(c, _PT[_TYPES[c]]) for c in names])))


def _port_df(batches: str):
    """The seeded table in a port session alone."""
    conf, n = CONFS[batches]
    return TpuSession(dict(conf), device="cpu").from_numpy(
        _table(n=n), PT.Schema([PT.StructField(c, _PT[t])
                             for c, t in _TYPES.items()]))


def _both(query, batches="one", tables=None):
    """`query(dfs, dsl)` through both packages under CONFS[batches], dfs
    a list of DataFrames over `tables` (the seeded table of CONFS'
    rows by default): the port's rows, asserted equal in order to the
    JAX package's."""
    conf, n = CONFS[batches]
    js, ps = _sessions(conf)
    tables = tables or [_table(n=n)]
    pairs = [_make(js, ps, t) for t in tables]
    want = query([j for j, _ in pairs], JL).collect()
    got = query([p for _, p in pairs], PL).collect()
    assert_rows_equal(want, got, ignore_order=False)
    return got


def _find_all(node, name, seen=None):
    """The nodes of class `name` in a plan of either package (the JAX
    package's fused stages hold their row-local execs in `stages`)."""
    seen = set() if seen is None else seen
    if id(node) in seen:
        return []
    seen.add(id(node))
    out = [node] if type(node).__name__ == name else []
    for c in list(getattr(node, "stages", ())) + list(node.children):
        out += _find_all(c, name, seen)
    return out


# --------------------------------------------------------------------------
# union
# --------------------------------------------------------------------------

def _widths(dfs, dsl):
    """Two children of different capacities and string widths: the 600
    rows' text (32 bytes wide) and a table of thrice the rows' short text
    (8)."""
    col = dsl.col
    return dfs[0].select(col("k"), col("s"), col("x")).union(
        dfs[1].select(col("k"), col("t").alias("s"), col("x")))


_UNIONS = {
    "two": lambda dfs, dsl: dfs[0].union(
        dfs[0].filter(dsl.col("k") < 5)),
    "unionAll_three": lambda dfs, dsl: dfs[0].unionAll(dfs[1]).unionAll(
        dfs[0].filter(dsl.col("b"))),
    "widths": _widths,
    "widths_grouped": lambda dfs, dsl: _widths(dfs, dsl)
    .group_by(dsl.col("k")).agg(
        dsl.functions.count(dsl.lit(1)).alias("n"),
        dsl.functions.count(dsl.col("s")).alias("ns"),
        dsl.functions.min(dsl.col("s")).alias("mn"),
        dsl.functions.max(dsl.col("s")).alias("mx"),
        dsl.functions.sum(dsl.col("x")).alias("sx")).order_by("k"),
    "widths_count_distinct": lambda dfs, dsl: _widths(dfs, dsl)
    .group_by(dsl.col("k")).agg(
        dsl.functions.count_distinct(dsl.col("s")).alias("cd"),
        dsl.functions.first(dsl.col("s")).alias("fs"),
        dsl.functions.last(dsl.col("x")).alias("lx")).order_by("k"),
    "widths_distinct": lambda dfs, dsl: _widths(dfs, dsl).distinct()
    .order_by("k", "s", "x"),
}


@pytest.mark.parametrize("case,batches", [
    (c, "one") for c in _UNIONS] + [(c, "64") for c in (
        "two", "widths_grouped", "widths_count_distinct")])
def test_union_rows_equal(case, batches):
    """Each child's rows in turn; under an aggregate, batches of two
    capacities and two string widths update, merge and (count_distinct)
    coalesce into one batch."""
    n = CONFS[batches][1]
    got = _both(_UNIONS[case], batches,
                [_table(n=n), _table(seed=12, n=3 * n)])
    assert got


def test_union_names_come_from_the_first_child():
    """By position: the second child's names do not matter.  The JAX
    package runs such a union under an aggregate but cannot collect it
    (its host tables' schemas differ), so the rows are held to its
    distinct's."""
    def q(dfs, dsl):
        col = dsl.col
        return dfs[0].select(col("k"), col("s")).union(
            dfs[0].select(col("k").alias("k2"), col("t").alias("s2")))
    js, ps = _sessions(CONF)
    jdf, pdf = _make(js, ps, _table())
    assert q([pdf], PL).schema.names == ["k", "s"]
    assert q([pdf], PL).to_pydict().keys() == {"k", "s"}
    with pytest.raises(Exception):
        q([jdf], JL).collect()
    want = q([jdf], JL).distinct().order_by("k", "s").collect()
    got = q([pdf], PL).distinct().order_by("k", "s").collect()
    assert_rows_equal(want, got, ignore_order=False)


_MISMATCHED = {
    "arity": lambda dsl: (["k", "v"], ["k"]),
    "int_long": lambda dsl: (["k", "v"], [dsl.col("l").alias("k"), "v"]),
    "string_int": lambda dsl: (["k", "v"], [dsl.col("s").alias("k"), "v"]),
    "swapped": lambda dsl: (["k", "v"], ["v", "k"]),
}


@pytest.mark.parametrize("case", list(_MISMATCHED))
def test_union_of_unlike_children_is_refused_at_planning(case):
    """Children that differ in arity or in a column's type: the JAX
    package concatenates by position without a check and cannot collect
    the result (nor, but for an int and a long, aggregate it); the port
    raises when it plans, and widens no type."""
    js, ps = _sessions(CONF)
    jdf, pdf = _make(js, ps, _table())
    for df, dsl in ((jdf, JL), (pdf, PL)):
        a, b = _MISMATCHED[case](dsl)
        u = df.select(*a).union(df.select(*b))
        if dsl is JL:
            with pytest.raises(Exception):
                u.collect()
        else:
            with pytest.raises(NotImplementedError, match="a union of"):
                u.physical_plan()


# --------------------------------------------------------------------------
# distinct
# --------------------------------------------------------------------------

_DISTINCT_COLUMNS = {"int": ["k"], "string": ["s"], "double": ["x"],
                     "date": ["d"], "boolean": ["b"],
                     "every_type": ["k", "s", "x", "d", "b", "l"]}


@pytest.mark.parametrize("columns,batches", [
    (c, "one") for c in _DISTINCT_COLUMNS] + [(c, "64") for c in (
        "string", "double", "boolean")])
def test_distinct_rows_equal(columns, batches):
    """Nulls form one row, NaN one row and 0.0 and -0.0 one row, as the
    JAX package groups them; the single column takes the bucket path,
    every type together the sort path."""
    names = _DISTINCT_COLUMNS[columns]
    got = _both(lambda dfs, dsl: dfs[0].select(*names).distinct()
                .order_by(*names), batches)
    assert any(None in r for r in got)
    if columns == "double":
        assert len(got) == 6  # null, -2.25, 0.0, 1.5, 7.0 and NaN


@pytest.mark.parametrize("columns", list(_DISTINCT_COLUMNS))
def test_distinct_update_path(columns):
    """A distinct is an aggregate with no aggregate expression: one
    column's few values stay on the bucket path, every type together
    (~600 groups in 1024 buckets) goes to the sort path."""
    path = "sort" if columns == "every_type" else "bucket"
    df = _port_df("one").select(*_DISTINCT_COLUMNS[columns]).distinct()
    df.collect()
    (agg,) = _find_all(df.session.last_plan, "TpuHashAggregateExec")
    assert agg.aggregates == []
    assert agg.update_paths[path] == 1 and sum(
        agg.update_paths.values()) == 1


# --------------------------------------------------------------------------
# rollup and cube
# --------------------------------------------------------------------------

def _aggs(dsl):
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    return [F.count(lit(1)).alias("n"), F.sum(col("v")).alias("sv"),
            F.min(col("x")).alias("mx"), F.max(col("d")).alias("md")]


_ROLLUPS = {"rollup_k": ("rollup", ["k"]),
            "rollup_k_s": ("rollup", ["k", "s"]),
            "rollup_s_d_b": ("rollup", ["s", "d", "b"]),
            "cube_k_s": ("cube", ["k", "s"]),
            "cube_b_d_t": ("cube", ["b", "d", "t"])}


@pytest.mark.parametrize("case,batches", [
    (c, "one") for c in _ROLLUPS] + [(c, "64") for c in (
        "rollup_k_s", "cube_b_d_t")])
def test_rollup_and_cube_rows_equal(case, batches):
    """Every grouping set's rows, a data null beside the rolled-up null
    of the same keys (the grouping id keeps them apart), ordered by the
    keys and the count."""
    kind, keys = _ROLLUPS[case]

    def q(dfs, dsl):
        g = getattr(dfs[0], kind)(*[dsl.col(k) for k in keys])
        return g.agg(*_aggs(dsl)).order_by(*keys, "n")
    got = _both(q, batches)
    n = CONFS[batches][1]
    sets = len(keys) + 1 if kind == "rollup" else 1 << len(keys)
    assert (None,) * len(keys) + (n,) in [r[:len(keys) + 1] for r in got]
    assert sum(r[len(keys)] for r in got) == sets * n


def _replay(cols: dict, types: dict, query):
    js, ps = _sessions(CONF)
    jdf = js.from_pydict(cols, JT.Schema(
        [JT.StructField(c, _JT[types[c]]) for c in cols]))
    pdf = ps.from_numpy(cols, PT.Schema(
        [PT.StructField(c, _PT[types[c]]) for c in cols]))
    want = query(jdf, JL).collect()
    got = query(pdf, PL).collect()
    assert_rows_equal(want, got)
    return got


def test_rollup_grouping_sets():
    """tests/test_aggregate.py's case: a data-null key stays a row of its
    own beside the rolled-up subtotal."""
    def q(df, dsl):
        F, col = dsl.functions, dsl.col
        return df.rollup(col("ch"), col("id")).agg(
            F.sum(col("v")).alias("sv"), F.count(col("v")).alias("c"))
    rows = _replay({"ch": ["a", "a", "b", "b", None],
                    "id": ["x", "y", "x", "x", "z"],
                    "v": [1.0, 2.0, 3.0, 4.0, 5.0]},
                   {"ch": "string", "id": "string", "v": "double"}, q)
    assert len(rows) == 8
    assert (None, None, 15.0, 5) in rows
    assert (None, None, 5.0, 1) in rows


def test_rollup_compound_agg():
    def q(df, dsl):
        F, col = dsl.functions, dsl.col
        return df.rollup(col("k"), col("g")).agg(
            (F.sum(col("v")) / F.count(col("v"))).alias("m"))
    rng = np.random.default_rng(33)
    rows = _replay({"k": rng.integers(0, 5, 200).tolist(),
                    "g": rng.integers(0, 3, 200).tolist(),
                    "v": [None if r < 0.1 else int(x) for r, x in zip(
                        rng.random(200), rng.integers(-50, 50, 200))]},
                   {"k": "int", "g": "int", "v": "long"}, q)
    assert len(rows) == 15 + 5 + 1


def test_rollup_aggregate_over_key_column():
    """An aggregate over a key reads its real values in subtotal rows."""
    def q(df, dsl):
        F, col = dsl.functions, dsl.col
        return df.rollup(col("k")).agg(F.sum(col("k")).alias("sk"),
                                       F.sum(col("v")).alias("sv"))
    rows = _replay({"k": [1, 1, 2, 2], "v": [10, 20, 30, 40]},
                   {"k": "int", "v": "long"}, q)
    assert (None, 6, 100) in rows


def test_cube_grouping_sets():
    def q(df, dsl):
        F, col = dsl.functions, dsl.col
        return df.cube(col("a"), col("b")).agg(F.sum(col("v")).alias("sv"))
    rows = _replay({"a": [1, 1, 2, 2], "b": ["x", "y", "x", "y"],
                    "v": [10, 20, 30, 40]},
                   {"a": "int", "b": "string", "v": "long"}, q)
    assert len(rows) == 9
    assert {(None, "x", 40), (1, None, 30), (None, None, 100)} <= set(rows)


@pytest.mark.parametrize("batches", list(CONFS))
@pytest.mark.parametrize("kind", ["rollup", "cube"])
def test_expand_rows_names_types_and_grouping_ids(kind, batches):
    """The Expand alone, collected: every original column, a nullable
    `_gkey_` copy per key and `_grouping_id` of the JAX package's int
    type, Spark's ids (a cube's bits mark the pruned keys; a rollup
    keeping g of n keys has 2^(n-g) - 1), its rows in the JAX package's
    order."""
    conf, n = CONFS[batches]
    js, ps = _sessions(conf)
    jdf, pdf = _make(js, ps, _table(n=n))
    out = []
    for df, dsl, grouped, frame in ((jdf, JL, JaxGroupedData, JaxDataFrame),
                                    (pdf, PL, GroupedData, DataFrame)):
        g = grouped(df, [dsl.col("k"), dsl.col("s")], rollup=True,
                    cube=kind == "cube")
        expand, keys = g._expand_rollup(df.plan)
        assert [k.output_name for k in keys] == ["k", "s", "_grouping_id"]
        edf = frame(df.session, expand)
        out.append((edf.schema, edf.collect()))
    (jschema, want), (pschema, got) = out
    assert pschema.names == jschema.names == list(_TYPES) + [
        "_gkey_k", "_gkey_s", "_grouping_id"]
    assert [f.dtype.name for f in pschema] == [f.dtype.name
                                               for f in jschema]
    assert pschema[len(pschema) - 1].dtype is PT.IntegerType
    assert_rows_equal(want, got, ignore_order=False)
    ids = [0, 1, 3] if kind == "rollup" else [0, 1, 2, 3]
    if batches == "one":
        assert [r[-1] for r in got[::n]] == ids
    assert sorted({r[-1] for r in got}) == ids


@pytest.mark.parametrize("key", ["expression", "missing"])
def test_rollup_key_must_be_an_existing_column(key):
    js, ps = _sessions(CONF)
    jdf, pdf = _make(js, ps, _table())
    for df, dsl in ((jdf, JL), (pdf, PL)):
        k = dsl.col("k") + 1 if key == "expression" else dsl.col("nope")
        with pytest.raises(ValueError, match="rollup keys must be existing"):
            df.rollup(k).agg(dsl.functions.count(dsl.lit(1)))


@pytest.mark.parametrize("batches", list(CONFS))
@pytest.mark.parametrize("kind", ["group_by", "rollup"])
def test_grouped_count(kind, batches):
    got = _both(lambda dfs, dsl: getattr(dfs[0], kind)(dsl.col("k"))
                .count().order_by("k", "count"), batches)
    assert sum(r[1] for r in got) == CONFS[batches][1] * (
        2 if kind == "rollup" else 1)
    df = _port_df("one")
    assert getattr(df, kind)(PL.col("k")).count().schema.names == [
        "k", "count"]


@pytest.mark.parametrize("batches", list(CONFS))
def test_first_last_and_a_distinct_above_an_expand(batches):
    """First/Last positions run on across the Expand's batches as they
    do across the JAX package's one concatenated batch; the distinct
    count coalesces the projections' batches into one."""
    def q(dfs, dsl):
        F, col = dsl.functions, dsl.col
        return dfs[0].rollup(col("b"), col("t")).agg(
            F.first(col("l")).alias("fl"), F.last(col("s")).alias("ls"),
            F.count_distinct(col("d")).alias("cd"),
            F.count(dsl.lit(1)).alias("n")).order_by("b", "t", "n")
    got = _both(q, batches)
    assert got
    plan = q([_port_df(batches)], PL).physical_plan()
    (co,) = _find_all(plan, "TpuCoalesceBatchesExec")
    assert type(co.children[0]).__name__ == "TpuExpandExec"


def test_expand_yields_one_batch_per_projection():
    """In projection order for each input batch, every batch at the
    input's capacity with one string width per column (a null key copy
    padded to the widest)."""
    pdf = _port_df("64")
    plan = pdf.cube(PL.col("s"), PL.col("t")).count().physical_plan()
    (ex,) = _find_all(plan, "TpuExpandExec")
    batches = list(ex.execute(ExecContext(pdf.session.conf,
                                          pdf.session.device)))
    assert len(ex.projections) == 4
    assert len(batches) == 4 * -(-N_BATCHED // 64)
    strings = [i for i, f in enumerate(ex.schema) if f.dtype.is_string]
    widths = {tuple(b.columns[i].max_len for i in strings) for b in batches}
    assert len(widths) == 1
    assert {b.capacity for b in batches} == {1024}
    ids = [int(b.columns[-1].data[0]) for b in batches[:4]]
    assert ids == [0, 1, 2, 3]


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

def _plans(query, conf=CONF):
    js, ps = _sessions(conf)
    jdf, pdf = _make(js, ps, _table())
    return (query(jdf, JL).physical_plan(), query(pdf, PL).physical_plan())


@pytest.mark.parametrize("kind,keys,projections", [
    ("rollup", ["k", "s"], 3), ("rollup", ["s", "d", "b"], 4),
    ("cube", ["b", "d", "t"], 8)])
def test_expand_plan(kind, keys, projections):
    plans = _plans(lambda df, dsl: getattr(df, kind)(
        *[dsl.col(k) for k in keys]).count())
    for plan in plans:
        (ex,) = _find_all(plan, "TpuExpandExec")
        assert len(ex.projections) == projections
        (agg,) = _find_all(plan, "TpuHashAggregateExec")
        assert len(agg.grouping) == len(keys) + 1


def test_union_and_distinct_plans():
    plans = _plans(lambda df, dsl: df.union(df.filter(dsl.col("k") > 3))
                   .distinct())
    for plan in plans:
        (u,) = _find_all(plan, "TpuUnionExec")
        assert len(u.children) == 2
        aggs = _find_all(plan, "TpuHashAggregateExec")
        assert len(aggs) == 1 and aggs[0].aggregates == []
        assert len(aggs[0].grouping) == len(_TYPES)
    assert plans[1].schema.names == list(_TYPES)


def _scan_columns(plan):
    return sorted(tuple(s.schema.names)
                  for s in _find_all(plan, "TpuScanMemoryExec"))


_PRUNING = {
    # the Expand reads the select's columns; the filter adds k
    "expand": lambda df, dsl: df.filter(dsl.col("k") > 2)
    .select(dsl.col("s"), dsl.col("v"))
    .rollup(dsl.col("s")).agg(dsl.functions.sum(dsl.col("v"))),
    # every column of both children survives: a union prunes nothing
    "union": lambda df, dsl: df.union(df).select(dsl.col("k")),
    # each child keeps its declared output, and prunes below it
    "union_of_projects": lambda df, dsl: df.select(dsl.col("s"))
    .union(df.select(dsl.col("t"))).group_by(dsl.col("s")).count(),
    "distinct": lambda df, dsl: df.distinct().select(dsl.col("k")),
}


@pytest.mark.parametrize("case", list(_PRUNING))
def test_scan_pruning_under_expand_union_and_distinct(case):
    jplan, pplan = _plans(_PRUNING[case])
    assert _scan_columns(pplan) == _scan_columns(jplan)
    if case == "expand":
        assert _scan_columns(pplan) == [("k", "s", "v")]
    if case == "union_of_projects":
        assert _scan_columns(pplan) == [("s",), ("t",)]


_JOINS = {
    # a union of two small tables against a bigger one: the union's
    # estimate is their sum
    "union": lambda dfs, dsl: dfs[0].select(
        dsl.col("k").alias("k2"), dsl.col("v").alias("v2")).union(
            dfs[1].select(dsl.col("k"), dsl.col("v")))
    .join(dfs[2], dsl.col("k2") == dsl.col("k")),
    # a rollup's estimate is its child's times its projections
    "rollup": lambda dfs, dsl: dfs[0].rollup(dsl.col("k")).agg(
        dsl.functions.sum(dsl.col("v")).alias("sv"))
    .select(dsl.col("k").alias("k2"), dsl.col("sv"))
    .join(dfs[2], dsl.col("k2") == dsl.col("k")),
}


@pytest.mark.parametrize("conf", ["broadcast", "hash"])
@pytest.mark.parametrize("case", list(_JOINS))
def test_join_over_a_union_or_a_rollup_builds_the_jax_side(case, conf):
    c = CONF if conf == "broadcast" else NO_BROADCAST
    js, ps = _sessions(c)
    tables = [_table(seed=21, n=150), _table(seed=22, n=150),
              _table(seed=23, n=700)]
    pairs = [_make(js, ps, t) for t in tables]
    jq = _JOINS[case]([j for j, _ in pairs], JL)
    pq = _JOINS[case]([p for _, p in pairs], PL)
    jn, pn = join_nodes(jq.physical_plan()), join_nodes(pq.physical_plan())
    assert pn and jn == pn, (jn, pn)
    assert_rows_equal(jq.collect(), pq.collect())


# --------------------------------------------------------------------------
# tpch.SET_QUERIES
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sf001():
    """The port's tables at SF0.01."""
    return tpch.generate(0.01)


@pytest.mark.parametrize("name", list(tpch.SET_QUERIES))
def test_set_query_rows_equal_the_jax_package(sf001, name):
    q = tpch.SET_QUERIES[name]
    want = q(_jax_frames(sf001), JL).collect()
    got = q(_port_frames(sf001)).collect()
    assert got
    assert_rows_equal(want, got, ignore_order=False)


@pytest.mark.parametrize("name", list(tpch.SET_QUERIES))
def test_set_query_matches_the_numpy_oracle(sf001, name):
    """Over batches of 20,000 rows (lineitem and orders take several), so
    the Expand's and the union's batches merge."""
    pt = _port_frames(sf001, dict(CONF, **{
        "spark.rapids.sql.reader.batchSizeRows": "20000"}))
    got = tpch.SET_QUERIES[name](pt).collect()
    assert got and tpch.match_set_query(name, tpch.ORACLES[name](sf001),
                                        got)
    rows = {"q1_rollup": 10, "cube_orders": 24, "rollup_nation_year": 206,
            "union_supply": 100, "customer_priorities": 5,
            "supplier_reach": 1}
    assert len(got) == rows[name]
