"""TPC-H q1, q6 and q18's inner lineitem aggregate, the other 20 queries
whole (q2, q3, q4, q5, q7, q8, q9, q10, q11, q12, q13, q14, q15, q16,
q17, q18, q19, q20, q21 and q22), and outer joins of orders and
customers, through the JAX package's TpuSession and the port's, on the
same SF0.01 tables (benchmarks/tpch/datagen.py), compared row for row
under the rule of tests/compare.py; for the joins also the join execs of
the two physical plans.  Both sessions allow float aggregation on the
device, so the JAX side runs its device aggregate rather than its CPU
executor.

At SF0.01 q18's aggregate has ~15,000 order keys, far above the 1024
buckets: each package's bucket check comes back dirty and the update
takes the sort path; q1's six groups take the bucket path in both."""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks.tpch import QUERIES, generate, load_tables  # noqa: E402
from benchmarks.tpch.schema import SCHEMAS as JAX_SCHEMAS  # noqa: E402
from compare import assert_rows_equal  # noqa: E402
from test_torch_join import _jax_rows as jax_table_rows  # noqa: E402
from test_torch_join import join_nodes  # noqa: E402
from test_torch_outer_join import plan_joins  # noqa: E402
from spark_rapids_tpu.engine import TpuSession as JaxSession  # noqa: E402
from spark_rapids_tpu.exec import aggregate as JA  # noqa: E402
from spark_rapids_tpu.plan.logical import SortOrder as JSortOrder  # noqa: E402,E501
from spark_rapids_tpu.plan.logical import col as jcol  # noqa: E402
from spark_rapids_tpu.plan.logical import functions as JF  # noqa: E402
from spark_rapids_tpu.plan.logical import lit as jlit  # noqa: E402
from spark_rapids_tpu_torch import TpuSession, tpch  # noqa: E402
from spark_rapids_tpu_torch import col as pcol  # noqa: E402
from spark_rapids_tpu_torch import functions as PF  # noqa: E402
from spark_rapids_tpu_torch.exec.aggregate import (  # noqa: E402
    TpuHashAggregateExec)
from spark_rapids_tpu_torch.types import Schema, StructField  # noqa: E402
from spark_rapids_tpu_torch.types import (  # noqa: E402
    DateType, DoubleType, LongType, StringType)


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

SF = 0.01
CONF = {"spark.rapids.sql.variableFloatAgg.enabled": "true"}
# 300 is TPC-H's; at SF0.01 no order passes it, so a lower threshold
# keeps the comparison non-empty
Q18_MIN_QTY = (300, 250)
# q20's part-name prefix: TPC-H's "forest", and "" (every part), where
# its join of partsupp to the year's (part, supplier) pairs keeps about
# 365 pairs at any scale (tpch.q20) and so some CANADA supplier
Q20_PREFIX = ("forest", "")
# the joins' second plan: no broadcast, and no partitioned join (the
# port has no exchange), so the plain hash join and the swap route run
HASH_JOINS = {"spark.sql.autoBroadcastJoinThreshold": "-1",
              "spark.rapids.sql.tpu.join.partitioned.enabled": "false"}
_PORT_TYPE = {t.name: t for t in (DateType, DoubleType, LongType,
                                  StringType)}


@pytest.fixture(scope="module")
def lineitem():
    """The lineitem columns the port's queries read, as numpy arrays."""
    li = generate(SF)["lineitem"]
    out = {}
    for f in tpch.LINEITEM:
        v = li[f.name]
        out[f.name] = (np.array(v, dtype=str) if f.dtype.is_string
                       else np.array(v, dtype=f.dtype.np_dtype))
    return out


def _jax_q18_inner(t, min_qty):
    return (t["lineitem"].group_by(jcol("l_orderkey"))
            .agg(JF.sum(jcol("l_quantity")).alias("sum_qty"))
            .filter(jcol("sum_qty") > min_qty)
            .order_by("l_orderkey"))


def _jax_rows(name, min_qty=300):
    s = JaxSession(dict(CONF))
    t = load_tables(s, sf=SF)
    df = (QUERIES[1](t) if name == "q1" else QUERIES[6](t) if name == "q6"
          else _jax_q18_inner(t, min_qty))
    return df.collect(), df


def _port_rows(lineitem, name, min_qty=300):
    s = TpuSession(dict(CONF), device="cpu")
    li = s.from_numpy(lineitem, tpch.LINEITEM)
    df = (tpch.q18_inner(li, min_qty) if name == "q18_inner"
          else tpch.QUERIES[name](li))
    return df.collect(), s


def _port_update_paths(node):
    if isinstance(node, TpuHashAggregateExec):
        return node.update_paths
    return next(p for p in map(_port_update_paths, node.children)
                if p is not None) if node.children else None


def _jax_bucket_dirty(df) -> bool:
    """Whether the JAX aggregate's bucket probe came back dirty (its key
    latched in aggregate._BUCKET_DIRTY_KEYS, aggregate.py:1161/1320)."""
    node = df.physical_plan()
    while not isinstance(node, JA.TpuHashAggregateExec):
        node = node.children[0]
    kk = node.kernel_key()
    return any(k[-len(kk):] == kk for k in JA._BUCKET_DIRTY_KEYS)


@pytest.mark.parametrize("name", ["q1", "q6"])
def test_query_rows_equal(lineitem, name):
    want, _ = _jax_rows(name)
    got, _ = _port_rows(lineitem, name)
    assert len(got) == (6 if name == "q1" else 1)
    assert_rows_equal(want, got, ignore_order=False)


@pytest.mark.parametrize("min_qty", Q18_MIN_QTY)
def test_q18_inner_rows_equal_and_both_take_the_sort_path(lineitem,
                                                          min_qty):
    want, jdf = _jax_rows("q18_inner", min_qty)
    got, s = _port_rows(lineitem, "q18_inner", min_qty)
    assert_rows_equal(want, got, ignore_order=False)
    if min_qty < 300:
        assert len(got) > 0
    # the JAX update took the sort path: its bucket probe latched dirty
    assert _jax_bucket_dirty(jdf)
    assert _port_update_paths(s.last_plan) == {"bucket": 0, "sort": 1}


def test_q1_both_take_the_bucket_path(lineitem):
    _, jdf = _jax_rows("q1")
    _, s = _port_rows(lineitem, "q1")
    assert not _jax_bucket_dirty(jdf)
    assert _port_update_paths(s.last_plan) == {"bucket": 1, "sort": 0}


def test_session_runs_on_the_card_unless_asked_for_the_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the no-card case")
    with pytest.raises(RuntimeError, match="cuda"):
        TpuSession()
    assert TpuSession(device="cpu").device.type == "cpu"


def test_select_and_with_column_match():
    rng = np.random.RandomState(7)
    data = {"k": rng.randint(0, 5, 300).astype(np.int64),
            "v": rng.randn(300), "s": np.array(["x", "yy", ""])[
                rng.randint(0, 3, 300)]}

    def q(df, c):
        return (df.with_column("v", c("v") * 2.0 - c("k"))
                .with_column("w", c("k") + 1)
                .filter((c("v") > 0.5) | (c("s") == "yy"))
                .select("w", "s", "v"))
    want = q(JaxSession().from_pydict({k: list(v) for k, v in
                                      data.items()}), jcol).collect()
    got = q(TpuSession(device="cpu").from_numpy(data), pcol).collect()
    assert len(got) > 50
    assert_rows_equal(want, got, ignore_order=False)


def test_outside_the_slice_raises_at_planning_time(lineitem):
    s = TpuSession(device="cpu")
    li = s.from_numpy({k: v[:100] for k, v in lineitem.items()},
                      tpch.LINEITEM)
    # a float sum without the conf: the JAX package runs it on its CPU
    # executor, which the port does not have
    with pytest.raises(NotImplementedError, match="variableFloatAgg"):
        li.agg(PF.sum(pcol("l_quantity"))).physical_plan()
    # a string column compared with a date: the flag is cast to a date,
    # which no flag parses as, so every comparison is null and no row
    # passes, in both packages
    from spark_rapids_tpu import types as JT
    want = JaxSession().from_pydict(
        {k: lineitem[k][:100].tolist() for k in ("l_returnflag",
                                                  "l_shipdate")},
        JT.Schema([JT.StructField("l_returnflag", JT.StringType),
                   JT.StructField("l_shipdate", JT.DateType)])) \
        .filter(jcol("l_returnflag") < jcol("l_shipdate")).collect()
    got = li.filter(pcol("l_returnflag") < pcol("l_shipdate")).collect()
    assert got == want == []
    # min over strings runs in the port; the JAX package gives the same
    # row from its CPU executor
    want = JaxSession().from_pydict(
        {"l_returnflag": lineitem["l_returnflag"][:100].tolist()},
        JT.Schema([JT.StructField("l_returnflag", JT.StringType)])) \
        .agg(JF.min(jcol("l_returnflag"))).collect()
    got = li.agg(PF.min(pcol("l_returnflag"))).collect()
    assert got == want and len(got) == 1
    # Percentile: the JAX package's CPU executor runs it, the port has none
    with pytest.raises(NotImplementedError, match="percentile"):
        li.agg(PF.percentile(pcol("l_quantity"), 0.5)).physical_plan()


def test_port_queries_match_numpy_oracle_over_several_batches():
    """The port's own generator and oracles (what chip_smoke.py runs at
    SF10), with small reader batches so the per-batch bucket/sort updates
    and the fan-in merge both run."""
    t = tpch.generate_lineitem(0.004)
    s = TpuSession(dict(CONF, **{
        "spark.rapids.sql.reader.batchSizeRows": "3000",
        "spark.rapids.sql.tpu.agg.mergeFanIn": "3"}), device="cpu")
    li = s.from_numpy(t, tpch.LINEITEM)
    for name, q in tpch.QUERIES.items():
        got = (q(li, 200) if name == "q18_inner" else q(li)).collect()
        want = (tpch.oracle_q18_inner(t, 200) if name == "q18_inner"
                else tpch.ORACLES[name](t))
        assert len(got) > 0, name
        assert tpch.rows_match(want, got), name


# --------------------------------------------------------------------------
# q3, q4 and q18 whole
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def join_tables():
    """customer, orders, lineitem, part, supplier, nation, region and
    partsupp at SF0.01 with every column the JAX package loads (the planner's size
    estimates read whole tables), and the port's schemas for them."""
    data = generate(SF)
    out = {}
    for name in ("customer", "orders", "lineitem", "part", "supplier",
                 "nation", "region", "partsupp"):
        schema = Schema([StructField(f.name, _PORT_TYPE[f.dtype.name])
                         for f in JAX_SCHEMAS[name]])
        out[name] = (data[name], schema)
    return out


def _jax_q18(t, min_qty):
    """benchmarks/tpch/queries.py q18 with its quantity threshold as an
    argument."""
    big = (t["lineitem"].group_by(jcol("l_orderkey"))
           .agg(JF.sum(jcol("l_quantity")).alias("sum_qty"))
           .filter(jcol("sum_qty") > min_qty)
           .select(jcol("l_orderkey").alias("big_key"), jcol("sum_qty")))
    return (t["orders"]
            .join(big, on=jcol("o_orderkey") == jcol("big_key"))
            .join(t["customer"], on=jcol("o_custkey") == jcol("c_custkey"))
            .select(jcol("c_name"), jcol("c_custkey"), jcol("o_orderkey"),
                    jcol("o_orderdate"), jcol("o_totalprice"),
                    jcol("sum_qty"))
            .order_by(JSortOrder(jcol("o_totalprice"), ascending=False),
                      "o_orderdate")
            .limit(100))


def _jax_q20(t, prefix):
    """benchmarks/tpch/queries.py q20 with its part-name prefix as an
    argument."""
    forest_parts = t["part"].filter(jcol("p_name").startswith(prefix)) \
        .select(jcol("p_partkey").alias("fp_key"))
    li94 = t["lineitem"].filter((jcol("l_shipdate") >= "1994-01-01")
                                & (jcol("l_shipdate") < "1995-01-01"))
    half_qty = (li94.group_by(jcol("l_partkey"), jcol("l_suppkey"))
                .agg((JF.sum(jcol("l_quantity")) * 0.5).alias("half_qty")))
    ps = (t["partsupp"]
          .join(forest_parts, on=jcol("ps_partkey") == jcol("fp_key"),
                how="left_semi")
          .join(half_qty, on=(jcol("ps_partkey") == jcol("l_partkey"))
                & (jcol("ps_suppkey") == jcol("l_suppkey")))
          .filter(jcol("ps_availqty") > jcol("half_qty")))
    canada = t["nation"].filter(jcol("n_name") == "CANADA")
    return (t["supplier"]
            .join(ps, on=jcol("s_suppkey") == jcol("ps_suppkey"),
                  how="left_semi")
            .join(canada, on=jcol("s_nationkey") == jcol("n_nationkey"))
            .select(jcol("s_name"), jcol("s_address"))
            .order_by("s_name"))


# (query, its argument: q18's quantity threshold, q20's part-name
# prefix), and the case's id
_JOIN_CASES = [("q3", None), ("q4", None), ("q12", None), ("q14", None),
               ("q17", None)] + [("q18", q) for q in Q18_MIN_QTY] + [
    ("q5", None), ("q10", None), ("q15", None), ("q19", None),
    ("q21", None), ("q2", None), ("q7", None), ("q8", None), ("q9", None),
    ("q11", None), ("q16", None)] + [("q20", p) for p in Q20_PREFIX]
_JOIN_IDS = [f"{n}-{a or 'any_part'}" if n == "q20" else
             f"{n}-{a}" if a else n for n, a in _JOIN_CASES]
# rows of each case at SF0.01; q20's default keeps no supplier there
_JOIN_ROWS = {"q3": 10, "q4": 5, "q12": 2, "q14": 1, "q17": 1, "q5": 5,
              "q10": 20, "q15": 1, "q19": 1, "q21": 2, "q2": 5, "q7": 4,
              "q8": 2, "q9": 89, "q11": 226, "q16": 295, "q20-forest": 0,
              "q20-any_part": 2}


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
@pytest.mark.parametrize("name,arg", _JOIN_CASES, ids=_JOIN_IDS)
def test_join_queries_rows_and_plans_equal(join_tables, name, arg, plan):
    conf = dict(CONF, **(HASH_JOINS if plan == "hash_joins" else {}))
    js = JaxSession(dict(conf))
    jt = load_tables(js, sf=SF)
    jdf = (_jax_q18(jt, arg) if name == "q18" else _jax_q20(jt, arg)
           if name == "q20" else QUERIES[int(name[1:])](jt))
    ps = TpuSession(dict(conf), device="cpu")
    pt = {n: ps.from_numpy(d, sch) for n, (d, sch) in join_tables.items()}
    pdf = tpch.JOIN_QUERIES[name](pt, arg) if arg is not None \
        else tpch.JOIN_QUERIES[name](pt)
    want, got = jax_table_rows(jdf), pdf.collect()
    assert_rows_equal(want, got, ignore_order=False)
    case = _JOIN_IDS[_JOIN_CASES.index((name, arg))]
    assert len(got) == _JOIN_ROWS.get(case, _JOIN_ROWS.get(name, len(got)))
    assert got or case == "q20-forest"
    if name in ("q14", "q17", "q19"):
        # one value, over a join that is not empty
        assert got[0][0] is not None and got[0][0] > 0
    jn, pn = join_nodes(jdf.physical_plan()), join_nodes(pdf.physical_plan())
    # q17 runs its lineitem-part join twice, as in the JAX plan; q5 joins
    # six tables, the last on two keys; q21 runs its semi join of the
    # lines three times; q2 plans its four joins of part and partsupp
    # twice (once under the per-part minimum) and joins them back; q9's
    # partsupp join is on two keys
    assert len(pn) == {"q4": 1, "q12": 1, "q14": 1, "q17": 3, "q5": 5,
                       "q10": 3, "q15": 1, "q19": 1, "q21": 7, "q2": 9,
                       "q7": 5, "q8": 7, "q9": 5, "q20": 4}.get(name, 2) \
        and jn == pn, (jn, pn)
    if name == "q5":
        # the customer join, on two keys, hashed together
        jk, pk = (_first_join_keys(p) for p in (jdf.physical_plan(),
                                                pdf.physical_plan()))
        assert jk == pk == (["o_custkey", "s_nationkey"],
                            ["c_custkey", "c_nationkey"]), (jk, pk)
    want_class = ("TpuHashJoinExec" if plan == "hash_joins"
                  else "TpuBroadcastHashJoinExec")
    assert {n[0] for n in pn} == {want_class}


def _first_join_keys(node):
    """The (left, right) key column names of a plan's first join exec,
    depth first."""
    if hasattr(node, "left_keys"):
        return tuple([str(k).split(" ")[1].split(":")[0] for k in keys]
                     for keys in (node.left_keys, node.right_keys))
    return next(k for k in map(_first_join_keys, node.children) if k)


def test_to_pydict_raises_on_a_repeated_column_name():
    s = TpuSession(dict(CONF), device="cpu")
    df = s.from_numpy({"k": np.array([1, 1, 2]), "v": np.array([1., 2, 3]),
                       "w": np.array([10., 20, 30])})
    agg = df.group_by("k").agg(PF.sum(pcol("v")), PF.sum(pcol("w")))
    assert sorted(agg.collect()) == [(1, 3.0, 30.0), (2, 3.0, 30.0)]
    with pytest.raises(ValueError, match="'sum' is repeated"):
        agg.to_pydict()
    out = df.group_by("k").agg(PF.sum(pcol("v")).alias("sv"),
                               PF.sum(pcol("w")).alias("sw")).to_pydict()
    assert sorted(out) == ["k", "sv", "sw"]


# at SF0.01 no line of the port's tables passes q19's filter (~2 are
# expected), and no supplier is in CANADA, so their oracle cases run
# where some do (q20 keeps 1 supplier there, and 7 with prefix "")
_ORACLE_SF = {"q19": 0.03, "q20": 0.03}
# q18 at a threshold some orders pass at SF0.01, and q20 at both
# prefixes; the other queries at their defaults
_ORACLE_ARGS = {"q18": 250, "q20-any_part": ""}


@pytest.mark.parametrize("name", ["q3", "q4", "q12", "q14", "q17", "q18",
                                  "q5", "q10", "q15", "q19", "q21", "q2",
                                  "q7", "q8", "q9", "q11", "q16", "q20",
                                  "q20-any_part"])
def test_join_queries_match_numpy_oracle(name):
    """The port's own generator and oracles (what chip_smoke.py runs at
    SF10), in both join plans, with small reader batches so the probe
    streams several batches."""
    query = name.split("-")[0]
    t = tpch.generate(_ORACLE_SF.get(query, SF))
    args = (_ORACLE_ARGS[name],) if name in _ORACLE_ARGS else ()
    for plan in ({}, HASH_JOINS):
        s = TpuSession(dict(CONF, **plan, **{
            "spark.rapids.sql.reader.batchSizeRows": "20000"}), device="cpu")
        d = {n: s.from_numpy(v, tpch.SCHEMAS[n]) for n, v in t.items()}
        got = tpch.JOIN_QUERIES[query](d, *args).collect()
        want = tpch.ORACLES[query](t, *args)
        assert got and got[0][0] is not None, name
        if query in tpch.TOP_N:
            assert tpch.top_rows_match(want, got, *tpch.TOP_N[query]), name
        else:
            assert tpch.rows_match(want, got), name


# --------------------------------------------------------------------------
# q22 and the string filters over o_comment
# --------------------------------------------------------------------------

def _every_8th_order(orders: dict) -> dict:
    """The orders at index 0, 8, 16, ...: with all of them each customer
    has about 10 orders and q22's anti join keeps no one."""
    return {k: v[::8] for k, v in orders.items()}


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
def test_q22_rows_and_plans_equal(join_tables, plan):
    conf = dict(CONF, **(HASH_JOINS if plan == "hash_joins" else {}))
    tables = {"customer": join_tables["customer"],
              "orders": (_every_8th_order(join_tables["orders"][0]),
                         join_tables["orders"][1])}
    js = JaxSession(dict(conf))
    jdf = QUERIES[22]({n: js.from_pydict(d, JAX_SCHEMAS[n])
                       for n, (d, _) in tables.items()})
    ps = TpuSession(dict(conf), device="cpu")
    pdf = tpch.q22({n: ps.from_numpy(d, sch)
                    for n, (d, sch) in tables.items()})
    want, got = jax_table_rows(jdf), pdf.collect()
    assert len(got) == 7
    assert_rows_equal(want, got, ignore_order=False)
    jn, pn = join_nodes(jdf.physical_plan()), join_nodes(pdf.physical_plan())
    assert jn == pn and len(pn) == 1, (jn, pn)
    assert pn[0][:2] == ("TpuHashJoinExec" if plan == "hash_joins"
                         else "TpuBroadcastHashJoinExec", "left_anti")


@pytest.fixture(scope="module")
def port_tables_cut():
    """The port's own tables at SF0.01 with every 8th order."""
    t = tpch.generate(SF)
    return dict(t, orders=_every_8th_order(t["orders"]))


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
def test_q22_matches_numpy_oracle(port_tables_cut, plan):
    t = port_tables_cut
    s = TpuSession(dict(CONF, **(HASH_JOINS if plan == "hash_joins"
                                 else {})), device="cpu")
    d = {n: s.from_numpy(v, tpch.SCHEMAS[n]) for n, v in t.items()}
    got, want = tpch.q22(d).collect(), tpch.oracle_q22(t)
    assert len(got) == 7
    assert tpch.rows_match(want, got)


# --------------------------------------------------------------------------
# q13 and the outer joins of orders and customers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["default", "hash_joins"])
def test_q13_rows_and_plans_equal(join_tables, plan):
    """q13 on every 8th order, where 422 customers have no order at all:
    the left outer join's rows without a match reach the count."""
    conf = dict(CONF, **(HASH_JOINS if plan == "hash_joins" else {}))
    tables = {"customer": join_tables["customer"],
              "orders": (_every_8th_order(join_tables["orders"][0]),
                         join_tables["orders"][1])}
    js = JaxSession(dict(conf))
    jdf = QUERIES[13]({n: js.from_pydict(d, JAX_SCHEMAS[n])
                       for n, (d, _) in tables.items()})
    ps = TpuSession(dict(conf), device="cpu")
    pdf = tpch.q13({n: ps.from_numpy(d, sch)
                    for n, (d, sch) in tables.items()})
    want, got = jax_table_rows(jdf), pdf.collect()
    assert len(got) == 8 and 0 in [r[0] for r in got]
    assert_rows_equal(want, got, ignore_order=False)
    jn, pn = join_nodes(jdf.physical_plan()), join_nodes(pdf.physical_plan())
    assert jn == pn and len(pn) == 1, (jn, pn)
    assert pn[0][:2] == ("TpuHashJoinExec" if plan == "hash_joins"
                         else "TpuBroadcastHashJoinExec", "left")
    # the aggregate by c_custkey (1,500 customers, above the 1024
    # buckets) takes the sort path in both packages
    (jagg, pagg) = (_aggregates(p, cls)[1] for p, cls in (
        (jdf.physical_plan(), JA.TpuHashAggregateExec),
        (ps.last_plan, TpuHashAggregateExec)))
    kk = jagg.kernel_key()
    assert any(k[-len(kk):] == kk for k in JA._BUCKET_DIRTY_KEYS)
    assert pagg.update_paths == {"bucket": 0, "sort": 1}


def _aggregates(node, cls):
    """The aggregate execs of a plan, depth first."""
    return ([node] if isinstance(node, cls) else []) + [
        a for c in node.children for a in _aggregates(c, cls)]


def _jax_outer_1992(t, how):
    """tpch.OUTER_JOINS' query in the JAX package's DataFrame API."""
    orders = t["orders"].filter(jcol("o_orderdate") < "1993-01-01")
    cust = t["customer"].filter(jcol("c_mktsegment") == "BUILDING")
    return (orders.join(cust, on=jcol("o_custkey") == jcol("c_custkey"),
                        how=how)
            .agg(JF.count(jlit(1)).alias("rows"),
                 JF.count(jcol("o_orderkey")).alias("with_order"),
                 JF.count(jcol("c_custkey")).alias("with_customer")))


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
@pytest.mark.parametrize("name", list(tpch.OUTER_JOINS))
def test_outer_joins_rows_and_plans_equal(join_tables, name, plan):
    conf = dict(CONF, **(HASH_JOINS if plan == "hash_joins" else {}))
    js = JaxSession(dict(conf))
    jdf = _jax_outer_1992(load_tables(js, sf=SF), name.split("_")[0])
    ps = TpuSession(dict(conf), device="cpu")
    pdf = tpch.OUTER_JOINS[name][0](
        {n: ps.from_numpy(d, sch) for n, (d, sch) in join_tables.items()})
    want, got = jax_table_rows(jdf), pdf.collect()
    assert_rows_equal(want, got, ignore_order=False)
    rows, with_order, with_customer = got[0]
    # rows without a match on each preserved side
    assert rows > with_order and (name == "right_outer_1992"
                                  or rows > with_customer)
    jn = plan_joins(jdf.physical_plan())
    pn = plan_joins(pdf.physical_plan())
    assert jn == pn and len(pn) == 1, (jn, pn)
    if name == "right_outer_1992":  # builds the orders side, swapped
        assert pn[0][1:2] == ("left",) and pn[0][3] \
            and "o_orderkey" in pn[0][2]
    else:  # builds the customers, never broadcast
        assert pn[0][:2] == ("TpuHashJoinExec", "full") \
            and "c_custkey" in pn[0][2]


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
@pytest.mark.parametrize("name", ["q13"] + list(tpch.OUTER_JOINS))
def test_q13_and_outer_joins_match_numpy_oracle(port_tables_cut, name,
                                                plan):
    """The port's own generator and oracles (what chip_smoke.py runs at
    SF10), with small reader batches so the probe streams several
    batches and a full join's tail follows them."""
    t = port_tables_cut
    s = TpuSession(dict(CONF, **(HASH_JOINS if plan == "hash_joins"
                                 else {}), **{
        "spark.rapids.sql.reader.batchSizeRows": "500"}), device="cpu")
    d = {n: s.from_numpy(v, tpch.SCHEMAS[n]) for n, v in t.items()}
    if name == "q13":
        got, want = tpch.q13(d).collect(), tpch.oracle_q13(t)
        assert 0 in [r[0] for r in want]  # customers without an order
    else:
        query, oracle = tpch.OUTER_JOINS[name]
        got, want = query(d).collect(), oracle(t)
        # rows without a match on each preserved side
        rows, with_order, with_customer = want[0]
        assert rows > with_order and (name == "right_outer_1992"
                                      or rows > with_customer)
    assert tpch.rows_match(want, got), (got, want)


@pytest.mark.parametrize("name", list(tpch.STRING_FILTERS))
def test_string_filters_match_numpy_oracle(port_tables_cut, name):
    orders = port_tables_cut["orders"]
    s = TpuSession(dict(CONF), device="cpu")
    got = tpch.string_filter(s.from_numpy(orders, tpch.ORDERS),
                             name).collect()
    want = tpch.oracle_string_filter(orders, name)
    assert 0 < want[0][0] < len(orders["o_comment"])
    assert got == want


# sha256 (first 16 hex digits) of each column of generate(0.01): those
# from before c_phone, c_acctbal and o_comment were added, then those
# three, then part and l_partkey, then supplier, nation, region and the
# columns that join to them, then partsupp and the part and supplier
# columns q2, q9, q11, q16 and q20 read; a column added later keeps them
# all
_EARLIER_COLUMNS = {
    "p_name": "a8a004f35d5bf419", "p_mfgr": "4382414b65be9319",
    "s_acctbal": "b70bfd3057dd5169", "s_comment": "d64a7ca8fc6e27a3",
    "ps_partkey": "a9893dba16d19b9d", "ps_suppkey": "efdba292bc547fce",
    "ps_availqty": "e186bd2b050e2087", "ps_supplycost": "43d390080532992e",
    "s_suppkey": "95257ce5f6807435", "s_name": "6cf7b1329a2fa99f",
    "s_address": "fa99062e2728561d", "s_nationkey": "f35d779646b42621",
    "s_phone": "af2047b1c1a3ca4d", "c_nationkey": "cc829761f005a7c9",
    "c_address": "aaa9a9d0775885bf", "c_comment": "772140dfe2f4d6b3",
    "o_orderstatus": "2900268e7229bf31", "l_suppkey": "d52d2c2d5079d75e",
    "l_shipinstruct": "fc4ea5a1341942ba", "p_size": "621ed33839fd5a08",
    "n_nationkey": "2a0a16a7ce85c211", "n_name": "8cef1c986a17ec75",
    "n_regionkey": "0e78614ee488cfcf", "r_regionkey": "281b02b10f5f4997",
    "r_name": "0b22e391ea931f3c",
    "c_phone": "f41fac7dcdfcadc3", "c_acctbal": "32e87471866682e9",
    "o_comment": "dfdfaa7077f24712", "l_partkey": "e46b82f6314e259f",
    "p_partkey": "b1b7700a56a7031e", "p_brand": "bcbeddf53d730555",
    "p_type": "bee9c4fd2d6e2c5b", "p_container": "ba0e1987fbc01738",
    "c_custkey": "fb7b257e03ce330e", "c_mktsegment": "da70ad55e314ae97",
    "c_name": "b97659d77d102fa2", "l_commitdate": "57a4a90896e9386b",
    "l_discount": "0766a3f235119353", "l_extendedprice": "c91fe2c0c61b5789",
    "l_linestatus": "93c379e94fa9ba2e", "l_orderkey": "b4d41cced689ceaa",
    "l_quantity": "2d694d2be6aea700", "l_receiptdate": "5382fd40594d01d9",
    "l_returnflag": "96582ad97aa8f5e8", "l_shipdate": "a6a6fe6cbe18ca44",
    "l_shipmode": "6187a9481315ef08", "l_tax": "1a824509e0937e5c",
    "o_custkey": "886f85f5b34c3d04", "o_orderdate": "4c89d0b12c4f7f95",
    "o_orderkey": "211762750ba2a2cc", "o_orderpriority": "dc0510ee2816cb45",
    "o_shippriority": "9a413b131ecf0ccf", "o_totalprice": "5a0631dca16c474f"}


def test_new_columns_leave_the_earlier_columns_values_unchanged():
    import hashlib
    t = tpch.generate(SF)
    got = {c: hashlib.sha256(np.ascontiguousarray(v).tobytes())
           .hexdigest()[:16]
           for table in t.values() for c, v in table.items()
           if c in _EARLIER_COLUMNS}
    assert got == _EARLIER_COLUMNS


def test_nation_keys_agree_with_phone_prefixes():
    """A customer's and a supplier's phone begin with its nation key + 10
    (benchmarks/tpch/datagen.py), so q5's c_nationkey = s_nationkey and
    q22's country codes describe the same customers."""
    t = tpch.generate(SF)
    for table, p in (("customer", "c_"), ("supplier", "s_")):
        phone, key = t[table][p + "phone"], t[table][p + "nationkey"]
        prefix = phone.astype("S2").astype(np.int64)
        assert len(key) == len(phone) and np.array_equal(key + 10, prefix)
        assert set(key) <= set(range(tpch.N_NATIONS)), table
    # 1,500 customers hold every nation
    assert set(t["customer"]["c_nationkey"]) == set(range(tpch.N_NATIONS))
