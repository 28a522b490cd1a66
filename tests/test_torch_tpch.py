"""TPC-H q1, q6 and q18's inner lineitem aggregate through the JAX
package's TpuSession and the port's, on the same SF0.01 lineitem
(benchmarks/tpch/datagen.py), compared row for row under the rule of
tests/compare.py.  Both sessions allow float aggregation on the device,
so the JAX side runs its device aggregate rather than its CPU executor.

At SF0.01 q18's aggregate has ~15,000 order keys, far above the 1024
buckets: each package's bucket check comes back dirty and the update
takes the sort path; q1's six groups take the bucket path in both."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks.tpch import QUERIES, generate, load_tables  # noqa: E402
from compare import assert_rows_equal  # noqa: E402
from spark_rapids_tpu.engine import TpuSession as JaxSession  # noqa: E402
from spark_rapids_tpu.exec import aggregate as JA  # noqa: E402
from spark_rapids_tpu.plan.logical import col as jcol  # noqa: E402
from spark_rapids_tpu.plan.logical import functions as JF  # noqa: E402
from spark_rapids_tpu_torch import TpuSession, tpch  # noqa: E402
from spark_rapids_tpu_torch import col as pcol  # noqa: E402
from spark_rapids_tpu_torch import functions as PF  # noqa: E402
from spark_rapids_tpu_torch.exec.aggregate import (  # noqa: E402
    TpuHashAggregateExec)

SF = 0.01
CONF = {"spark.rapids.sql.variableFloatAgg.enabled": "true"}
# 300 is TPC-H's; at SF0.01 no order passes it, so a lower threshold
# keeps the comparison non-empty
Q18_MIN_QTY = (300, 250)


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
    # a string column cast to a date (only literals fold)
    with pytest.raises(NotImplementedError, match="cast"):
        li.filter(pcol("l_returnflag") < pcol("l_shipdate")) \
            .physical_plan()
    with pytest.raises(NotImplementedError, match="strings"):
        li.agg(PF.min(pcol("l_returnflag"))).physical_plan()


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
