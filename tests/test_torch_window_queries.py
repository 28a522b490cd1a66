"""`tpch.WINDOW_QUERIES` at SF0.01 on the CPU: each through the JAX
package (the same query function built from its DSL: `dsl=`) and the
port, rows equal in order under test_torch_window's rule with no
segment floor (floats within rel 1e-9, absolute 1e-9: every float is a
sum of positive prices or a ratio of two, so no difference of running
sums cancels); and through the port over batches of 20,000 rows against
the numpy oracles (`tpch.match_window_query`)."""
import pytest

from test_torch_agg_functions import CONF, _jax_frames, _port_frames
from test_torch_window import _one_torch_thread, rows_agree  # noqa: F401
from spark_rapids_tpu_torch import tpch

# rows at SF0.01
ROWS = {"revenue_ratio": 100, "margin_rank": 131, "monthly_deviation": 100,
        "running_spend": 100, "order_neighbors": 15, "top_lines": 3,
        "spend_rank": 100}


@pytest.fixture(scope="module")
def sf001():
    """The port's tables at SF0.01."""
    return tpch.generate(0.01)


@pytest.mark.parametrize("name", list(tpch.WINDOW_QUERIES))
def test_window_query_rows_equal_the_jax_package(sf001, name):
    from spark_rapids_tpu.plan import logical as JL
    q = tpch.WINDOW_QUERIES[name]
    want = q(_jax_frames(sf001), JL).collect()
    got = q(_port_frames(sf001)).collect()
    assert len(got) == ROWS[name]
    rows_agree(want, got)


@pytest.mark.parametrize("name", list(tpch.WINDOW_QUERIES))
def test_window_query_matches_the_numpy_oracle(sf001, name):
    """Over batches of 20,000 rows (lineitem and orders take several), so
    the window's coalesce concatenates them."""
    pt = _port_frames(sf001, dict(CONF, **{
        "spark.rapids.sql.reader.batchSizeRows": "20000"}))
    got = tpch.WINDOW_QUERIES[name](pt).collect()
    assert len(got) == ROWS[name]
    assert tpch.match_window_query(name, tpch.ORACLES[name](sf001), got)


def test_the_oracles_keep_every_row_a_top_n_query_may_reach():
    """monthly_deviation's oracle gives every row its filter keeps,
    more than the 100 the query keeps; running_spend's the first 100 and
    only rows within 1e-8 of the 100th after them."""
    t = tpch.generate(0.01)
    assert len(tpch.ORACLES["monthly_deviation"](t)) > 100
    rows = tpch.ORACLES["running_spend"](t)
    assert len(rows) >= 100
    assert all(abs(r[3] - rows[99][3]) <= 1e-8 * rows[99][3]
               for r in rows[100:])
