"""Window functions through the port's TpuSession and the JAX package's,
on the CPU, from the same seeded input: the JAX side loads it with
`from_pydict`, the port with `from_numpy`.

Rows are compared in order: integers, strings, dates, booleans and
ranks exactly; floats where both are NaN or equal, or within rel 1e-9
with an absolute floor of 1e-9 (tests/compare.py's approx_float) plus
1e-12 times the sum of |v| over the finite values of the row's
partition.  The floor is the one float sums need: the JAX package sums
a segment with a tree-shaped associative scan, the port with K1's
single pass (its plain version a log-step sweep), and a frame's sum is
a difference of two running sums, so a bounded frame inherits the
rounding of its whole segment.  A non-finite value must not leak into a
frame that does not hold it: that part is exact.

Covered: the JAX package's own cases (tests/test_window.py; its
kill-switch case waits for per-op conf keys), every frame kind over a
table with nulls, NaN, +-0.0, +-inf and empty strings in every value
type, in one batch and at `batchSizeRows` 64 behind a filter, the input
past `batchSizeBytes` (the JAX package hash-exchanges it, the port
concatenates: the same rows in another order), the plans (one window
exec per spec group, the coalesce's "target" goal, pruning through the
window, the row estimate), and the windows the port refuses at planning
time or both packages refuse.

The JAX package is imported inside the functions that use it, so that
tests/test_torch_cuda.py can import this file's tables and cases on a
machine without it.
"""
import math
import os

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import TpuSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.plan.analysis import AnalysisError

BATCHED = {"spark.rapids.sql.reader.batchSizeRows": "64"}
REL = 1e-9        # tests/compare.py's approx_float
SEGMENT = 1e-12   # times the partition's sum of |v|


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


def _jax():
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.engine import TpuSession as JaxSession
    from spark_rapids_tpu.plan import logical as JL
    return JT, JaxSession, JL


def _frames(data: dict, types: dict = None, conf: dict = None):
    """(JAX DataFrame, port DataFrame) of one table; `types` names each
    column's type (inferred from the values when None)."""
    JT, JaxSession, _ = _jax()
    js, ps = JaxSession(dict(conf or {})), TpuSession(dict(conf or {}),
                                                      device="cpu")
    if types is None:
        return js.from_pydict(data), ps.from_numpy(data)
    return (js.from_pydict(data, JT.Schema(
        [JT.StructField(c, getattr(JT, t)) for c, t in types.items()])),
        ps.from_numpy(data, PT.Schema(
            [PT.StructField(c, getattr(PT, t)) for c, t in types.items()])))


def _finite_abs_sums(data: dict, key, value: str) -> dict:
    """Sum of |v| over the finite values of `value`, per value of the
    column `key` (None: over the whole table)."""
    keys = data[key] if key else [None] * len(data[value])
    out: dict = {}
    for k, v in zip(keys, data[value]):
        if v is not None and math.isfinite(v):
            out[k] = out.get(k, 0.0) + abs(v)
    return out


def tolerance(data: dict, value: str, key: str = None, pos: int = 0):
    """A row's absolute float floor beyond REL's: SEGMENT times the
    finite |`value`| summed over the partition whose `key` is the row's
    column `pos` (over the whole table without a key)."""
    sums = _finite_abs_sums(data, key, value)
    return lambda row: SEGMENT * sums.get(row[pos] if key else None, 0.0)


def rows_agree(want: list, got: list, tol=lambda row: 0.0) -> None:
    """Assert the rows equal in order under the rule of this module."""
    assert len(want) == len(got), (len(want), len(got), want[:3], got[:3])
    for i, (w, g) in enumerate(zip(want, got)):
        assert len(w) == len(g), (w, g)
        floor = REL + tol(w)
        for a, b in zip(w, g):
            if isinstance(a, float) and isinstance(b, float):
                ok = (math.isnan(a) and math.isnan(b)) or a == b or (
                    math.isclose(a, b, rel_tol=REL, abs_tol=floor))
            else:
                ok = a == b and type(a) is type(b)
            assert ok, f"row {i}: {w} against {g}"


def both(query, data, types=None, conf=None, tol=lambda row: 0.0):
    """`query(df, dsl)` in both packages; the port's rows, asserted
    equal to the JAX package's."""
    _, _, JL = _jax()
    jdf, pdf = _frames(data, types, conf)
    want = query(jdf, JL).collect()
    got = query(pdf, PL).collect()
    rows_agree(want, got, tol)
    return got


# --------------------------------------------------------------------------
# the JAX package's own cases (tests/test_window.py)
# --------------------------------------------------------------------------

def base_data(seed=0, n=300, nulls=True):
    """tests/test_window.py's table: k of 8 keys, o of 1000 values, v a
    double of [-100, 100) (every 11th null)."""
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 8, n)
    v = rng.uniform(-100, 100, n).round(3)
    o = rng.randint(0, 1000, n)
    vals = [None if nulls and i % 11 == 0 else float(v[i]) for i in range(n)]
    return {"k": k.tolist(), "o": o.tolist(), "v": vals}


def _ties():
    rng = np.random.RandomState(2)
    return {"k": rng.randint(0, 5, 200).tolist(),
            "o": rng.randint(0, 10, 200).tolist()}


def _words():
    rng = np.random.RandomState(12)
    words = ["apple", "pear", None, "zebra", "kiwi", "fig"]
    return {"k": rng.randint(0, 4, 120).tolist(),
            "s": [words[i % len(words)] for i in range(120)],
            "o": rng.randint(0, 50, 120).tolist()}


def _w(dsl, *, part=("k",), order=("o",), rows=None):
    w = dsl.Window.partitionBy(*[dsl.col(c) for c in part]) if part \
        else dsl.Window.orderBy(*[dsl.col(c) for c in order])
    if part and order:
        w = w.orderBy(*[dsl.col(c) if isinstance(c, str) else c(dsl)
                        for c in order])
    return w.rowsBetween(*rows) if rows else w


def _sel(*cols):
    """A select of the named columns, then the window columns each
    `(name, fn(dsl))` makes."""
    def q(df, dsl):
        return df.select(*[dsl.col(c) if isinstance(c, str)
                           else c[1](dsl).alias(c[0]) for c in cols])
    return q


_F = lambda dsl: dsl.functions  # noqa: E731
_V = lambda dsl: dsl.col("v")  # noqa: E731

# name -> (table, query, tolerance's key column and its position or None)
JAX_CASES = {
    "row_number": (lambda: base_data(1), _sel(
        "k", "o", ("rn", lambda d: _F(d).row_number().over(_w(d)))), None),
    "rank_dense_rank_with_ties": (_ties, _sel(
        "k", "o", ("r", lambda d: _F(d).rank().over(_w(d))),
        ("dr", lambda d: _F(d).dense_rank().over(_w(d)))), None),
    "desc_order_and_nulls": (lambda: base_data(3), _sel(
        "k", "v", ("rn", lambda d: _F(d).row_number().over(
            _w(d, order=(lambda d: d.col("v").desc(),))))), None),
    "sum_default_frame_running": (lambda: base_data(4, nulls=False), _sel(
        "k", "o", ("rsum", lambda d: _F(d).sum(_V(d)).over(_w(d)))),
        ("k", 0)),
    "default_frame_ties_range_semantics": (
        lambda: {"k": [1] * 6, "o": [1, 1, 2, 2, 3, 3],
                 "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]},
        _sel("o", "v", ("rs", lambda d: _F(d).sum(_V(d)).over(_w(d)))),
        (None, 0)),
    "whole_partition_agg_no_order": (lambda: base_data(5), _sel(
        "k", "v", ("total", lambda d: _F(d).sum(_V(d)).over(
            _w(d, order=()))),
        ("cnt", lambda d: _F(d).count(_V(d)).over(_w(d, order=()))),
        ("mean", lambda d: _F(d).avg(_V(d)).over(_w(d, order=())))),
        ("k", 0)),
    "min_max_unbounded_running": (lambda: base_data(6), _sel(
        "k", "o", ("rmin", lambda d: _F(d).min(_V(d)).over(_w(d))),
        ("rmax", lambda d: _F(d).max(_V(d)).over(_w(d)))), None),
    "rows_between_bounded_sum": (lambda: base_data(7, nulls=False), _sel(
        "k", "o",
        ("ms", lambda d: _F(d).sum(_V(d)).over(_w(d, rows=(-2, 2)))),
        ("mc", lambda d: _F(d).count(_V(d)).over(_w(d, rows=(-2, 2)))),
        ("ma", lambda d: _F(d).avg(_V(d)).over(_w(d, rows=(-2, 2))))),
        ("k", 0)),
    "rows_between_bounded_min_max": (lambda: base_data(8), _sel(
        "k", "o",
        ("mn", lambda d: _F(d).min(_V(d)).over(_w(d, rows=(-3, 1)))),
        ("mx", lambda d: _F(d).max(_V(d)).over(_w(d, rows=(-3, 1))))),
        None),
    "rows_unbounded_following": (lambda: base_data(9, nulls=False), _sel(
        "k", "o",
        ("suffix_sum", lambda d: _F(d).sum(_V(d)).over(
            _w(d, rows=(0, d.Window.unboundedFollowing)))),
        ("suffix_min", lambda d: _F(d).min(_V(d)).over(
            _w(d, rows=(d.Window.currentRow, d.Window.unboundedFollowing))))),
        ("k", 0)),
    "lag_lead": (lambda: base_data(10), _sel(
        "k", "o", ("l1", lambda d: _F(d).lag(_V(d), 1).over(_w(d))),
        ("ld2", lambda d: _F(d).lead(_V(d), 2).over(_w(d))),
        ("l1d", lambda d: _F(d).lag(_V(d), 1, -999.0).over(_w(d)))), None),
    "first_last_values": (lambda: base_data(11), _sel(
        "k", "o", ("fv", lambda d: _F(d).first(_V(d)).over(_w(d)))), None),
    "window_over_strings_min_max": (_words, _sel(
        "k", "s",
        ("smin", lambda d: _F(d).min(d.col("s")).over(_w(d, order=()))),
        ("smax", lambda d: _F(d).max(d.col("s")).over(_w(d, order=())))),
        None),
    "multiple_specs_in_one_select": (lambda: base_data(13, nulls=False),
                                     _sel("k", "o", (
        "rn", lambda d: _F(d).row_number().over(_w(d))),
        ("c_by_o", lambda d: _F(d).count(_V(d)).over(
            _w(d, part=("o",), order=())))), None),
    "no_partition_by": (lambda: base_data(14, n=100), _sel(
        "o", ("rn", lambda d: _F(d).row_number().over(_w(d, part=())))),
        None),
    "window_then_filter": (lambda: base_data(17), lambda df, d: _sel(
        "k", "o", ("rn", lambda d: _F(d).row_number().over(_w(d))))(df, d)
        .filter(d.col("rn") <= 3), None),
    "nested_window_expression": (lambda: base_data(18, nulls=False),
                                 lambda df, d: df.select(d.col("k"), (
        _F(d).sum(_V(d)).over(_w(d, order=())) + 1.0).alias("x")),
        ("k", 0)),
    "min_max_with_nan_values": (
        lambda: {"k": [1, 1, 1, 2, 2],
                 "v": [float("nan"), 1.0, 3.0, float("nan"), float("nan")]},
        _sel("k", "v",
             ("mn", lambda d: _F(d).min(_V(d)).over(_w(d, order=()))),
             ("mx", lambda d: _F(d).max(_V(d)).over(_w(d, order=())))),
        None),
    "desc_string_prefix_ordering": (
        lambda: {"s": ["ab", "abc", "b", "a"], "k": [1, 1, 1, 1]},
        _sel("s", ("rn", lambda d: _F(d).row_number().over(
            _w(d, order=(lambda d: d.col("s").desc(),))))), None),
    "lag_with_wide_string_default": (
        lambda: {"k": [1, 1, 1], "o": [1, 2, 3], "s": ["aa", "bb", "cc"]},
        _sel("o", ("lg", lambda d: _F(d).lag(
            d.col("s"), 1, "averylongdefaultstringvalue").over(_w(d)))),
        None),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_the_jax_package_s_window_cases(case):
    table, query, key = JAX_CASES[case]
    data = table()
    tol = tolerance(data, "v", *key) if key else (lambda row: 0.0)
    assert both(query, data, tol=tol)


def test_unnamed_window_expressions_take_the_jax_package_s_names():
    """A bare window expression is `_w<n>`, one inside arithmetic keeps
    its own name; the types are the JAX package's."""
    _, _, JL = _jax()
    jdf, pdf = _frames(base_data(18))
    schemas = []
    for df, dsl in ((jdf, JL), (pdf, PL)):
        F, col = dsl.functions, dsl.col
        w = dsl.Window.partitionBy(col("k")).orderBy(col("o"))
        schemas.append([(f.name, f.dtype.name) for f in df.select(
            col("k"), F.sum(col("v")).over(w), F.count(col("v")).over(w) + 1,
            F.rank().over(w), F.avg(col("k")).over(w)).schema])
    assert schemas[0] == schemas[1]
    assert [n for n, _ in schemas[1]][:2] == ["k", "_w0"]


# --------------------------------------------------------------------------
# every frame kind over edge values of every type
# --------------------------------------------------------------------------

EDGE_TYPES = {"k": "IntegerType", "o": "LongType", "g": "IntegerType",
              "i": "IntegerType", "l": "LongType", "x": "DoubleType",
              "f": "FloatType", "d": "DateType", "s": "StringType",
              "b": "BooleanType", "keep": "BooleanType"}
_EDGE_X = [float("nan"), 0.0, -0.0, float("inf"), float("-inf"), 1.5,
           -2.25, 1e10, 3.0, -7.0]
_EDGE_S = ["", "a", "ab", "abcdefghi", "é", "€", "zz", "b" * 17, "中文"]


def edge_table(n: int = 600, seed: int = 23) -> dict:
    """Python columns: k a partition key of 12 values, o a unique order
    key, g an order key of 4 values (ties), i, l, x, f, d, s and b values
    of every type with their edges (int and long extremes, NaN, +-0.0,
    +-inf, empty and multi-byte strings), about 8% of each null (o and
    keep never), keep a filter."""
    rng = np.random.default_rng(seed)
    i_edges = [0, 1, -1, 2**31 - 1, -2**31, 7]
    l_edges = [0, 2**63 - 1, -2**63, 5, -5, 1 << 40]
    cols = {
        "k": rng.integers(0, 12, n).tolist(),
        "o": rng.permutation(n).tolist(),
        "g": rng.integers(0, 4, n).tolist(),
        "i": [i_edges[j] if j < len(i_edges) else int(v) for j, v in
              zip(rng.integers(0, 12, n), rng.integers(-1000, 1000, n))],
        "l": [l_edges[j] if j < len(l_edges) else int(v) for j, v in
              zip(rng.integers(0, 12, n), rng.integers(-10**6, 10**6, n))],
        "x": [_EDGE_X[j] if j < len(_EDGE_X) else float(v) for j, v in
              zip(rng.integers(0, 20, n),
                  np.round(rng.uniform(-100, 100, n), 3))],
        "f": [float(np.float32(_EDGE_X[j] if j < len(_EDGE_X) else v))
              for j, v in zip(rng.integers(0, 20, n),
                              np.round(rng.uniform(-100, 100, n), 2))],
        "d": rng.integers(18000, 18030, n).tolist(),
        "s": [_EDGE_S[j] for j in rng.integers(0, len(_EDGE_S), n)],
        "b": (rng.random(n) < 0.5).tolist(),
        "keep": (rng.random(n) < 0.8).tolist()}
    null = rng.random((len(cols), n)) < 0.08
    return {c: [None if null[j, r] and c not in ("o", "keep") else v
                for r, v in enumerate(vals)]
            for j, (c, vals) in enumerate(cols.items())}


# frame kind -> (order keys, rows bounds or None)
EDGE_FRAMES = {"whole": ((), None), "range": (("g",), None),
               "running": (("o",), (-(1 << 62), 0)),
               "suffix": (("o",), (0, 1 << 62)),
               "bounded": (("o",), (-2, 1)),
               "before": (("o",), (-3, -1))}


def edge_columns(dsl, frame: str) -> list:
    """(name, window expression) of every function the frame kind takes,
    over every type that function takes."""
    F, col = dsl.functions, dsl.col
    order, rows = EDGE_FRAMES[frame]
    w = dsl.Window.partitionBy(col("k"))
    if order:
        w = w.orderBy(*[col(c) for c in order])
    if rows:
        w = w.rowsBetween(*rows)
    out = [("n", F.count(dsl.lit(1)).over(w)),
           ("nx", F.count(col("x")).over(w)),
           ("ns", F.count(col("s")).over(w))]
    out += [(f"sum_{c}", F.sum(col(c)).over(w)) for c in "ilxf"]
    out += [(f"avg_{c}", F.avg(col(c)).over(w)) for c in "ixf"]
    # a string min/max needs its frame to start at the partition's
    minmax = "ilxfdb" + ("s" if rows is None or rows[0] < -(1 << 61)
                         else "")
    out += [(f"{fn}_{c}", getattr(F, fn)(col(c)).over(w))
            for c in minmax for fn in ("min", "max")]
    out += [(f"{fn}_{c}", getattr(F, fn)(col(c)).over(w))
            for c in "xsdb" for fn in ("first", "last")]
    if order:
        out += [("rn", F.row_number().over(w)), ("rk", F.rank().over(w)),
                ("drk", F.dense_rank().over(w)),
                ("lag_i", F.lag(col("i"), 1).over(w)),
                ("lag_x", F.lag(col("x"), 2, -1.5).over(w)),
                ("lead_s", F.lead(col("s"), 1, "past the last row").over(w)),
                ("lead_d", F.lead(col("d"), 3).over(w)),
                ("lag_b", F.lag(col("b"), 1, True).over(w))]
    return out


def edge_query(frame: str):
    def q(df, dsl):
        df = df.filter(dsl.col("keep"))
        return df.select(dsl.col("k"), dsl.col("o"),
                         *[e.alias(n) for n, e in edge_columns(dsl, frame)]) \
            .order_by("k", "o")
    return q


def _edge_tol(data: dict):
    """The float floor of the edge rows: the sums of |x| and of |f| per
    partition key, whichever is larger (every float column reads one of
    them)."""
    x = _finite_abs_sums(data, "k", "x")
    f = _finite_abs_sums(data, "k", "f")
    return lambda row: SEGMENT * max(x.get(row[0], 0.0), f.get(row[0], 0.0))


@pytest.mark.parametrize("frame", list(EDGE_FRAMES))
def test_every_frame_kind_over_edge_values(frame):
    """Every function the frame kind takes over every type, in one batch
    of 600 rows, then over 256 rows read 64 at a time behind a filter
    (the coalesce concatenates them into one batch).  One test runs both,
    so the JAX package compiles the query once."""
    for n, conf in ((600, None), (256, BATCHED)):
        data = edge_table(n)
        assert both(edge_query(frame), data, EDGE_TYPES, conf,
                    _edge_tol(data))


def test_integer_sums_wrap_and_non_finite_values_stay_in_their_frames():
    """Long sums wrap as Spark's do; an inf or NaN inside a partition but
    outside a bounded frame does not reach the frame."""
    data = {"k": [1] * 6, "o": list(range(6)),
            "l": [2**63 - 1, 1, 1, 5, 6, 7],
            "x": [float("inf"), 1.0, 2.0, float("nan"), 4.0, 1e300]}

    def q(df, dsl):
        F, col = dsl.functions, dsl.col
        w = dsl.Window.partitionBy(col("k")).orderBy(col("o"))
        return df.select(col("o"),
                         F.sum(col("l")).over(w).alias("sl"),
                         F.sum(col("x")).over(w.rowsBetween(1, 2))
                         .alias("sx"),
                         F.sum(col("x")).over(w.rowsBetween(-1, 0))
                         .alias("back"))
    got = both(q, data, {"k": "IntegerType", "o": "LongType",
                         "l": "LongType", "x": "DoubleType"},
               tol=lambda row: SEGMENT * 1e300)
    assert [r[1] for r in got] == [2**63 - 1, -2**63, -2**63 + 1,
                                   -2**63 + 6, -2**63 + 12, -2**63 + 19]
    ahead, back = [r[2] for r in got], [r[3] for r in got]
    assert ahead[0] == 3.0 and math.isnan(ahead[1]) \
        and ahead[3] == ahead[4] == 1e300 and ahead[5] is None
    assert back[0] == back[1] == float("inf") and back[2] == 3.0 \
        and math.isnan(back[3]) and back[5] == 1e300


def test_functions_of_one_child_share_its_prefix_sums(monkeypatch):
    """Count, Sum and Average of one child under any frame scan its valid
    counts, its sums and its non-finite counts once per window exec: one
    K2 launch for the group ids, then per child one of valid counts, one
    of a long's sums, three of NaN, +inf and -inf counts; one K1 launch
    of finite sums per child beside the two of the segment bounds."""
    from spark_rapids_tpu_torch.ops import windows as W
    real, calls = W.K, {"cumsum": 0, "seg_scan": 0}

    class Counting:
        def __getattr__(self, name):
            fn = getattr(real, name)
            if name not in calls:
                return fn

            def counted(*args, **kw):
                calls[name] += 1
                return fn(*args, **kw)
            return counted
    monkeypatch.setattr(W, "K", Counting())
    rng = np.random.RandomState(5)
    n = 200
    data = {"k": rng.randint(0, 6, n).tolist(), "o": list(range(n)),
            "l": [None if i % 7 == 0 else int(v) for i, v in
                  enumerate(rng.randint(-1000, 1000, n))],
            "x": [None if i % 9 == 0 else float(v) for i, v in
                  enumerate(rng.uniform(-50, 50, n).round(3))]}

    def q(df, dsl):
        F, col = dsl.functions, dsl.col
        w = dsl.Window.partitionBy(col("k")).orderBy(col("o"))
        near = w.rowsBetween(-1, 1)
        return df.select(col("k"), col("o"),
                         F.count(col("l")).over(w).alias("cl"),
                         F.sum(col("l")).over(w).alias("sl"),
                         F.avg(col("l")).over(w).alias("al"),
                         F.avg(col("l")).over(near).alias("nl"),
                         F.sum(col("x")).over(w).alias("sx"),
                         F.avg(col("x")).over(near).alias("nx"))
    both(q, data, {"k": "IntegerType", "o": "LongType", "l": "LongType",
                   "x": "DoubleType"}, tol=tolerance(data, "x", "k"))
    assert calls == {"cumsum": 1 + (1 + 1 + 3) + (1 + 3),
                     "seg_scan": 2 + 1 + 1}


# --------------------------------------------------------------------------
# an input past batchSizeBytes
# --------------------------------------------------------------------------

def _external():
    rng = np.random.RandomState(77)
    n = 4000
    return {"k": rng.randint(0, 23, n).tolist(),
            "o": rng.randint(0, 500, n).tolist(),
            "v": [None if i % 13 == 0 else float(v) for i, v in
                  enumerate(rng.uniform(-50, 50, n).round(3))]}


def _external_query(df, dsl):
    F, col = dsl.functions, dsl.col
    w = dsl.Window.partitionBy(col("k")).orderBy(col("o"), col("v"))
    return df.select(col("k"), col("o"), col("v"),
                     F.row_number().over(w).alias("rn"),
                     F.sum(col("v")).over(w.rowsBetween(-2, 2)).alias("sv"))


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


def test_external_window_rows_equal_as_a_multiset():
    """Past `batchSizeBytes` the JAX exec hash-exchanges its batches by
    the partition keys and yields one batch per exchange partition; the
    port has no exchange until the exchange item, so it concatenates
    them and yields one batch: the same rows, in another order."""
    _, JaxSession, JL = _jax()
    from spark_rapids_tpu.exec.base import ExecContext as JaxContext
    conf = dict(BATCHED, **{"spark.rapids.sql.reader.batchSizeRows": "256",
                            "spark.rapids.sql.batchSizeBytes": "8k"})
    data = _external()
    jdf, pdf = _frames(data, conf=conf)
    want = _external_query(jdf, JL).collect()
    got = _external_query(pdf, PL).collect()
    key = lambda r: (r[0], r[1], -math.inf if r[2] is None else r[2])  # noqa
    rows_agree(sorted(want, key=key), sorted(got, key=key),
               tolerance(data, "v", "k", 0))
    assert want != got  # the orders differ
    js = JaxSession(conf)
    jplan = js.plan(_external_query(js.from_pydict(data), JL).plan)
    assert sum(1 for _ in jplan.execute(
        JaxContext(js.conf, runtime=js.runtime))) > 1
    pplan = _external_query(pdf, PL).physical_plan()
    (win,) = _find_all(pplan, "TpuWindowExec")
    (co,) = _find_all(pplan, "TpuCoalesceBatchesExec")
    ctx = ExecContext(pdf.session.conf, pdf.session.device)
    assert sum(1 for _ in co.execute(ctx)) > 1
    assert sum(1 for _ in win.execute(ctx)) == 1


def test_the_target_coalesce_concatenates_up_to_batch_size_bytes():
    """Batches of 256 rows at a capacity of 1024 (28,672 bytes each: the
    1024-byte mask, and k, o and v at 8 bytes a value and one a flag):
    under 8k every batch is its own, under 64k two join."""
    conf = {"spark.rapids.sql.reader.batchSizeRows": "256"}
    data = _external()
    for target, batches in (("8k", 16), ("64k", 8)):
        s = TpuSession(dict(conf, **{"spark.rapids.sql.batchSizeBytes":
                                     target}), device="cpu")
        plan = _external_query(s.from_numpy(data), PL).physical_plan()
        (co,) = _find_all(plan, "TpuCoalesceBatchesExec")
        assert co.goal == "target"
        out = list(co.execute(ExecContext(s.conf, s.device)))
        assert len(out) == batches
        assert sum(b.num_rows_host() for b in out) == 4000


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

_PLANS = {
    # two spec groups: two window execs, stacked in the order the JAX
    # package stacks them; frames of one spec share an exec
    "two_specs": (lambda df, dsl: df.select(
        dsl.col("k"),
        dsl.functions.sum(dsl.col("x")).over(
            dsl.Window.partitionBy(dsl.col("k")).orderBy(dsl.col("o"))
            .rowsBetween(-1, 1)).alias("w1"),
        dsl.functions.rank().over(
            dsl.Window.partitionBy(dsl.col("k")).orderBy(dsl.col("o")))
        .alias("w2"),
        dsl.functions.max(dsl.col("s")).over(
            dsl.Window.partitionBy(dsl.col("g"))).alias("w3")),
        [["w3"], ["w1", "w2"]], [("k", "o", "s", "g", "x")]),
    # pruning through the window: the scan keeps the keys, the value and
    # what the projection above reads
    "pruned": (lambda df, dsl: df.select(
        dsl.col("i"),
        dsl.functions.lag(dsl.col("d"), 1).over(
            dsl.Window.partitionBy(dsl.col("k")).orderBy(dsl.col("o")))
        .alias("w1")).filter(dsl.col("w1").is_not_null()),
        [["w1"]], [("k", "o", "i", "d")]),
}


@pytest.mark.parametrize("case", list(_PLANS))
def test_plans(case):
    _, JaxSession, JL = _jax()
    query, funcs, scans = _PLANS[case]
    data = edge_table(100)
    jdf, pdf = _frames(data, EDGE_TYPES)
    jplan = query(jdf, JL).physical_plan()
    pplan = query(pdf, PL).physical_plan()
    for plan in (jplan, pplan):
        wins = _find_all(plan, "TpuWindowExec")
        assert [[f.name for f in w.funcs] for w in wins] == funcs
        for w in wins:
            (child,) = w.children
            assert type(child).__name__ == "TpuCoalesceBatchesExec"
            assert child.goal == "target"
    scan_cols = lambda p: sorted(  # noqa: E731
        tuple(sorted(s.schema.names))
        for s in _find_all(p, "TpuScanMemoryExec"))
    assert scan_cols(pplan) == scan_cols(jplan) == \
        [tuple(sorted(c)) for c in scans]


def test_the_row_estimate_keeps_the_child_s():
    from spark_rapids_tpu.plan import physical as JP
    from spark_rapids_tpu_torch.plan import physical as PP
    _, _, JL = _jax()
    data = edge_table(100)
    jdf, pdf = _frames(data, EDGE_TYPES)
    for df, dsl, mod in ((jdf, JL, JP), (pdf, PL, PP)):
        win = df.filter(dsl.col("keep")).select(
            dsl.col("k"), dsl.functions.rank().over(
                dsl.Window.partitionBy(dsl.col("k"))
                .orderBy(dsl.col("o"))).alias("r"))
        assert type(win.plan.children[0]).__name__ == "LogicalWindow"
        assert mod._estimate_plan_rows(win.plan, df.session.conf) == 100


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def _spec(dsl, rows=None, order=True):
    w = dsl.Window.partitionBy(dsl.col("k"))
    if order:
        w = w.orderBy(dsl.col("o"))
    return w.rowsBetween(*rows) if rows else w


# windows the JAX package runs on its CPU executor: the port refuses them
# when it plans
CPU_WINDOWS = {
    "wide_bounded_min": lambda dsl: dsl.functions.min(dsl.col("v")).over(
        _spec(dsl, (-5000, 5000))),
    "bounded_max_of_257_rows": lambda dsl: dsl.functions.max(dsl.col("v"))
    .over(_spec(dsl, (-128, 128))),
    "string_min_of_a_suffix": lambda dsl: dsl.functions.min(dsl.col("s"))
    .over(_spec(dsl, (0, dsl.Window.unboundedFollowing))),
    "string_max_of_a_bounded_frame": lambda dsl: dsl.functions.max(
        dsl.col("s")).over(_spec(dsl, (-1, 1))),
}


@pytest.mark.parametrize("case", list(CPU_WINDOWS))
def test_cpu_windows_are_refused_at_planning_time(case):
    """The JAX package answers on its CPU executor; the port, which has
    none, raises NotImplementedError naming the limit when it plans (a
    frame of 256 rows still runs: test_a_bounded_frame_of_256_rows_runs)."""
    _, _, JL = _jax()
    data = dict(base_data(16), s=[str(v) for v in range(300)])
    jdf, pdf = _frames(data)
    want = jdf.select(JL.col("k"), CPU_WINDOWS[case](JL).alias("w"))
    assert len(want.collect()) == 300
    got = pdf.select(PL.col("k"), CPU_WINDOWS[case](PL).alias("w"))
    assert [f.name for f in got.schema] == ["k", "w"]
    with pytest.raises(NotImplementedError, match="CPU executor"):
        got.physical_plan()
    with pytest.raises(NotImplementedError):
        got.collect()


def test_a_bounded_frame_of_256_rows_runs():
    """The widest bounded Min the device takes, held to a Python loop
    over each partition in (o, input row) order (the JAX package unrolls
    the 256 gathers into one program, which XLA takes minutes to
    compile)."""
    data = base_data(16)
    pdf = TpuSession({}, device="cpu").from_numpy(data)
    got = pdf.select(PL.col("k"), PL.col("o"), PL.functions.min(
        PL.col("v")).over(_spec(PL, (-128, 127))).alias("w")).collect()
    rows = sorted(range(300), key=lambda r: (data["k"][r], data["o"][r], r))
    want = []
    for r in range(300):
        part = [x for x in rows if data["k"][x] == data["k"][r]]
        j = part.index(r)
        vals = [data["v"][x] for x in part[max(0, j - 128):j + 128]
                if data["v"][x] is not None]
        want.append((data["k"][r], data["o"][r], min(vals) if vals
                     else None))
    assert got == want


# windows both packages refuse, each with AnalysisError when it plans
REFUSED = {
    "percentile": lambda dsl: dsl.functions.percentile(dsl.col("v"), 0.5)
    .over(_spec(dsl)),
    "distinct_sum": lambda dsl: dsl.functions._agg(
        "Sum", dsl.col("v"), True).over(_spec(dsl)),
    "rank_without_order": lambda dsl: dsl.functions.rank().over(
        _spec(dsl, order=False)),
    "lag_without_order": lambda dsl: dsl.functions.lag(dsl.col("v")).over(
        _spec(dsl, order=False)),
    "sum_of_strings": lambda dsl: dsl.functions.sum(dsl.col("s")).over(
        _spec(dsl)),
    "avg_of_booleans": lambda dsl: dsl.functions.avg(dsl.col("b")).over(
        _spec(dsl)),
    "empty_frame": lambda dsl: dsl.functions.sum(dsl.col("v")).over(
        _spec(dsl, (2, 1))),
    "not_a_window_function": lambda dsl: dsl.functions.abs(dsl.col("v"))
    .over(_spec(dsl)),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_windows_both_packages_refuse_raise_analysis_error(case):
    from spark_rapids_tpu.plan.analysis import AnalysisError as JaxError
    _, _, JL = _jax()
    data = dict(base_data(19), s=["a"] * 300, b=[True] * 300)
    jdf, pdf = _frames(data)
    with pytest.raises(JaxError, match="window: "):
        jdf.select(JL.col("k"), REFUSED[case](JL).alias("w")).collect()
    got = pdf.select(PL.col("k"), REFUSED[case](PL).alias("w"))
    with pytest.raises(AnalysisError, match="window: "):
        got.collect()
    with pytest.raises(AnalysisError, match="window: "):
        got.schema
