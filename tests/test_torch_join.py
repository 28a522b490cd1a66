"""The port's inner, left_semi and left_anti equi-joins and Limit against
the JAX package, on the CPU, from the same seeded tables: the rows must be
equal in the same order (ints, strings and dates exact, floats by
tests/compare.py), and the two physical plans must hold the same join
execs, of the same type, building the same side.  The JAX side runs on
its CPU backend, as the tier-1 conftest forces; the port on
`device="cpu"`, its kernels' plain versions.  Join shapes follow
tests/test_join.py; the outer joins are in tests/test_torch_outer_join.py,
which uses the helpers here."""
import os
import random

import pytest
import torch

from compare import assert_rows_equal
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.engine import TpuSession as JaxSession
from spark_rapids_tpu.plan.logical import SortOrder as JSortOrder
from spark_rapids_tpu.plan.logical import col as jcol
from spark_rapids_tpu.plan.logical import functions as JF
from spark_rapids_tpu_torch import SortOrder as PSortOrder
from spark_rapids_tpu_torch import TpuSession
from spark_rapids_tpu_torch import col as pcol
from spark_rapids_tpu_torch import functions as PF
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.exec.join import (TpuHashJoinExec,
                                              TpuReorderColumnsExec)
from spark_rapids_tpu_torch.ops.cast import Cast

NO_BROADCAST = {"spark.sql.autoBroadcastJoinThreshold": "-1"}


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


_TYPES = {"int": (JT.IntegerType, PT.IntegerType),
          "long": (JT.LongType, PT.LongType),
          "double": (JT.DoubleType, PT.DoubleType),
          "string": (JT.StringType, PT.StringType),
          "date": (JT.DateType, PT.DateType)}
_JOIN_EXECS = ("TpuHashJoinExec", "TpuBroadcastHashJoinExec",
               "TpuShuffledHashJoinExec")


class _Api:
    """One package's DataFrame vocabulary, so one query function serves
    both."""

    def __init__(self, session, col, functions, sort_order, make):
        self.col, self.F, self.SortOrder = col, functions, sort_order
        self._session, self._make = session, make

    def table(self, spec):
        data, fields = spec
        return self._make(self._session, data, fields)


def _jax_api(conf):
    def make(s, data, fields):
        return s.from_pydict(data, JT.Schema(
            [JT.StructField(n, _TYPES[t][0]) for n, t in fields]))
    return _Api(JaxSession(dict(conf)), jcol, JF, JSortOrder, make)


def _port_api(conf):
    def make(s, data, fields):
        return s.from_numpy(data, PT.Schema(
            [PT.StructField(n, _TYPES[t][1]) for n, t in fields]))
    return _Api(TpuSession(dict(conf), device="cpu"), pcol, PF, PSortOrder,
                make)


def _value(rng, t):
    if t == "string":
        return f"k{rng.randint(0, 15)}"
    if t == "double":
        r = rng.random()
        return float("nan") if r < 0.1 else \
            rng.choice([0.0, -0.0]) if r < 0.2 else float(rng.randint(0, 15))
    return rng.randint(0, 15)


def keyed(seed, n, key_range=15, key_type="int", null_ratio=0.1,
          extra=None, key="k"):
    """A table spec whose key column collides often: nulls, and for
    doubles NaN and both zeros."""
    rng = random.Random(seed)
    keys = []
    for _ in range(n):
        if rng.random() < null_ratio:
            keys.append(None)
        elif key_type == "string":
            keys.append(f"k{rng.randint(0, key_range)}")
        elif key_type == "double":
            r = rng.random()
            keys.append(float("nan") if r < 0.1 else
                        rng.choice([0.0, -0.0]) if r < 0.2
                        else float(rng.randint(0, key_range)))
        else:
            keys.append(rng.randint(0, key_range))
    data, fields = {key: keys}, [(key, key_type)]
    for name, t in (extra or {}).items():
        data[name] = [None if rng.random() < 0.05 else _value(rng, t)
                      for _ in range(n)]
        fields.append((name, t))
    return data, fields


def _jax_rows(df):
    """Rows of a JAX DataFrame from its Arrow columns (collect() keys rows
    by name, which drops a repeated column)."""
    table = df.to_arrow()
    return list(zip(*[c.to_pylist() for c in table.columns]))


def join_nodes(node):
    """(exec class, join type, build side's columns) of every join exec
    in a physical plan, depth first."""
    out = []
    if type(node).__name__ in _JOIN_EXECS:
        out.append((type(node).__name__, node.join_type,
                    tuple(node.children[1].schema.names)))
    for c in node.children:
        out += join_nodes(c)
    return out


def run_both(build, conf=None, plans=True):
    """The query `build(api)` through both packages: (JAX rows, port rows,
    port DataFrame), the rows asserted equal in order, and the join
    execs of the two plans asserted to agree."""
    conf = conf or {}
    jdf = build(_jax_api(conf))
    pdf = build(_port_api(conf))
    want, got = _jax_rows(jdf), pdf.collect()
    assert_rows_equal(want, got, ignore_order=False)
    if plans:
        jn, pn = join_nodes(jdf.physical_plan()), join_nodes(
            pdf.physical_plan())
        assert pn and jn == pn, (jn, pn)
    return want, got, pdf


@pytest.mark.parametrize("route", ["broadcast", "hash"])
@pytest.mark.parametrize("key_type", ["int", "long", "string", "double",
                                      "date"])
@pytest.mark.parametrize("how", ["inner", "left_semi", "left_anti"])
def test_join_types_keys_and_routes(how, key_type, route):
    left = keyed(100, 300, key_type=key_type, extra={"a": "long"})
    right = keyed(200, 200, key_type=key_type, extra={"b": "double"})
    want, _, pdf = run_both(
        lambda x: x.table(left).join(x.table(right), "k", how),
        NO_BROADCAST if route == "hash" else {})
    assert want
    plan = pdf.physical_plan()
    assert type(plan).__name__ == ("TpuHashJoinExec" if route == "hash"
                                   else "TpuBroadcastHashJoinExec")


def _two_key(seed):
    r = random.Random(seed)
    n = 300
    return ({"k1": [r.randint(0, 8) if r.random() > 0.1 else None
                    for _ in range(n)],
             "k2": [f"s{r.randint(0, 5)}" if r.random() > 0.1 else None
                    for _ in range(n)],
             "v": [r.random() for _ in range(n)]},
            [("k1", "int"), ("k2", "string"), ("v", "double")])


def _no_match_right():
    rng = random.Random(203)
    return ({"k": [rng.randint(100, 200) for _ in range(80)],
             "b": [rng.random() for _ in range(80)]},
            [("k", "int"), ("b", "double")])


_EMPTY_RIGHT = ({"k": [], "b": []}, [("k", "int"), ("b", "double")])
_EMPTY_LEFT = ({"k": [], "a": []}, [("k", "int"), ("a", "long")])
_EMPTY_STRINGS = ({"k": [], "s": []}, [("k", "string"), ("s", "string")])

# (name, query, expect rows): the shapes of tests/test_join.py
_SHAPES = [
    ("multi_key_inner", lambda x: x.table(_two_key(1061)).join(
        x.table(_two_key(1062)), ["k1", "k2"], "inner"), True),
    ("multi_key_semi", lambda x: x.table(_two_key(1063)).join(
        x.table(_two_key(1064)), ["k1", "k2"], "left_semi"), True),
    ("duplicate_heavy", lambda x: x.table(keyed(
        102, 400, key_range=3, extra={"a": "int"})).join(x.table(keyed(
            202, 300, key_range=3, extra={"b": "int"})), "k", "inner"),
     True),
    ("no_matches_inner", lambda x: x.table(keyed(
        103, 100, key_range=5, extra={"a": "long"})).join(
            x.table(_no_match_right()), "k", "inner"), False),
    ("no_matches_anti", lambda x: x.table(keyed(
        103, 100, key_range=5, extra={"a": "long"})).join(
            x.table(_no_match_right()), "k", "left_anti"), True),
    ("empty_build_inner", lambda x: x.table(keyed(
        104, 120, extra={"a": "long"})).join(x.table(_EMPTY_RIGHT), "k",
                                             "inner"), False),
    ("empty_build_semi", lambda x: x.table(keyed(
        104, 120, extra={"a": "long"})).join(x.table(_EMPTY_RIGHT), "k",
                                             "left_semi"), False),
    ("empty_build_anti", lambda x: x.table(keyed(
        104, 120, extra={"a": "long"})).join(x.table(_EMPTY_RIGHT), "k",
                                             "left_anti"), True),
    ("empty_build_string_keys", lambda x: x.table(keyed(
        106, 120, key_type="string", extra={"a": "long"})).join(
            x.table(_EMPTY_STRINGS), "k", "inner"), False),
    ("empty_stream", lambda x: x.table(_EMPTY_LEFT).join(x.table(keyed(
        205, 120, extra={"b": "double"})), "k", "inner"), False),
    ("join_then_filter_and_aggregate", lambda x: x.table(keyed(
        110, 400, key_range=10, extra={"qty": "long"})).join(
            x.table(keyed(210, 50, key_range=10, extra={"price": "double"})),
            "k", "inner").filter(x.col("qty") > 3).group_by("k").agg(
                x.F.count(x.col("qty")).alias("n"),
                x.F.max(x.col("price")).alias("mx")).order_by("k"), True),
]


@pytest.mark.parametrize("route", ["broadcast", "hash"])
@pytest.mark.parametrize("name,build,nonempty", _SHAPES,
                         ids=[s[0] for s in _SHAPES])
def test_join_shapes(name, build, nonempty, route):
    want, _, _ = run_both(build, NO_BROADCAST if route == "hash" else {})
    assert bool(want) == nonempty, name


def _residual(how):
    def q(x):
        left = x.table(keyed(107, 200, extra={"a": "int"}))
        right = x.table(keyed(207, 200, extra={"b": "int"})).select(
            x.col("k").alias("kr"), x.col("b"))
        return left.join(right, (x.col("k") == x.col("kr"))
                         & (x.col("a") > x.col("b")), how)
    return q


@pytest.mark.parametrize("route", ["broadcast", "hash"])
@pytest.mark.parametrize("how", ["inner", "left_semi", "left_anti"])
def test_residual_condition(how, route):
    want, _, _ = run_both(_residual(how),
                          NO_BROADCAST if route == "hash" else {})
    assert want


def _self_join(how):
    """A self join whose residual reads the right side's copy of a column
    as `w_r` (tests/test_join.py's q16/q94 EXISTS shape)."""
    def q(x):
        rows = x.table(keyed(118, 300, key_range=40, extra={"w": "int"}))
        return rows.join(rows, (x.col("k") == x.col("k"))
                         & (x.col("w") != x.col("w_r")), how)
    return q


@pytest.mark.parametrize("case", ["inner", "left_semi", "using"])
def test_self_join_renaming_and_using(case):
    if case == "using":
        spec = keyed(111, 150, extra={"a": "long"})
        want, got, _ = run_both(
            lambda x: x.table(spec).join(x.table(spec), "k"))
        assert len(got[0]) == 3  # k, a, a: the USING key once
    else:
        want, got, _ = run_both(_self_join(case))
        assert len(got[0]) == (4 if case == "inner" else 2)
    assert want


@pytest.mark.parametrize("other", ["long", "double"])
def test_int_key_against_a_wider_key_is_cast(other):
    """An int32 key against an int64 or a double key: the planner widens
    the int side by a cast (int bits against double bits would match
    nothing), and the rows equal the JAX package's."""
    left = keyed(120, 300, key_type="int", extra={"a": "long"})
    right = keyed(220, 200, key_type=other, null_ratio=0.05,
                  extra={"b": "long"}, key="k2")
    if other == "double":  # whole numbers only, so values can match
        right[0]["k2"] = [None if v is None or v != v else float(int(v))
                          for v in right[0]["k2"]]
    want, _, pdf = run_both(lambda x: x.table(left).join(
        x.table(right), x.col("k") == x.col("k2")), NO_BROADCAST)
    assert want
    join = pdf.physical_plan()
    assert isinstance(join, TpuHashJoinExec)
    (lk,), (rk,) = join.left_keys, join.right_keys
    assert isinstance(lk, Cast) and lk.dtype is _TYPES[other][1]
    assert not isinstance(rk, Cast) and rk.dtype is _TYPES[other][1]


@pytest.mark.parametrize("case", ["small_left_swaps", "hinted_left",
                                  "hinted_right_keeps_sides"])
def test_build_side_choice(case):
    """The inner-join swap: a left child under half the right's estimated
    bytes, or hinted for broadcast, becomes the build side (the columns
    reordered back after); a hint on the right child keeps the sides."""
    small = keyed(130, 40, extra={"a": "long"})
    big = keyed(230, 400, extra={"b": "double", "c": "string"}, key="k2")

    def q(x):
        left, right = x.table(small), x.table(big)
        if case == "hinted_left":
            left = left.hint("broadcast")
        if case == "hinted_right_keeps_sides":
            right = right.hint("broadcast")
        return left.join(right, x.col("k") == x.col("k2"))
    want, _, pdf = run_both(q, {} if case == "hinted_left"
                            else NO_BROADCAST)
    assert want
    plan = pdf.physical_plan()
    swapped = isinstance(plan, TpuReorderColumnsExec)
    assert swapped == (case != "hinted_right_keeps_sides")
    join = plan.children[0] if swapped else plan
    assert join.children[1].schema.names == (
        ["k", "a"] if swapped else ["k2", "b", "c"])


@pytest.mark.parametrize("case", ["order_by", "zero", "more_than_rows",
                                  "across_batches"])
def test_limit(case):
    spec = keyed(140, 300, extra={"a": "long", "s": "string"})
    conf = {}
    if case == "across_batches":
        conf = {"spark.rapids.sql.reader.batchSizeRows": "64"}

    def q(x):
        df = x.table(spec)
        if case == "order_by":
            return df.order_by(x.SortOrder(x.col("a"), ascending=False),
                               "s", "k").limit(7)
        if case == "zero":
            return df.limit(0)
        if case == "more_than_rows":
            return df.filter(x.col("a") > 5).limit(1000)
        return df.filter(x.col("k") > 3).limit(150)
    want, got, _ = run_both(q, conf, plans=False)
    assert len(got) == {"order_by": 7, "zero": 0, "across_batches": 150}.get(
        case, len(want))


def _exec_names(node):
    return [type(node).__name__] + [n for c in node.children
                                    for n in _exec_names(c)]


@pytest.mark.parametrize("case", ["conditional_left", "conditional_right",
                                  "conditional_full", "full_using", "cross",
                                  "no_equi_key", "partitioned"])
def test_unported_joins_raise_at_planning(case):
    """Joins the port does not plan raise NotImplementedError, naming the
    case; where the JAX package plans the join for its CPU executor (an
    outer join with a residual condition, a full USING join), its plan
    holds a CpuJoinExec."""
    conf = dict(NO_BROADCAST)
    if case == "partitioned":  # a build side over 8 bytes partitions
        conf["spark.rapids.sql.tpu.join.partitioned.threshold"] = "8"
    left = ({"k": [1, 2], "a": [3, 4]}, [("k", "long"), ("a", "long")])
    right = ({"k2": [1, 5], "b": [6, 7]}, [("k2", "long"), ("b", "long")])
    how = case.split("_")[-1]

    def q(x):
        lt, rt = x.table(left), x.table(right)
        on = x.col("k") == x.col("k2")
        if case == "no_equi_key":
            return lt.join(rt, x.col("a") < x.col("b"))
        if case == "cross":
            return lt.join(rt, on, "cross")
        if case == "partitioned":
            return lt.join(rt, on)
        if case == "full_using":
            return lt.join(x.table((dict(right[0], k=right[0]["k2"]),
                                    right[1] + [("k", "long")])), "k",
                           "full")
        return lt.join(rt, on & (x.col("a") < x.col("b")), how)
    match = {"no_equi_key": "equi-join keys", "cross": "cross joins",
             "partitioned": "spark.rapids.sql.tpu.join.partitioned.enabled",
             "full_using": "full USING joins"}.get(
                 case, f"conditional {how} joins")
    with pytest.raises(NotImplementedError, match=match):
        q(_port_api(conf)).physical_plan()
    if case.startswith("conditional") or case == "full_using":
        assert "CpuJoinExec" in _exec_names(q(_jax_api(conf))
                                            .physical_plan())


def test_hint_on_a_pruned_scan_is_lost_as_in_the_jax_package():
    """The JAX package's column pruning replaces a scan it narrows with a
    new node that carries no hints, so a broadcast hint on that scan is
    dropped; the port does the same, and both plan a hash join here."""
    left = keyed(150, 100, extra={"v": "double"})
    right = keyed(250, 100, extra={"w": "long", "x": "long"}, key="k2")
    _, _, pdf = run_both(lambda x: x.table(left).join(
        x.table(right).hint("broadcast"), x.col("k") == x.col("k2"))
        .select(x.col("v"), x.col("w")), NO_BROADCAST)
    assert join_nodes(pdf.physical_plan()) == [
        ("TpuHashJoinExec", "inner", ("k2", "w"))]


def test_scan_size_estimate_equals_pyarrow_nbytes():
    """The planner's size of an in-memory table is pyarrow's
    Table.nbytes in the JAX package; the port computes the same count
    from its device columns, nulls, booleans and UTF-8 strings too."""
    import pyarrow as pa
    rng = random.Random(7)
    for n in (0, 1, 9, 300):
        data = {
            "i": [None if rng.random() < 0.2 else rng.randint(-5, 5)
                  for _ in range(n)],
            "l": [rng.randint(0, 9) for _ in range(n)],
            "d": [None if rng.random() < 0.1 else rng.random()
                  for _ in range(n)],
            "b": [rng.random() < 0.5 for _ in range(n)],
            "s": [None if rng.random() < 0.1 else "é" * rng.randint(0, 3)
                  + "x" * rng.randint(0, 20) for _ in range(n)],
            "t": [rng.randint(0, 9000) for _ in range(n)]}
        fields = [("i", "int"), ("l", "long"), ("d", "double"),
                  ("b", "boolean"), ("s", "string"), ("t", "date")]
        types = dict(_TYPES, boolean=(JT.BooleanType, PT.BooleanType))
        want = pa.table({k: pa.array(v, type=JT.to_arrow(types[t][0]))
                         for (k, t), v in zip(fields, data.values())}).nbytes
        df = TpuSession(device="cpu").from_numpy(data, PT.Schema(
            [PT.StructField(k, types[t][1]) for k, t in fields]))
        assert df.plan.nbytes == want, n


class _Watched:
    """Wraps an exec's child so that it yields each batch as fresh tensors
    and keeps a weak reference to one of them: `watch` picks the tensor
    (a column's data, or the selection mask) that only the input batch
    holds.  Before it makes the next batch, the last one must be gone:
    nothing above holds its input while the stream works."""

    def __init__(self, node, watch):
        import gc
        import weakref

        import torch
        from spark_rapids_tpu_torch.exec.base import ExecNode
        seen = self.seen = []

        class Fresh(ExecNode):
            schema = node.children[0].schema

            def execute(self, ctx):
                for b in self.children[0].execute(ctx):
                    gc.collect()
                    assert not seen or seen[-1]() is None, len(seen)
                    fresh = [b.take(torch.arange(b.capacity))]
                    seen.append(weakref.ref(watch(fresh[0])))
                    yield fresh.pop()
        node.children[0] = Fresh(node.children[0])


def _assert_holds_no_input(node, watched, session):
    """Runs `node`; while each output is held, the input batch behind it
    is gone.  Returns the live rows."""
    import gc

    from spark_rapids_tpu_torch.exec.base import ExecContext
    rows = 0
    for out in node.execute(ExecContext(session.conf, session.device)):
        gc.collect()
        assert watched.seen[-1]() is None, len(watched.seen)
        rows += int(out.num_rows())
    return rows


def _stream_session():
    import numpy as np
    s = TpuSession({"spark.rapids.sql.reader.batchSizeRows": "64"},
                   device="cpu")
    keys = np.arange(256, dtype=np.int64)
    return s, keys, s.from_numpy({"k": keys, "v": keys * 2})


def test_a_join_holds_no_stream_batch_while_its_consumer_runs():
    """Once a join has handed on the output of a stream batch, neither the
    join nor the stream below it keeps that batch alive, so a chain of
    joins holds two generations of batches, not three (at SF10, q7's five
    joins of ~18 M lines carry every column and did not fit three)."""
    s, keys, df = _stream_session()
    df = df.join(s.from_numpy({"k2": keys[::2]}),
                 on=pcol("k") == pcol("k2"))
    join = df.physical_plan()
    while not isinstance(join, TpuHashJoinExec):
        join = join.children[0]
    watched = _Watched(join, lambda b: b.columns[0].data)
    assert _assert_holds_no_input(join, watched, s) == 128
    assert len(watched.seen) == 4


@pytest.mark.parametrize("kind", ["project", "filter", "reorder"])
def test_a_streaming_exec_holds_no_input_batch_while_its_consumer_runs(
        kind):
    """The same for the other execs that map a stream batch by batch: a
    projection drops its input's other columns, a filter its input's
    selection mask, and the reorder after a swapped join the columns it
    leaves out, as soon as the output is handed on."""
    from spark_rapids_tpu_torch.exec.basic import (TpuFilterExec,
                                                   TpuProjectExec)
    s, _, df = _stream_session()
    if kind == "project":
        node = df.select((pcol("v") + 1).alias("w")).physical_plan()
        want = 256
    elif kind == "filter":
        node = df.filter(pcol("k") < 100).physical_plan()
        want = 100
    else:
        scan = df.physical_plan()
        node = TpuReorderColumnsExec(scan, [1], PT.Schema(
            [scan.schema[1]]))
        want = 256
    assert isinstance(node, {"project": TpuProjectExec,
                             "filter": TpuFilterExec,
                             "reorder": TpuReorderColumnsExec}[kind])
    watched = _Watched(node, (lambda b: b.sel) if kind == "filter"
                       else (lambda b: b.columns[0].data))
    assert _assert_holds_no_input(node, watched, s) == want
    assert len(watched.seen) == 4


@pytest.mark.parametrize("kind", ["aggregate", "to_host"])
def test_a_consumer_holds_no_input_batch_while_its_stream_works(kind):
    """An aggregate and the device-to-host edge drop each input batch
    before they ask the stream for the next (`_Watched` checks it)."""
    from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exec.basic import DeviceToHostExec
    s, _, df = _stream_session()
    ctx = ExecContext(s.conf, s.device)
    if kind == "aggregate":
        node = df.group_by((pcol("k") % 8).alias("g")).agg(
            PF.sum(pcol("v")).alias("s")).physical_plan()
        while not isinstance(node, TpuHashAggregateExec):
            node = node.children[0]
        while isinstance(node.children[0], TpuHashAggregateExec):
            node = node.children[0]
        watched = _Watched(node, lambda b: b.columns[0].data)
        rows = sum(int(b.num_rows()) for b in node.execute(ctx))
        assert rows == 8
    else:
        node = DeviceToHostExec(df.physical_plan())
        watched = _Watched(node, lambda b: b.columns[0].data)
        got = [r for part in node.execute_host(ctx, rows=True)
               for r in part]
        assert len(got) == 256
    assert len(watched.seen) == 4


def test_the_scan_holds_no_batch_it_handed_on():
    """The in-memory scan's frame keeps no slice it yielded."""
    import gc
    import weakref

    from spark_rapids_tpu_torch.exec.base import ExecContext
    s, _, df = _stream_session()
    scan = df.physical_plan()
    it = scan.execute(ExecContext(s.conf, s.device))
    refs = []
    for _ in range(4):
        b = next(it)
        refs.append(weakref.ref(b.columns[0].data))
        del b
        gc.collect()
        assert refs[-1]() is None, len(refs)
