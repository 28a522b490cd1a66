"""The port's left, right and full outer equi-joins against the JAX
package, on the CPU, from the same seeded tables: the rows must be equal
in the same order (ints, strings and dates exact, floats by
tests/compare.py), and the two physical plans must hold the same join
execs: class (so broadcast or not), join type, the columns of the side
built, and whether the sides were swapped.  Shapes follow
tests/test_join.py's outer-join tests: null keys on both sides (the
`keyed` tables of tests/test_torch_join.py), duplicate keys, no match at
all, an empty build or stream side, a stream of several batches, and
USING joins.  A full outer join never broadcasts, in either package."""
import random

import pytest

from compare import assert_rows_equal
from test_torch_join import (NO_BROADCAST, _EMPTY_LEFT, _EMPTY_RIGHT,
                             _jax_api, _jax_rows, _no_match_right,
                             _port_api, _two_key, keyed)
# the module fixture pinning one torch thread a xdist worker: autouse
# here too
from test_torch_join import _one_torch_thread  # noqa: F401
from spark_rapids_tpu_torch import DataFrame, TpuSession
from spark_rapids_tpu_torch.plan import logical as PL

_JOIN_EXECS = ("TpuHashJoinExec", "TpuBroadcastHashJoinExec",
               "TpuShuffledHashJoinExec")
SEVERAL_BATCHES = {"spark.rapids.sql.reader.batchSizeRows": "64"}


def plan_joins(node, swapped=False):
    """(exec class, join type, build side's columns, swapped) of every
    join exec in a physical plan of either package, depth first; swapped
    means a TpuReorderColumnsExec puts the columns back above it."""
    out = []
    if type(node).__name__ in _JOIN_EXECS:
        out.append((type(node).__name__, node.join_type,
                    tuple(node.children[1].schema.names), swapped))
    for c in node.children:
        out += plan_joins(c, type(node).__name__ == "TpuReorderColumnsExec")
    return out


def check(build, conf):
    """The query `build(api)` through both packages: the rows equal in
    order and the plans' join execs equal; returns (the port's rows, its
    join execs)."""
    jdf, pdf = build(_jax_api(conf)), build(_port_api(conf))
    got = pdf.collect()
    assert_rows_equal(_jax_rows(jdf), got, ignore_order=False)
    want_plan = plan_joins(jdf.physical_plan())
    got_plan = plan_joins(pdf.physical_plan())
    assert got_plan and got_plan == want_plan, (want_plan, got_plan)
    return got, got_plan


def _routes(hows):
    """(how, route) pairs: a full join takes the hash route only."""
    return [(h, r) for h in hows for r in ("broadcast", "hash")
            if not (h == "full" and r == "broadcast")]


def _conf(route, extra=None):
    return dict(NO_BROADCAST if route == "hash" else {}, **(extra or {}))


def _want_exec(how, route):
    return ("TpuHashJoinExec" if route == "hash" or how == "full"
            else "TpuBroadcastHashJoinExec")


def _rows(spec):
    return len(next(iter(spec[0].values())))


def _preserved(how, n_left, n_right):
    """The rows an outer join gives when nothing matches."""
    return (n_left if how in ("left", "full") else 0) \
        + (n_right if how in ("right", "full") else 0)


@pytest.mark.parametrize("key_type", ["int", "long", "double", "string",
                                      "date"])
@pytest.mark.parametrize("how,route", _routes(["left", "right", "full"]))
def test_outer_join_types_keys_and_routes(how, route, key_type):
    left = keyed(300, 240, key_type=key_type, extra={"a": "long"})
    right = keyed(400, 160, key_type=key_type, extra={"b": "double"},
                  key="k2")
    got, plan = check(lambda x: x.table(left).join(
        x.table(right), x.col("k") == x.col("k2"), how), _conf(route))
    assert plan == [(_want_exec(how, route),
                     "full" if how == "full" else "left",
                     ("k", "a") if how == "right" else ("k2", "b"),
                     how == "right")]
    # a null key matches nothing: its row comes with the other side null
    if how in ("left", "full"):
        assert any(r[0] is None and r[2:] == (None, None) for r in got)
    if how in ("right", "full"):
        assert any(r[:3] == (None, None, None) for r in got)


def _renamed(spec, keys):
    """A table spec with its key columns renamed `name_r`."""
    data, fields = spec
    name = {k: k + "_r" for k in keys}
    return ({name.get(c, c): v for c, v in data.items()},
            [(name.get(c, c), t) for c, t in fields])


# (name, left spec, right spec, keys, conf)
_SHAPES = [
    ("duplicate_heavy", keyed(311, 300, key_range=3, extra={"a": "int"}),
     keyed(411, 200, key_range=3, extra={"b": "int"}), ["k"], {}),
    ("no_match", keyed(312, 100, key_range=5, extra={"a": "long"}),
     _no_match_right(), ["k"], {}),
    ("empty_build", keyed(310, 200, extra={"a": "long"}), _EMPTY_RIGHT,
     ["k"], {}),
    ("empty_stream", _EMPTY_LEFT, keyed(412, 120, extra={"b": "double"}),
     ["k"], {}),
    ("several_batches", keyed(313, 400, key_range=40, extra={"a": "long"}),
     keyed(413, 300, key_range=40, extra={"b": "double"}), ["k"],
     SEVERAL_BATCHES),
    ("multi_key", _two_key(1071), _two_key(1072), ["k1", "k2"], {}),
]


@pytest.mark.parametrize("how,route", _routes(["left", "right", "full"]))
@pytest.mark.parametrize("name,left,right,keys,conf", _SHAPES,
                         ids=[s[0] for s in _SHAPES])
def test_outer_join_shapes(name, left, right, keys, conf, how, route):
    right = _renamed(right, keys)

    def q(x):
        cond = None
        for k in keys:
            e = x.col(k) == x.col(k + "_r")
            cond = e if cond is None else cond & e
        return x.table(left).join(x.table(right), cond, how)
    got, plan = check(q, _conf(route, conf))
    assert plan[0][0] == _want_exec(how, route)
    n_left, n_right = _rows(left), _rows(right)
    if name in ("no_match", "empty_build", "empty_stream"):
        assert len(got) == _preserved(how, n_left, n_right)
    else:
        assert len(got) > max(_preserved(how, n_left, n_right) // 2, 1)


@pytest.mark.parametrize("how,route", _routes(["left", "right"]))
def test_outer_using_join(how, route):
    """A USING join keeps one key column, in the left side's position; in
    a right join a right row without a match shows its own key there
    (Spark's coalesced key), taken from the right block."""
    left = keyed(330, 60, extra={"a": "long"})
    right = keyed(430, 90, extra={"b": "double"})
    got, plan = check(lambda x: x.table(left).join(x.table(right), "k",
                                                   how), _conf(route))
    assert plan[0][1:] == ("left", ("k", "a") if how == "right"
                           else ("k", "b"), how == "right")
    assert len(got[0]) == 3  # k, a, b
    if how == "right":
        lone = [r for r in got if r[1] is None and r[0] is not None]
        assert lone
        assert {r[0] for r in lone} <= set(right[0]["k"])
    else:
        assert any(r[2] is None and r[0] is not None for r in got)


def test_full_join_tail_across_several_stream_batches():
    """The build-hit mask is ORed across the stream batches: a build row
    that only the last stream batch matches is not in the tail, and one
    that no batch matches is there once."""
    rng = random.Random(320)
    n = 300  # five stream batches of 64 rows; the last alone has 256..299
    left = ({"k": list(range(n)),
             "a": [rng.randint(0, 9) for _ in range(n)]},
            [("k", "int"), ("a", "long")])
    right = ({"k2": list(range(0, 400, 2)) + [None, None],
              "b": [float(i) for i in range(202)]},
             [("k2", "int"), ("b", "double")])
    got, _ = check(lambda x: x.table(left).join(
        x.table(right), x.col("k") == x.col("k2"), "full"),
        dict(NO_BROADCAST, **SEVERAL_BATCHES))
    tail = [r for r in got if r[0] is None]
    # k2 = 300..398 and the two null keys match no stream row
    assert sorted(r[2] for r in tail if r[2] is not None) == list(
        range(300, 400, 2))
    assert sum(r[2] is None for r in tail) == 2
    assert len(got) == n + len(tail)


@pytest.mark.parametrize("how", ["left", "right"])
def test_outer_join_then_aggregate(how):
    """q13's shape: an outer join, a CaseWhen over the nullable side, a
    grouped sum, then an aggregate of the sums."""
    left = keyed(340, 300, key_range=30, null_ratio=0.05,
                 extra={"a": "long"})
    right = keyed(440, 200, key_range=40, null_ratio=0.05,
                  extra={"b": "long"}, key="k2")

    def q(x):
        j = x.table(left).join(x.table(right), x.col("k") == x.col("k2"),
                               how)
        side = "b" if how == "left" else "a"
        per = (j.with_column("hit", x.F.when(x.col(side).is_null(), 0)
                             .otherwise(1))
               .group_by(x.col("k" if how == "left" else "k2"))
               .agg(x.F.sum(x.col("hit")).alias("n")))
        return (per.group_by(x.col("n"))
                .agg(x.F.count(x.col("n")).alias("dist"))
                .order_by("n"))
    got, _ = check(q, NO_BROADCAST)
    assert len(got) > 2 and got[0][0] == 0


@pytest.mark.parametrize("how", ["left_outer", "full_outer"])
def test_outer_spelling_plans_the_canonical_type(how):
    """A logical join typed `left_outer` or `full_outer` gives the rows
    of `left` or `full`, and its exec keeps the canonical name."""
    s = TpuSession(dict(NO_BROADCAST), device="cpu")
    data, _ = keyed(350, 120, extra={"a": "long"})
    other, _ = keyed(450, 90, extra={"b": "double"}, key="k2")
    left, right = s.from_numpy(data), s.from_numpy(other)
    on = PL.col("k") == PL.col("k2")
    canonical = how.split("_")[0]
    rows = {}
    for jt in (how, canonical):
        df = DataFrame(s, PL.LogicalJoin(left.plan, right.plan, jt,
                                         condition=on))
        rows[jt] = df.collect()
        assert plan_joins(df.physical_plan())[0][1] == canonical
    assert rows[how]
    assert_rows_equal(rows[canonical], rows[how], ignore_order=False)


@pytest.mark.parametrize("how", ["left", "right", "full"])
def test_outer_join_null_slots_hold_zeros(how):
    """The side without a match comes out null with zeros in its slots
    (strings: zero bytes and length), as the JAX package's mask_invalid
    leaves them and as every column's null slots are kept."""
    from spark_rapids_tpu_torch.exec.base import ExecContext
    left, _ = keyed(360, 150, extra={"a": "string", "d": "date"})
    right, _ = keyed(460, 100, extra={"b": "double", "s": "string"},
                     key="k2")
    s = TpuSession(dict(NO_BROADCAST, **SEVERAL_BATCHES), device="cpu")
    df = s.from_numpy(left).join(s.from_numpy(right),
                                 PL.col("k") == PL.col("k2"), how)
    nulls = 0
    for batch in df.physical_plan().execute(ExecContext(s.conf, s.device)):
        for c in batch.columns:
            dead = ~c.valid & batch.sel
            nulls += int(dead.sum())
            assert not c.data[dead].any()
            if c.dtype.is_string:
                assert not c.lengths[dead].any()
    assert nulls > 0
