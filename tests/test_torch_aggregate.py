"""The port's grouping, segmented reductions, sort order and aggregate
update against the JAX package, on the CPU, from the same seeded numpy
inputs.  The JAX side runs its default (XLA) reducers, as its own tests
do; the port runs its kernels' plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import ColumnarBatch as JBatch
from spark_rapids_tpu.exec import aggregate as JA
from spark_rapids_tpu.exec import sort as JS
from spark_rapids_tpu.ops import pallas_kernels as PK
from spark_rapids_tpu.ops import expressions as JE
from spark_rapids_tpu.types import (DoubleType as JDouble,
                                    IntegerType as JInt, LongType as JLong,
                                    Schema as JSchema, StringType as JString,
                                    StructField as JField)
from spark_rapids_tpu_torch.columnar import batch_from_numpy
from spark_rapids_tpu_torch.exec import aggregate as A
from spark_rapids_tpu_torch.exec import sort as S
from spark_rapids_tpu_torch.exec.base import ExecContext, ExecNode
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops.aggregates import AggregateExpression
from spark_rapids_tpu_torch.types import (DoubleType, IntegerType, LongType,
                                          Schema, StringType, StructField)

_PAIRS = [(JLong, LongType), (JInt, IntegerType), (JDouble, DoubleType),
          (JString, StringType)]
_PORT_TYPE = {j.name: t for j, t in _PAIRS}


def _port_leaves(jb: JBatch):
    """The JAX batch's leaves, sel mask and schema as batch_from_numpy
    takes them."""
    schema = Schema([StructField(f.name, _PORT_TYPE[f.dtype.name])
                     for f in jb.schema])
    leaves = [tuple(np.asarray(x) for x in
                    ((c.data, c.valid, c.lengths) if c.dtype.is_string
                     else (c.data, c.valid))) for c in jb.columns]
    return leaves, np.asarray(jb.sel), schema


def _port_batch(jb: JBatch) -> "batch_from_numpy":
    """The port's batch holding the JAX batch's leaves, unchanged."""
    return batch_from_numpy(*_port_leaves(jb), device="cpu")


def _mixed_batch(seed: int, cap: int = 2048, ngroups: int = 40):
    """A JAX batch with long/int/double/string columns: few distinct
    values (so groups repeat), nulls, NaN, -0.0, and dead rows."""
    rng = np.random.RandomState(seed)
    n = cap - cap // 8
    lng = rng.randint(0, ngroups, n).astype(np.int64)
    i32 = rng.randint(-3, 3, n).astype(np.int32)
    dbl = rng.choice([0.0, -0.0, 1.5, np.nan, -2.25, 7.0], n)
    words = [None if rng.rand() < 0.05 else ["R", "N", "A", "abcdefghij"][
        rng.randint(0, 4)] for _ in range(n)]
    valid = rng.rand(4, n) > 0.07
    cols = [JColumn.from_numpy(lng, valid[0], JLong, capacity=cap),
            JColumn.from_numpy(i32, valid[1], JInt, capacity=cap),
            JColumn.from_numpy(dbl, valid[2], JDouble, capacity=cap),
            JColumn.from_strings(words + [None] * (cap - n), capacity=cap)]
    sel = np.zeros(cap, bool)
    sel[:n] = rng.rand(n) > 0.1
    schema = JSchema([JField("l", JLong), JField("i", JInt),
                      JField("d", JDouble), JField("s", JString)])
    return JBatch(cols, jnp.asarray(sel), schema)


@pytest.mark.parametrize("keys", [[0], [3], [0, 3], [1, 2, 3]])
def test_group_rows_identical(keys):
    jb = _mixed_batch(5)
    pb = _port_batch(jb)
    j_order, j_gid, j_bound, j_n = JA.group_rows(
        [jb.columns[k] for k in keys], jb.sel)
    p_order, p_gid, p_bound, p_n = A.group_rows(
        [pb.columns[k] for k in keys], pb.sel)
    assert np.array_equal(p_order.numpy(), np.asarray(j_order))
    assert int(p_n) == int(j_n)
    assert np.array_equal(p_bound.numpy(), np.asarray(j_bound))
    live = np.asarray(jb.sel)[np.asarray(j_order)]
    assert np.array_equal(p_gid.numpy()[live], np.asarray(j_gid)[live])


def test_seg_multi_matches_jax_reducers():
    """Every request kind of the dispatcher: int sums and counts (K2's
    prefix difference), float sums and min/max (K1), masked rows."""
    rng = np.random.RandomState(5)
    cap = 2048
    gid = np.sort(rng.randint(0, 40, cap)).astype(np.int32)
    ivals = rng.randint(-100, 100, cap).astype(np.int64)
    fvals = rng.randn(cap) * 1e3
    contribute = rng.rand(cap) < 0.8
    ones = np.ones(cap, bool)

    def reqs(asarray, f64):
        return [("sum", asarray(ivals), asarray(contribute), 0),
                ("sum", asarray(contribute.astype(np.int64)), asarray(ones),
                 0, True),
                ("sum", asarray(fvals), asarray(contribute), 0),
                ("min", asarray(ivals), asarray(contribute), 2**63 - 1),
                ("max", asarray(fvals), asarray(contribute), f64(-np.inf))]
    want = JA._seg_multi(reqs(jnp.asarray, jnp.float64), jnp.asarray(gid),
                         cap)
    got = A._seg_multi(reqs(torch.from_numpy, float), torch.from_numpy(gid),
                       cap)
    segs = np.unique(gid)
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w)[segs], g.numpy()[segs]
        assert g.dtype == w.dtype, i
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-9)
        else:
            assert np.array_equal(g, w), i


def _float_min_requests(seed: int, cap: int):
    """_minmax's request set for a float Min, as numpy leaves: has-NaN
    (int32 max), the valid count and the non-NaN count (int sums), and
    the min over non-NaN values (float64); long runs and NaN included."""
    rng = np.random.RandomState(seed)
    gid = np.concatenate([np.sort(rng.randint(0, 20, cap // 4)),
                          np.full(cap // 2, 20),
                          np.sort(rng.randint(21, 200, cap // 4))])
    v = rng.randn(cap) * 1e3
    v[rng.rand(cap) < 0.05] = np.nan
    contribute = rng.rand(cap) < 0.8
    isnan = np.isnan(v)
    ones = np.ones(cap, bool)
    leaves = [("max", (contribute & isnan).astype(np.int32), ones, 0),
              ("sum", contribute.astype(np.int64), ones, 0, True),
              ("sum", (contribute & ~isnan).astype(np.int32), ones, 0, True),
              ("min", np.where(isnan, np.inf, v), contribute, np.inf)]
    return gid.astype(np.int32), leaves


def test_seg_multi_float_min_set_matches_jax_fused_interpret(monkeypatch):
    """The port's _seg_multi on _minmax's float-Min request set against
    the JAX _seg_multi with its fused seg_agg_1d path in interpret mode
    (its test hook), which takes every request of the set in one pass."""
    cap = 4096
    gid, leaves = _float_min_requests(9, cap)
    monkeypatch.setattr(JA, "_PALLAS_SEG_INTERPRET", [True])
    passes = []
    fused = PK.seg_agg_1d

    def counted(*args, **kw):
        passes.append(kw.get("interpret"))
        return fused(*args, **kw)

    monkeypatch.setattr(PK, "seg_agg_1d", counted)
    want = JA._seg_multi(
        [(r[0], jnp.asarray(r[1]), jnp.asarray(r[2]),
          jnp.float64(r[3]) if r[0] == "min" else r[3], *r[4:])
         for r in leaves], jnp.asarray(gid), cap)
    got = A._seg_multi(
        [(r[0], torch.from_numpy(r[1]), torch.from_numpy(r[2]), *r[3:])
         for r in leaves], torch.from_numpy(gid), cap)
    assert passes == [True]  # one interpreted pass, no XLA fallback
    segs = np.unique(gid)
    assert np.asarray(want[0])[segs].any()  # some group holds a NaN
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w)[segs], g.numpy()[segs]
        assert g.dtype == w.dtype, i
        assert np.array_equal(g, w), i


@pytest.mark.parametrize("case,k1", [
    ("float_min", [(torch.int32, "max"), (torch.float64, "min")]),
    ("float_max", [(torch.int32, "max"), (torch.float64, "max")]),
    ("long_min", [(torch.int64, "min")]),
    ("double_sum", [(torch.float64, "sum")]),
    ("count", []),
])
def test_seg_multi_makes_one_seg_scan_call(monkeypatch, case, k1):
    """One _seg_multi call makes exactly one K.seg_scan call, carrying
    every K1 request (float sums, every min and max) and no other, and
    its results equal the same requests made one per call."""
    cap = 2048
    gid, leaves = _float_min_requests(4, cap)
    gid = torch.from_numpy(gid)
    v = torch.from_numpy(leaves[3][1].copy())
    v[torch.isinf(v)] = float("nan")
    contribute = torch.from_numpy(leaves[3][2])
    ones = torch.ones(cap, dtype=torch.bool)

    def run():
        if case in ("float_min", "float_max", "long_min"):
            f = "Max" if case == "float_max" else "Min"
            dt = LongType if case == "long_min" else DoubleType
            vals = v.nan_to_num().long() if case == "long_min" else v
            col = A._minmax(f, dt, vals, gid, contribute, cap)
            return [col.data, col.valid]
        if case == "double_sum":
            return A._seg_multi([("sum", v.nan_to_num(), contribute, 0),
                                 ("sum", contribute.long(), ones, 0, True)],
                                gid, cap)
        return A._seg_multi([("sum", contribute.long(), ones, 0, True)],
                            gid, cap)

    calls = []
    real = K.seg_scan

    def spy(g, vals, ops):
        calls.append([(x.dtype, op) for x, op in zip(vals, ops)])
        return real(g, vals, ops)

    monkeypatch.setattr(K, "seg_scan", spy)
    got = run()
    assert calls == ([k1] if k1 else [])

    # the same requests, one K.seg_scan call each
    monkeypatch.setattr(K, "seg_scan", lambda g, vals, ops: [
        real(g, [x], [op])[0] for x, op in zip(vals, ops)])
    for a, b in zip(got, run()):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("spec", [
    [(0, True, True)],
    [(2, False, False)],
    [(3, True, False), (2, True, True)],
    [(1, False, True), (3, False, False), (0, True, True)],
])
def test_sort_order_identical(spec, packed):
    """Ints, doubles with NaN/-0.0, strings, nulls first/last, both
    directions, dead rows last: the same permutation as the JAX sort."""
    jb = _mixed_batch(8)
    pb = _port_batch(jb)
    cols, asc, nf = zip(*spec)
    jexprs = [JE.BoundReference(c, jb.schema[c].dtype) for c in cols]
    pexprs = [E.BoundReference(c, pb.schema[c].dtype) for c in cols]
    want = np.asarray(JS.sort_order(jb, jexprs, asc, nf))
    got = S.sort_order(pb, pexprs, asc, nf, packed=packed).numpy()
    assert np.array_equal(got, want)


def _port_flagship():
    """exec of __graft_entry__._flagship_agg on the port: group by k:
    sum(v), count(*), min(v), avg(q)."""
    k = E.BoundReference(0, LongType, "k")
    v = E.BoundReference(1, DoubleType, "v")
    q = E.BoundReference(2, LongType, "q")
    aggs = [AggregateExpression("Sum", v, output_name="sum_v"),
            AggregateExpression("Count", None, output_name="cnt"),
            AggregateExpression("Min", v, output_name="min_v"),
            AggregateExpression("Average", q, output_name="avg_q")]
    return A.TpuHashAggregateExec([k], ["k"], aggs, ExecNode())


def test_graft_entry_step_matches():
    """__graft_entry__.entry(): filter(v > 0) then the sort-based update
    over 4096 rows and 128 groups, the state fed in through
    batch_from_numpy."""
    step, (jbatch,) = graft.entry()
    want = step(jbatch)
    pb = _port_batch(jbatch)
    v = pb.columns[1]
    pre = pb.filter(v.valid & (v.data > 0.0))
    got = _port_flagship()._update_kernel(pre)
    assert np.array_equal(got.sel.numpy(), np.asarray(want.sel))
    live = np.asarray(want.sel)
    assert live.sum() == 128
    for i, (wc, gc) in enumerate(zip(want.columns, got.columns)):
        wv, gv = np.asarray(wc.valid)[live], gc.valid.numpy()[live]
        assert np.array_equal(gv, wv), i
        wd, gd = np.asarray(wc.data)[live], gc.data.numpy()[live]
        if np.issubdtype(wd.dtype, np.floating):
            # sums: same terms in another order
            np.testing.assert_allclose(gd, wd, rtol=1e-12)
        else:
            assert np.array_equal(gd, wd), i


def test_update_merge_finalize_matches_across_batches():
    """Two batches' partial states merged and finalized (the fan-in
    merge path) against the JAX exec's kernels on the same states."""
    jagg = graft._flagship_agg()
    pagg = _port_flagship()
    parts_j, parts_p = [], []
    for seed in (1, 2):
        jb, _, _ = graft._example_batch(cap=2048, n_groups=300, seed=seed)
        parts_j.append(jagg._update_kernel(jb))
        parts_p.append(pagg._update_kernel(_port_batch(jb)))
    from spark_rapids_tpu.columnar import concat_batches as jconcat
    from spark_rapids_tpu_torch.columnar import concat_batches
    want = jagg._finalize_kernel(jagg._merge_kernel(jconcat(parts_j)))
    got = pagg._finalize_kernel(pagg._merge_kernel(concat_batches(parts_p)))
    live = np.asarray(want.sel)
    assert np.array_equal(got.sel.numpy(), live) and live.sum() == 300
    for wc, gc in zip(want.columns, got.columns):
        wd, gd = np.asarray(wc.data)[live], gc.data.numpy()[live]
        np.testing.assert_allclose(gd, wd, rtol=1e-12)


def test_batch_and_exec_context_run_on_the_card_unless_asked(monkeypatch):
    """batch_from_numpy defaults to the card and, like TpuSession, raises
    without one unless device="cpu" is passed; ExecContext has no default
    device at all."""
    from spark_rapids_tpu_torch import TpuSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _port_leaves(_mixed_batch(8, cap=64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_from_numpy(*args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TpuSession()
    pb = batch_from_numpy(*args, device="cpu")
    assert pb.sel.device.type == "cpu"
    with pytest.raises(TypeError):
        ExecContext(None)
    assert ExecContext(None, torch.device("cpu")).device.type == "cpu"
