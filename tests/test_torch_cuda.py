"""The port's CUDA kernels against their plain PyTorch versions, and its
queries and expressions against the same on the CPU, on the card.
Every test here needs an NVIDIA card (marker `cuda`) and skips
without one.  Run them on a machine with a card, where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import os
import re

import numpy as np
import pytest
import torch

import test_torch_arithmetic as XA
import test_torch_cast_text as XT
import test_torch_datetime as XD
import test_torch_expressions as X
import test_torch_hash as XH
import test_torch_math as XM
import test_torch_strings as XS
import test_torch_window as XW
from spark_rapids_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _seg_tile_rows():
    """K1's rows a tile, SS_THREADS * SS_ITEMS of csrc/seg_scan.cu."""
    with open(os.path.join(K.CSRC, os.path.basename(K.seg_scan.source))) as f:
        src = f.read()
    d = {m.group(1): int(m.group(2)) for m in
         re.finditer(r"^#define (SS_THREADS|SS_ITEMS) (\d+)$", src, re.M)}
    return d["SS_THREADS"] * d["SS_ITEMS"]


def _same(a, b):
    """Equal values, NaN equal to NaN."""
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        both = torch.isnan(a) & torch.isnan(b)
        return bool(torch.all(both | (a == b)))
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 1000, 1023, 1024, 4097, 5000, 1 << 20,
                               (1 << 20) + 7])
def test_cumsum_matches_plain_and_wraps(dev, dtype, n):
    rng = np.random.default_rng(n)
    info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
    v = torch.from_numpy(rng.integers(info.max // 4, info.max, n,
                                      dtype=info.dtype)).to(dev)
    got = K.cumsum(v)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.cumsum_plain(v.cpu()))


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cumsum_of_a_view_off_the_vector_boundary(dev, dtype, offset):
    """A column that starts off a 16-byte boundary takes the row-by-row
    path in every tile."""
    v = torch.arange((1 << 20) + 7, dtype=dtype, device=dev)[offset:]
    assert v.data_ptr() % 16 != 0
    got = K.cumsum(v)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.cumsum_plain(v.cpu()))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cumsum_twice_on_one_stream(dev, dtype):
    """Two launches queued back to back: the second must find its tile
    counter and flags reset."""
    n = (1 << 20) + 7
    v = torch.arange(n, dtype=dtype, device=dev) % 1000 - 300
    a = K.cumsum(v)
    b = K.cumsum(v.flip(0).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(a.cpu(), K.cumsum_plain(v.cpu()))
    assert torch.equal(b.cpu(), K.cumsum_plain(v.flip(0).cpu()))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64,
                                   torch.float32, torch.float64])
@pytest.mark.parametrize("n,groups", [(1, 1), (3000, 4), (1 << 16, 5000),
                                      (1 << 20, 3), (1 << 20, 300000)])
def test_seg_scan_matches_plain(dev, op, dtype, n, groups):
    rng = np.random.default_rng(n + groups)
    gid = torch.from_numpy(np.sort(rng.integers(0, groups, n))
                           .astype(np.int32))
    if dtype.is_floating_point:
        v = torch.from_numpy(rng.standard_normal(n)).to(dtype)
        v[torch.from_numpy(rng.random(n) < 0.01)] = float("nan")
    else:
        v = torch.from_numpy(rng.integers(-1000, 1000, n)).to(dtype)
    got = K.seg_scan(gid.to(dev), [v.to(dev)], [op])
    torch.cuda.synchronize()
    _check_scan(got, K.seg_scan_plain(gid, [v], [op]), [op])


def _check_scan(got, want, ops):
    """Each column as its plain version: exactly, except float sums (same
    terms, another order; NaN rows stay NaN in both)."""
    assert len(got) == len(want) == len(ops)
    for g, w, op in zip(got, want, ops):
        g, w = g.cpu(), w.cpu()
        assert g.dtype == w.dtype
        if op == "sum" and w.dtype.is_floating_point:
            tol = 1e-4 if w.dtype == torch.float32 else 1e-12
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            ok = ~torch.isnan(w)
            torch.testing.assert_close(g[ok], w[ok], rtol=tol, atol=tol)
        else:
            assert _same(g, w)


_COLUMNS = [(torch.int32, "max"), (torch.float64, "min"),
            (torch.float32, "sum"), (torch.int64, "sum"),
            (torch.float64, "sum"), (torch.int32, "min"),
            (torch.int64, "max"), (torch.float32, "max")]


def _columns(rng, n, spec, dev, nan_p=0.01):
    """One column per (dtype, op): floats with NaN at `nan_p` (positive
    for a sum, so a relative tolerance holds along a long run), integers
    large enough that int sums wrap."""
    cols = []
    for dtype, op in spec:
        if dtype.is_floating_point:
            x = rng.random(n) + 0.5 if op == "sum" \
                else rng.standard_normal(n)
            v = torch.from_numpy(x).to(dtype)
            v[torch.from_numpy(rng.random(n) < nan_p)] = float("nan")
        else:
            info = torch.iinfo(dtype)
            v = torch.from_numpy(rng.integers(info.min // 2, info.max // 2,
                                              n)).to(dtype)
        cols.append(v.to(dev))
    return cols


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n,groups", [(1, 1), (5119, 3), (5121, 900),
                                      (1 << 20, 4), ((1 << 20) + 7, 260000)])
def test_seg_scan_mixed_columns_match_plain(dev, k, n, groups):
    """k columns of mixed dtypes and ops in one launch (int32 beside
    float64: different rows a 16-byte vector), ragged last tiles."""
    rng = np.random.default_rng(n * 10 + k)
    gid = torch.from_numpy(np.sort(rng.integers(0, groups, n))
                           .astype(np.int32)).to(dev)
    spec = _COLUMNS[:k]
    # NaN only where runs are short: it fills the rest of its run
    cols = _columns(rng, n, spec, dev, 0.01 if n // groups < 1000 else 0.0)
    ops = [op for _, op in spec]
    got = K.seg_scan(gid, cols, ops)
    torch.cuda.synchronize()
    _check_scan(got, K.seg_scan_plain(gid, cols, ops), ops)


def test_seg_scan_max_columns_and_one_over(dev):
    n = 100_003
    rng = np.random.default_rng(8)
    gid = torch.from_numpy(np.sort(rng.integers(0, 5000, n))
                           .astype(np.int32)).to(dev)
    spec = _COLUMNS[:K.SEG_MAX_COLUMNS]
    cols = _columns(rng, n, spec, dev)
    ops = [op for _, op in spec]
    got = K.seg_scan(gid, cols, ops)
    torch.cuda.synchronize()
    _check_scan(got, K.seg_scan_plain(gid, cols, ops), ops)
    with pytest.raises(ValueError):
        K.seg_scan(gid, cols + cols[:1], ops + ops[:1])


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_seg_scan_one_run_spans_every_tile(dev, op):
    """One gid for all 2^20 + 7 rows: every tile's look-back walks the
    aggregates back to an inclusive prefix, in one pass."""
    n = (1 << 20) + 7
    rng = np.random.default_rng(3)
    gid = torch.full((n,), 7, dtype=torch.int32, device=dev)
    spec = [(torch.float64, op), (torch.int64, op), (torch.int32, op)]
    cols = _columns(rng, n, spec, dev, nan_p=0.0)
    got = K.seg_scan(gid, cols, [op] * 3)
    torch.cuda.synchronize()
    _check_scan(got, K.seg_scan_plain(gid, cols, [op] * 3), [op] * 3)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_seg_scan_nan_in_a_leading_run(dev, op):
    """Runs that cross tile boundaries with NaN on either side of the
    boundary: in the run's rows of the tile before (carried through the
    look-back into the next tile), and in the leading run of the tile
    after.  Runs are 3000 rows; the tile is read from csrc/seg_scan.cu."""
    tile = _seg_tile_rows()
    assert 3000 < tile < 6000  # the positions below assume it
    n = tile * 6 + 11
    gid = torch.arange(n, device=dev, dtype=torch.int32) // 3000
    v = (torch.arange(n, dtype=torch.float64, device=dev) * 7919) \
        % 1000 / 100 + 1
    v[tile - 7] = float("nan")  # tile 0's part of gid 1, which crosses
    v[2 * tile + 3] = float("nan")  # tile 2's leading run (gid 2)
    v[4 * tile + 1] = float("nan")  # tile 4's leading run (gid 5)
    assert int(gid[tile - 7]) == int(gid[tile]) == 1
    assert int(gid[2 * tile + 3]) == int(gid[2 * tile - 1]) == 2
    assert int(gid[4 * tile + 1]) == int(gid[4 * tile - 1]) == 5
    got = K.seg_scan(gid, [v, v.float()], [op, op])
    torch.cuda.synchronize()
    _check_scan(got, K.seg_scan_plain(gid, [v, v.float()], [op, op]),
                [op, op])


def test_seg_scan_off_the_vector_boundary(dev):
    """Columns that start off a 16-byte boundary take the row-by-row
    path in every tile; gid and the other column stay aligned."""
    n = (1 << 18) + 5
    rng = np.random.default_rng(4)
    gid = torch.from_numpy(np.sort(rng.integers(0, 9000, n))
                           .astype(np.int32)).to(dev)
    a = torch.arange(n + 1, dtype=torch.int32, device=dev)[1:]
    b = torch.randn(n + 1, dtype=torch.float64, device=dev)[1:]
    c = torch.randn(n, dtype=torch.float64, device=dev)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    ops = ["sum", "max", "sum"]
    got = K.seg_scan(gid, [a, b, c], ops)
    torch.cuda.synchronize()
    _check_scan(got, K.seg_scan_plain(gid, [a, b, c], ops), ops)


def test_seg_scan_twice_on_one_stream(dev):
    """Two launches queued back to back on other inputs and another k:
    the second must find its tile counter and flags reset."""
    n = (1 << 20) + 7
    rng = np.random.default_rng(5)
    g1 = torch.from_numpy(np.sort(rng.integers(0, 4, n))
                          .astype(np.int32)).to(dev)
    g2 = torch.from_numpy(np.sort(rng.integers(0, n // 4, n))
                          .astype(np.int32)).to(dev)
    c1 = _columns(rng, n, _COLUMNS[:2], dev, nan_p=0.0)
    c2 = _columns(rng, n, _COLUMNS[2:5], dev)
    o1, o2 = [op for _, op in _COLUMNS[:2]], [op for _, op in _COLUMNS[2:5]]
    a = K.seg_scan(g1, c1, o1)
    b = K.seg_scan(g2, c2, o2)
    torch.cuda.synchronize()
    _check_scan(a, K.seg_scan_plain(g1, c1, o1), o1)
    _check_scan(b, K.seg_scan_plain(g2, c2, o2), o2)


def test_seg_scan_counts_one_launch_per_call(dev):
    K.reset_launches()
    gid = torch.zeros(10_000, dtype=torch.int32, device=dev)
    for k in (1, 3, K.SEG_MAX_COLUMNS):
        cols = [torch.ones(10_000, device=dev, dtype=torch.float64)] * k
        K.seg_scan(gid, cols, ["sum"] * k)
    torch.cuda.synchronize()
    assert K.seg_scan.launches == 3
    assert K.seg_scan.shapes == {
        (10_000, ((torch.float64, "sum"),) * k): 1
        for k in (1, 3, K.SEG_MAX_COLUMNS)}


@pytest.mark.parametrize("n", [1, 2, 1024, 4096, 8192, 1 << 16, 1 << 20])
def test_sort_words_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                      dtype=np.int64, endpoint=True))
    got = K.sort_words(w.to(dev)).cpu()
    assert torch.equal(got, K.sort_words_plain(w))


def _packed_words(n, cw, keys, gen, dev):
    """(key << r) | row id with `cw`-bit keys, r = log2(n), as the packed
    argsort builds its words: random keys, one key for every word (one
    digit bucket a pass), or keys reaching bit 63."""
    r = n.bit_length() - 1
    if keys == "one_bucket":
        key = torch.full((n,), (1 << cw) - 3, dtype=torch.int64, device=dev)
    else:
        key = torch.randint(-(1 << 63), (1 << 63) - 1, (n,),
                            dtype=torch.int64, device=dev, generator=gen)
        if cw < 64:
            key &= (1 << cw) - 1
    return (key << r) | torch.arange(n, dtype=torch.int64, device=dev)


@pytest.mark.parametrize("case", [
    ("full", "random"), ("to64", "random"), ("to64", "top_bit"),
    ("to64", "one_bucket"), ("r14", "random"), ("r14", "one_bucket")],
    ids="-".join)
@pytest.mark.parametrize("n", [1 << 13, 1 << 20, 1 << 24])
def test_sort_words_bits_matches_plain(dev, n, case):
    """The radix route at bits (0, 64) on arbitrary words, and at (r, 64)
    and (r, r + 14) on the packed argsort's words, exactly as the plain
    version's full sort."""
    span, keys = case
    gen = torch.Generator(device=dev).manual_seed(n + len(span + keys))
    r = n.bit_length() - 1
    if span == "full":
        w = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), dtype=torch.int64,
                          device=dev, generator=gen)
        w[::5] = w[0]
        bits = (0, 64)
    else:
        bits = (r, 64) if span == "to64" else (r, r + 14)
        w = _packed_words(n, bits[1] - r, keys, gen, dev)
    if keys == "top_bit":
        assert bool((w < 0).any())
    before = w.clone()
    got = K.sort_words(w, bits)
    torch.cuda.synchronize()
    assert torch.equal(got, K.sort_words_plain(w))
    assert torch.equal(w, before)  # the input is left untouched


def test_sort_words_rejects_non_power_of_two(dev):
    with pytest.raises(ValueError):
        K.sort_words(torch.zeros(3000, dtype=torch.int64, device=dev))


def test_launch_counters_count_launches(dev):
    K.reset_launches()
    x = torch.arange(4096, dtype=torch.int64, device=dev)
    K.cumsum(x)
    K.sort_words(x)
    K.seg_scan(torch.zeros(4096, dtype=torch.int32, device=dev), [x],
               ["max"])
    K.cumsum(x.cpu())  # the plain version launches nothing
    assert K.launch_counts() == {"seg_scan": 1, "cumsum": 1,
                                 "sort_words": 1}
    assert K.seg_scan.shapes == {(4096, ((torch.int64, "max"),)): 1}
    assert K.cumsum.shapes == {(4096, torch.int64): 1}
    assert K.sort_words.shapes == {(4096, torch.int64, 0, 64): 1}


def test_queries_on_card_match_cpu(dev):
    """q1, q6 and q18's aggregate on the card against the same session
    on the CPU (the kernels against their plain versions, end to end),
    over several batches so the fan-in merge runs too."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate_lineitem(0.02)
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "true",
            "spark.rapids.sql.reader.batchSizeRows": "20000",
            "spark.rapids.sql.tpu.agg.mergeFanIn": "2"}
    out = {}
    for device in ("cpu", dev):
        li = TpuSession(conf, device=device).from_numpy(t, tpch.LINEITEM)
        out[str(device)] = [tpch.q1(li).collect(), tpch.q6(li).collect(),
                            tpch.q18_inner(li, 200).collect()]
    for want, got in zip(out["cpu"], out[str(dev)]):
        assert len(got) > 0
        assert tpch.rows_match(want, got)


def test_grouped_min_max_nulls_nan_on_card_match_cpu(dev):
    from spark_rapids_tpu_torch import TpuSession, col, functions as F
    rng = np.random.default_rng(9)
    n = 50_000
    v = rng.choice([0.0, -0.0, 1.5, np.nan, -2.25, np.inf], n)
    data = {"k": rng.integers(0, 3000, n),
            "s": np.array(["a", "bb", "ccc", ""])[rng.integers(0, 4, n)],
            "v": np.ma.masked_array(v, mask=rng.random(n) < 0.1),
            "i": rng.integers(-50, 50, n).astype(np.int32)}

    def q(device):
        df = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled":
                         "true"}, device=device).from_numpy(data)
        return (df.group_by(col("k"), col("s"))
                .agg(F.min(col("v")).alias("mn"), F.max(col("v")).alias("mx"),
                     F.sum(col("i")).alias("si"), F.avg(col("v")).alias("av"),
                     F.count(col("v")).alias("c"))
                .order_by("k", "s").collect())
    want, got = q("cpu"), q(dev)
    assert len(want) == len(got) > 3000

    def norm(rows):
        return [tuple("NaN" if isinstance(x, float) and x != x else x
                      for x in r) for r in rows]
    want, got = norm(want), norm(got)
    for w, g in zip(want, got):
        assert w[:5] == g[:5] and w[6] == g[6], (w, g)
        assert w[5] == g[5] or abs(w[5] - g[5]) <= 1e-12 * abs(w[5]), (w, g)


_HASH_JOINS = {"spark.sql.autoBroadcastJoinThreshold": "-1",
               "spark.rapids.sql.tpu.join.partitioned.enabled": "false"}


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
def test_join_queries_on_card_match_cpu(dev, plan):
    """q3, q4 and q18 (inner and semi joins, limits) on the card against
    the same session on the CPU, streaming several probe batches."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate(0.02)
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "true",
            "spark.rapids.sql.reader.batchSizeRows": "30000",
            **(_HASH_JOINS if plan == "hash_joins" else {})}
    out = {}
    for device in ("cpu", dev):
        s = TpuSession(conf, device=device)
        d = {n: s.from_numpy(v, tpch.SCHEMAS[n]) for n, v in t.items()}
        out[str(device)] = [tpch.q3(d).collect(), tpch.q4(d).collect(),
                            tpch.q18(d, 250).collect()]
    for want, got in zip(out["cpu"], out[str(dev)]):
        assert len(got) > 0
        assert tpch.rows_match(want, got)


def test_join_semi_anti_and_limit_on_card_match_cpu(dev):
    """String and double keys with nulls, NaN and -0.0, a residual
    condition, and a limit over several batches, on the card and on the
    CPU: the same rows in the same order."""
    from spark_rapids_tpu_torch import TpuSession, col
    n = 20_000

    def table(seed, key):
        r = np.random.default_rng(seed)
        return {key: np.ma.masked_array(
                    r.choice([0.0, -0.0, 1.5, np.nan, 2.0, 3.0], n),
                    mask=r.random(n) < 0.05),
                key + "s": np.array(["a", "bb", "", "ccc"])[
                    r.integers(0, 4, n)],
                key + "v": r.integers(0, 100, n)}
    left, right = table(1, "k"), table(2, "j")
    rows = {}
    for device in ("cpu", dev):
        s = TpuSession({"spark.sql.autoBroadcastJoinThreshold": "-1",
                        "spark.rapids.sql.reader.batchSizeRows": "7000"},
                       device=device)
        lt, rt = s.from_numpy(left), s.from_numpy(right)
        on = (col("k") == col("j")) & (col("ks") == col("js"))
        cond = on & (col("kv") < col("jv"))
        rows[str(device)] = [
            lt.join(rt, on).limit(50_000).collect(),
            lt.join(rt, cond, "left_semi").collect(),
            lt.join(rt, cond, "left_anti").collect(),
            lt.filter(col("kv") > 50).limit(9000).collect()]
    for want, got in zip(rows["cpu"], rows[str(dev)]):
        assert len(got) > 0
        assert [tuple("NaN" if x != x else x for x in r) for r in want] == \
            [tuple("NaN" if x != x else x for x in r) for r in got]


@pytest.mark.parametrize("packed", ["true", "false"])
def test_join_build_of_a_non_power_of_two_size(dev, packed):
    """A build side of 3000 rows sits in a 4096-row batch: the packed
    route sorts it with K3 over the hash's two passes at that capacity,
    and the join counts both launches as its build's; with the packed
    sort off it takes the stable argsort and launches no K3.  Either way
    the rows equal the CPU's."""
    from spark_rapids_tpu_torch import TpuSession, col
    r = np.random.default_rng(5)
    left = {"k": r.integers(0, 2000, 10_000), "a": r.random(10_000)}
    right = {"j": r.integers(0, 2000, 3000), "b": r.integers(0, 9, 3000)}
    rows = {}
    for device in ("cpu", dev):
        s = TpuSession({"spark.sql.autoBroadcastJoinThreshold": "-1",
                        "spark.rapids.sql.tpu.sort.packed.enabled": packed},
                       device=device)
        K.reset_launches()
        rows[str(device)] = s.from_numpy(left).join(
            s.from_numpy(right), col("k") == col("j")).collect()
    assert len(rows["cpu"]) > 1000
    assert rows["cpu"] == rows[str(dev)]
    from spark_rapids_tpu_torch.exec.join import TpuHashJoinExec
    nodes, joins = [s.last_plan], []
    while nodes:
        n = nodes.pop()
        nodes += n.children
        joins += [n] if isinstance(n, TpuHashJoinExec) else []
    (join,) = joins
    if packed == "true":
        assert {(4096, torch.int64, 12, 64),
                (4096, torch.int64, 12, 24)} <= K.sort_words.shapes.keys()
        assert join.build_sorts == 2
    else:
        assert K.sort_words.launches == 0
        assert join.build_sorts == 0


@pytest.mark.parametrize("case", list(X.CASES))
def test_null_and_conditional_expressions_on_card_match_cpu(dev, case):
    """Each null, NaN and conditional expression of
    tests/test_torch_expressions.py, on the same seeded table, on the
    card and on the CPU: the same types, null masks and values (exact,
    NaN equal to NaN)."""
    from spark_rapids_tpu_torch import TpuSession
    data = X.table()
    out = {}
    for device in ("cpu", dev):
        df = X.port_df(TpuSession(device=device), data)
        out[str(device)] = X.port_columns(X.query(df, X.PORT, case))
    (want_types, want), (got_types, got) = out["cpu"], out[str(dev)]
    assert got_types == want_types
    assert len(got) == len(want) > 0
    for k, ((wv, wok), (gv, gok)) in enumerate(zip(want, got)):
        assert np.array_equal(wok, gok), k
        assert X.same_values(wv, gv, wok), k


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
def test_q12_on_card_matches_cpu(dev, plan):
    """TPC-H q12 (In, CaseWhen, an inner join, a two-group aggregate) at
    SF0.01 on the card and on the CPU, over several probe batches."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate(0.01)
    conf = {"spark.rapids.sql.reader.batchSizeRows": "20000",
            **(_HASH_JOINS if plan == "hash_joins" else {})}
    out = {}
    for device in ("cpu", dev):
        s = TpuSession(conf, device=device)
        d = {n: s.from_numpy(v, tpch.SCHEMAS[n]) for n, v in t.items()}
        out[str(device)] = tpch.q12(d).collect()
    assert len(out["cpu"]) == 2
    assert out["cpu"] == out[str(dev)] == tpch.oracle_q12(t)


@pytest.mark.parametrize("case", list(XS.CASES))
def test_string_expressions_on_card_match_cpu(dev, case):
    """Each string predicate and Substring case of
    tests/test_torch_strings.py, on the same seeded table, on the card and
    on the CPU: the same null masks, booleans and bytes."""
    from spark_rapids_tpu_torch import TpuSession
    data = XS.table()
    out = {}
    for device in ("cpu", dev):
        df = XS.port_df(TpuSession(device=device), data)
        out[str(device)] = XS.port_rows(XS.query(df, XS.PORT, case))
    assert len(out["cpu"][0]) == XS.N
    assert out["cpu"] == out[str(dev)]


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
def test_q22_and_string_filters_on_card_match_cpu(dev, plan):
    """TPC-H q22 (Substring, In over strings, a collected average, a
    left_anti join) and the string filters over o_comment, at SF0.01
    with every 8th order, on the card and on the CPU."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate(0.01)
    t["orders"] = {k: v[::8] for k, v in t["orders"].items()}
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "true",
            **(_HASH_JOINS if plan == "hash_joins" else {})}
    out = {}
    for device in ("cpu", dev):
        s = TpuSession(conf, device=device)
        d = {n: s.from_numpy(v, tpch.SCHEMAS[n]) for n, v in t.items()}
        out[str(device)] = [tpch.q22(d).collect()] + [
            tpch.string_filter(d["orders"], name).collect()
            for name in tpch.STRING_FILTERS]
    assert len(out["cpu"][0]) == 7
    for want, got in zip(out["cpu"], out[str(dev)]):
        assert tpch.rows_match(want, got)


@pytest.mark.parametrize("how", ["left", "right", "full"])
def test_outer_joins_on_card_match_cpu(dev, how):
    """Left, right and full outer joins on double and string keys with
    nulls, NaN and -0.0, streaming several batches (a full join's tail
    after them), on the card and on the CPU: the same rows in the same
    order."""
    from spark_rapids_tpu_torch import TpuSession, col
    n = 20_000

    def table(seed, key, m):
        r = np.random.default_rng(seed)
        return {key: np.ma.masked_array(
                    r.choice([0.0, -0.0, 1.5, np.nan, 2.0, 3.0, 4.0], m),
                    mask=r.random(m) < 0.05),
                key + "s": np.array(["a", "bb", "", "ccc", "dddd"])[
                    r.integers(0, 5, m)],
                key + "v": r.integers(0, 100, m)}
    # the left side lacks key 4.0, so right rows go without a match too
    left, right = table(11, "k", n), table(12, "j", n // 50)
    left["k"] = np.ma.masked_array(np.where(left["k"].data == 4.0, 1.5,
                                            left["k"].data),
                                   mask=left["k"].mask)
    rows = {}
    for device in ("cpu", dev):
        s = TpuSession({"spark.sql.autoBroadcastJoinThreshold": "-1",
                        "spark.rapids.sql.reader.batchSizeRows": "7000"},
                       device=device)
        lt, rt = s.from_numpy(left), s.from_numpy(right)
        on = (col("k") == col("j")) & (col("ks") == col("js"))
        rows[str(device)] = lt.join(rt, on, how).collect()
    assert len(rows["cpu"]) > 1000
    norm = [[tuple("NaN" if x != x else x for x in r) for r in rows[d]]
            for d in ("cpu", str(dev))]
    assert norm[0] == norm[1]
    lone = [r for r in norm[0] if (r[3] is None if how == "left"
                                   else r[0] is None)]
    assert lone


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
def test_q13_and_outer_joins_on_card_match_cpu(dev, plan):
    """TPC-H q13 (a left outer join, CaseWhen over its nullable side, two
    aggregates) and tpch.OUTER_JOINS at SF0.01 with every 8th order, on
    the card and on the CPU, over several probe batches."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate(0.01)
    t["orders"] = {k: v[::8] for k, v in t["orders"].items()}
    conf = {"spark.rapids.sql.reader.batchSizeRows": "500",
            **(_HASH_JOINS if plan == "hash_joins" else {})}
    out = {}
    for device in ("cpu", dev):
        s = TpuSession(conf, device=device)
        d = {n: s.from_numpy(v, tpch.SCHEMAS[n]) for n, v in t.items()}
        out[str(device)] = [tpch.q13(d).collect()] + [
            q(d).collect() for q, _ in tpch.OUTER_JOINS.values()]
    assert out["cpu"][0] == tpch.oracle_q13(t)
    for want, got in zip(out["cpu"], out[str(dev)]):
        assert got and want == got


@pytest.mark.parametrize("case", list(XA.CASES))
def test_arithmetic_on_card_matches_cpu(dev, case):
    """Each arithmetic case of tests/test_torch_arithmetic.py (the edge
    rows: zero, NaN and infinite divisors, INT_MIN and -1) on the card
    and on the CPU: the same type and null mask, the same bits on every
    row (any NaN equal to any NaN)."""
    data = XA.table()
    want = XA.port_eval(data, case, "cpu")
    got = XA.port_eval(data, case, dev)
    assert got[0] == want[0]
    assert np.array_equal(got[2], want[2])
    assert XA.same_bits(got[1], want[1])


def _nan_rows(rows):
    """Rows in key order with NaN spelled "NaN", for tpch.rows_match."""
    return sorted((tuple("NaN" if x != x else x for x in r) for r in rows),
                  key=repr)


@pytest.mark.parametrize("case", XA.AGG_CASES)
def test_agg_over_aggregates_on_card_matches_cpu(dev, case):
    """agg entries over aggregates (the split into an aggregate and a
    projection), grouped and global, on the card and on the CPU: the same
    rows, floats within rel 1e-9 (sums taken in another order)."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    data = XA.table()
    out = {}
    for device in ("cpu", dev):
        df = XA.port_df(TpuSession(dict(XA.CONF), device=device), data)
        entries = XA._agg_entries(XA.PORT)[case]
        out[str(device)] = [_nan_rows(df.group_by("g").agg(*entries)
                                      .collect()),
                            _nan_rows(df.agg(*entries).collect())]
    for want, got in zip(out["cpu"], out[str(dev)]):
        assert len(got) == len(want) > 0
        assert tpch.rows_match(want, got), (want, got)


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
def test_q14_and_q17_on_card_match_cpu(dev, plan):
    """TPC-H q14 (a join to part, CaseWhen over StartsWith, a global
    aggregate divided by another) and q17 (a grouped average times a
    literal joined back, a second join) at SF0.01 on the card and on the
    CPU, over several probe batches, each equal to its numpy oracle."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate(0.01)
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "true",
            "spark.rapids.sql.reader.batchSizeRows": "20000",
            **(_HASH_JOINS if plan == "hash_joins" else {})}
    out = {}
    for device in ("cpu", dev):
        s = TpuSession(conf, device=device)
        d = {n: s.from_numpy(v, tpch.SCHEMAS[n]) for n, v in t.items()}
        out[str(device)] = [tpch.q14(d).collect(), tpch.q17(d).collect()]
    for name, want, got in zip(("q14", "q17"), out["cpu"], out[str(dev)]):
        assert got[0][0] is not None
        assert tpch.rows_match(want, got), name
        assert tpch.rows_match(tpch.ORACLES[name](t), got), name


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
def test_supplier_queries_on_card_match_cpu(dev, plan):
    """TPC-H q5 (six tables, a join on two keys), q10 (seven group keys,
    five of them strings, a top 20), q15 (a maximum collected mid-query),
    q19 (an OR of three conjunctions over a join to part) and q21 (a semi
    join, two levels of aggregates, two joins back) at SF0.03, where
    q19's filter keeps some lines, on the card and on the CPU, over
    several probe batches, each equal to its numpy oracle."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate(0.03)
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "true",
            "spark.rapids.sql.reader.batchSizeRows": "30000",
            **(_HASH_JOINS if plan == "hash_joins" else {})}
    names = ("q5", "q10", "q15", "q19", "q21")
    out = {}
    for device in ("cpu", dev):
        s = TpuSession(conf, device=device)
        d = {n: s.from_numpy(v, tpch.SCHEMAS[n]) for n, v in t.items()}
        out[str(device)] = [tpch.JOIN_QUERIES[n](d).collect() for n in names]
    for name, want, got in zip(names, out["cpu"], out[str(dev)]):
        oracle = tpch.ORACLES[name](t)
        assert got and got[0][0] is not None, name
        if name in tpch.TOP_N:  # rows that tie may trade places
            assert tpch.top_rows_match(oracle, want, *tpch.TOP_N[name])
            assert tpch.top_rows_match(oracle, got, *tpch.TOP_N[name])
        else:
            assert tpch.rows_match(want, got), name
            assert tpch.rows_match(oracle, got), name


@pytest.mark.parametrize("cls", XD.CLASSES)
def test_date_parts_on_card_match_cpu(dev, cls):
    """Each date part of tests/test_torch_datetime.py over each of its
    seeded columns (dates of 1600-2400, pre-epoch timestamps, int, long,
    double and boolean children, with nulls) on the card and on the CPU:
    the same values and null masks."""
    data = XD.table()
    for name in XD.TYPES:
        (want, want_ok), (got, got_ok) = (XD.port_part(cls, data, name, d)
                                          for d in ("cpu", dev))
        assert np.array_equal(got_ok, want_ok), name
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("plan", ["default", "hash_joins"])
def test_partsupp_queries_on_card_match_cpu(dev, plan):
    """TPC-H q2 (a per-part minimum joined back on two keys, a top 100),
    q7, q8 and q9 (Year of a date; q9's join to partsupp on two keys),
    q11 (a sum collected mid-query), q16 (a left_anti join, two levels of
    grouping by string keys) and q20 at both part-name prefixes (a
    two-key aggregate joined to partsupp on both keys) at SF0.03, where
    q20 keeps some CANADA suppliers, on the card and on the CPU, over
    several probe batches, each equal to its numpy oracle."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate(0.03)
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "true",
            "spark.rapids.sql.reader.batchSizeRows": "30000",
            **(_HASH_JOINS if plan == "hash_joins" else {})}
    cases = [("q2", ()), ("q7", ()), ("q8", ()), ("q9", ()), ("q11", ()),
             ("q16", ()), ("q20", ()), ("q20", ("",))]
    out = {}
    for device in ("cpu", dev):
        s = TpuSession(conf, device=device)
        d = {n: s.from_numpy(v, tpch.SCHEMAS[n]) for n, v in t.items()}
        out[str(device)] = [tpch.JOIN_QUERIES[n](d, *a).collect()
                            for n, a in cases]
    for (name, args), want, got in zip(cases, out["cpu"], out[str(dev)]):
        oracle = tpch.ORACLES[name](t, *args)
        assert got and got[0][0] is not None, name
        if name in tpch.TOP_N:  # rows that tie may trade places
            assert tpch.top_rows_match(oracle, want, *tpch.TOP_N[name])
            assert tpch.top_rows_match(oracle, got, *tpch.TOP_N[name])
        else:
            assert tpch.rows_match(want, got), name
            assert tpch.rows_match(oracle, got), name


@pytest.mark.parametrize("src,dst", XT.ROUTES,
                         ids=[f"{XT.TYPES[s]}-{d}" for s, d in XT.ROUTES])
def test_text_casts_on_card_match_cpu(dev, src, dst):
    """Each cast between text and numbers or booleans, and between
    numbers and booleans, over tests/test_torch_cast_text.py's seeded
    table (integer extremes, subnormal, NaN and +-0 doubles, text with
    malformed rows, nulls) on the card and on the CPU: the same bits,
    null masks and, for text, bytes and lengths."""
    data = XT.table()
    want, got = (XT.port_route(data, src, dst, d) for d in ("cpu", dev))
    parts = [(got.data, want.data), (got.valid, want.valid)]
    if want.lengths is not None:
        parts.append((got.lengths, want.lengths))
    for g, w in parts:
        g = g.cpu()
        if g.is_floating_point():
            ints = {torch.float64: torch.int64, torch.float32: torch.int32}
            g, w = g.view(ints[g.dtype]), w.view(ints[w.dtype])
        assert torch.equal(g, w)


def test_text_queries_on_card_match_cpu(dev):
    """tpch.TEXT_QUERIES at SF0.01 on the card and on the CPU, over
    several batches: the same rows, each equal to its numpy oracle
    (q1_text's floats within rel 1e-9; text_roundtrip exact)."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate_lineitem(0.01)
    tables = {"lineitem": (t, tpch.LINEITEM),
              "lineitem_text": (tpch.text_lineitem(t), tpch.LINEITEM_TEXT)}
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "true",
            "spark.rapids.sql.castStringToFloat.enabled": "true",
            "spark.rapids.sql.reader.batchSizeRows": "20000"}
    for name, query in tpch.TEXT_QUERIES.items():
        rows = []
        for device in ("cpu", dev):
            table, schema = tables[tpch.TEXT_INPUTS[name]]
            rows.append(query(TpuSession(conf, device=device)
                              .from_numpy(table, schema)).collect())
        assert rows[0] and tpch.rows_match(rows[0], rows[1]), name
        assert tpch.rows_match(tpch.ORACLES[name](t), rows[1]), name


@pytest.mark.parametrize("case", list(XM.CASES))
def test_math_and_bitwise_on_card_match_cpu(dev, case):
    """Each case of tests/test_torch_math.py (integer extremes, shift
    counts of -70..70 and beyond, special doubles against each other,
    subnormals, x.5 boundaries, nulls) on the card and on the CPU: the
    same type and null mask; bitwise, shifts, Floor, Ceil, Rint, Round,
    BRound, Signum, Sqrt, ToDegrees and ToRadians bit for bit (any NaN
    equal to any NaN), the rest within XM.REL."""
    data = XM.table()
    want = XM.port_eval(data, case, "cpu")
    got = XM.port_eval(data, case, dev)
    assert got[0] == want[0]
    bad = XM.parted(case, got, want, XM.CASES[case][0] in XM.EXACT)
    assert not bad.any(), (case, np.flatnonzero(bad)[:5])


@pytest.mark.parametrize("case", list(XH.CASES))
def test_murmur3_on_card_matches_cpu(dev, case):
    """Each murmur3 case of tests/test_torch_hash.py (every type, NaN
    payloads, +-0.0, strings of 0-64 bytes with bytes >= 0x80, nulls,
    folds) on the card and on the CPU: the same int32 bits."""
    data = XH.table()
    assert np.array_equal(XH.port_hash(data, case, dev),
                          XH.port_hash(data, case, "cpu"))


def test_math_queries_on_card_match_cpu(dev):
    """tpch.MATH_QUERIES at SF0.01 on the card and on the CPU, over
    several batches: the same rows, each matching its numpy oracle."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate_lineitem(0.01)
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "true",
            "spark.rapids.sql.reader.batchSizeRows": "20000"}
    for name, query in tpch.MATH_QUERIES.items():
        rows = [query(TpuSession(conf, device=d).from_numpy(
            t, tpch.LINEITEM)).collect() for d in ("cpu", dev)]
        assert rows[0] and tpch.match_math_query(name, rows[0], rows[1]), \
            name
        assert tpch.match_math_query(name, tpch.ORACLES[name](t), rows[1])


@pytest.mark.parametrize("frame", list(XW.EDGE_FRAMES))
def test_window_frames_on_card_match_cpu(dev, frame):
    """Every function of a frame kind over test_torch_window's edge table
    on the card and on the CPU, in one batch and over batches of 64
    behind a filter, rows equal under that file's rule (every K1, K2
    and K3 launch the window makes held to the plain versions)."""
    from spark_rapids_tpu_torch import TpuSession
    from spark_rapids_tpu_torch.plan import logical as PL
    schema = XW.PT.Schema([XW.PT.StructField(c, getattr(XW.PT, t))
                           for c, t in XW.EDGE_TYPES.items()])
    for n, conf in ((600, {}), (256, XW.BATCHED)):
        data = XW.edge_table(n)
        rows = [XW.edge_query(frame)(TpuSession(dict(conf), device=d)
                                     .from_numpy(data, schema), PL).collect()
                for d in ("cpu", dev)]
        assert rows[0]
        XW.rows_agree(rows[0], rows[1], XW._edge_tol(data))


def test_window_queries_on_card_match_cpu(dev):
    """tpch.WINDOW_QUERIES at SF0.01 on the card and on the CPU, over
    batches of 20,000 rows: the same rows, each matching its numpy
    oracle."""
    from spark_rapids_tpu_torch import TpuSession, tpch
    t = tpch.generate(0.01)
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "true",
            "spark.rapids.sql.reader.batchSizeRows": "20000"}
    for name, query in tpch.WINDOW_QUERIES.items():
        rows = []
        for d in ("cpu", dev):
            s = TpuSession(dict(conf), device=d)
            rows.append(query({n: s.from_numpy(v, tpch.SCHEMAS[n])
                               for n, v in t.items()}).collect())
        assert rows[0], name
        XW.rows_agree(rows[0], rows[1])
        assert tpch.match_window_query(name, tpch.ORACLES[name](t),
                                       rows[1]), name
