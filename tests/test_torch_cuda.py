"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA card (marker `cuda`) and skips
without one.  Run them on a machine with a card, where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


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
    got = K.seg_scan(gid.to(dev), v.to(dev), op).cpu()
    want = K.seg_scan_plain(gid, v, op)
    if op == "sum" and dtype.is_floating_point:
        # same terms, another order; NaN rows stay NaN in both
        tol = 1e-4 if dtype == torch.float32 else 1e-12
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        torch.testing.assert_close(got[ok], want[ok], rtol=tol, atol=tol)
    else:
        assert _same(got, want)


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
    K.seg_scan(torch.zeros(4096, dtype=torch.int32, device=dev), x, "max")
    K.cumsum(x.cpu())  # the plain version launches nothing
    assert K.launch_counts() == {"seg_scan": 1, "cumsum": 1,
                                 "sort_words": 1}
    assert K.seg_scan.shapes == {(4096, torch.int64, "max")}
    assert K.cumsum.shapes == {(4096, torch.int64)}
    assert K.sort_words.shapes == {(4096, torch.int64, 0, 64)}


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
