"""The port's kernel modules against the JAX package, on the CPU.

Each kernel's plain PyTorch version (what the port's wrapper runs for a
CPU tensor) is held against the Pallas kernel it replaces, run in
interpret mode as tests/test_pallas.py runs it; the 64-bit grouping
hashes and the packed argsort must agree bit for bit.  Inputs are made
with numpy from a seed and handed to both packages.
"""
import inspect
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.ops import hashing as JH
from spark_rapids_tpu.ops import pallas_kernels as PK
from spark_rapids_tpu.types import (BooleanType as JBool,
                                    DoubleType as JDouble,
                                    IntegerType as JInt, LongType as JLong,
                                    StringType as JString)
from spark_rapids_tpu.utils import packed_sort as JPS
from spark_rapids_tpu_torch.columnar import Column
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.types import (BooleanType, DoubleType,
                                          IntegerType, LongType, StringType)
from spark_rapids_tpu_torch.utils import packed_sort as PS


def _u64_as_i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


# --------------------------------------------------------------------------
# K2: cumsum_1d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1024, 4096])
def test_cumsum_plain_matches_pallas_cumsum_1d(dtype, n):
    rng = np.random.RandomState(n)
    info = np.iinfo(dtype)
    # large values: the running sum wraps in both
    v = rng.randint(info.max // 8, info.max // 2, n).astype(dtype)
    want = np.asarray(PK.cumsum_1d(jnp.asarray(v), interpret=True))
    got = K.cumsum(torch.from_numpy(v)).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


# --------------------------------------------------------------------------
# K1: seg_agg_1d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_seg_scan_plain_matches_pallas_seg_agg_1d(op, dtype):
    """The running value of every row, not just each segment's last, for
    the 32-bit types the TPU kernel takes; a segment spans several tiles."""
    rng = np.random.RandomState(11)
    n = 4096
    gid = np.sort(rng.randint(0, 9, n)).astype(np.int32)
    if dtype == np.int32:
        v = rng.randint(-1000, 1000, n).astype(dtype)
    else:
        v = rng.randn(n).astype(dtype)
    want = np.asarray(PK.seg_agg_1d(jnp.asarray(gid), [jnp.asarray(v)],
                                    [op], interpret=True)[0])
    got = K.seg_scan(torch.from_numpy(gid), [torch.from_numpy(v)],
                     [op])[0].numpy()
    if dtype == np.float32 and op == "sum":
        # same terms, another order (tile rows vs a log-step sweep)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.array_equal(got, want)


def test_seg_scan_plain_restarts_and_handles_nan():
    """float64 and NaN, which the TPU kernel does not take: checked
    against a sequential numpy loop (min/max propagate NaN like
    torch.minimum)."""
    rng = np.random.RandomState(3)
    n = 3000
    gid = np.sort(rng.randint(0, 50, n)).astype(np.int32)
    v = rng.randn(n)
    v[rng.rand(n) < 0.02] = np.nan
    for op, f in (("sum", np.add), ("min", np.minimum),
                  ("max", np.maximum)):
        want = v.copy()
        for i in range(1, n):
            if gid[i] == gid[i - 1]:
                want[i] = f(want[i - 1], v[i])
        got = K.seg_scan(torch.from_numpy(gid), [torch.from_numpy(v)],
                         [op])[0].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                   equal_nan=True)


_MIXED = [(np.int32, "max"), (np.float32, "sum"), (np.int32, "sum"),
          (np.float32, "min")]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_seg_scan_plain_mixed_columns_match_pallas_seg_agg_1d(k):
    """k int32 and float32 columns (the dtypes the TPU kernel takes) under
    different ops in one call, against one seg_agg_1d call on the same
    columns; one segment spans several of its 1024-row tiles."""
    rng = np.random.RandomState(20 + k)
    n = 8192
    gid = np.concatenate([np.sort(rng.randint(0, 30, 2000)),
                          np.full(3500, 30),
                          np.sort(rng.randint(31, 400, n - 5500))])
    gid = gid.astype(np.int32)
    cols, ops = [], []
    for dtype, op in _MIXED[:k]:
        cols.append(rng.randint(-1000, 1000, n).astype(dtype)
                    if dtype == np.int32 else rng.randn(n).astype(dtype))
        ops.append(op)
    want = PK.seg_agg_1d(jnp.asarray(gid), [jnp.asarray(c) for c in cols],
                         ops, interpret=True)
    got = K.seg_scan(torch.from_numpy(gid),
                     [torch.from_numpy(c) for c in cols], ops)
    assert len(got) == k
    for (dtype, op), g, w in zip(_MIXED, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == dtype
        if dtype == np.float32 and op == "sum":
            # same terms, another order
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert np.array_equal(g, w), op


@pytest.mark.parametrize("case", ["lengths", "empty", "ops_count", "op",
                                  "too_many"])
def test_seg_scan_rejects_bad_requests(case):
    """Mismatched lengths, no columns, ops that do not match the columns,
    an unknown op and more columns than one launch takes all raise."""
    gid = torch.zeros(64, dtype=torch.int32)
    v = torch.ones(64, dtype=torch.float64)
    vals, ops = {
        "lengths": ([v, torch.ones(63)], ["sum", "min"]),
        "empty": ([], []),
        "ops_count": ([v, v], ["sum"]),
        "op": ([v], ["mean"]),
        "too_many": ([v] * (K.SEG_MAX_COLUMNS + 1),
                     ["max"] * (K.SEG_MAX_COLUMNS + 1)),
    }[case]
    with pytest.raises(ValueError):
        K.seg_scan(gid, vals, ops)


# --------------------------------------------------------------------------
# K3: bitonic_sort_u64
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1024, 2048])
def test_sort_words_plain_matches_pallas_bitonic(n):
    rng = np.random.RandomState(n)
    k = rng.randint(0, 2**63, n).astype(np.uint64) \
        | (rng.randint(0, 2, n).astype(np.uint64) << np.uint64(63))
    want = np.asarray(PK.bitonic_sort_u64(jnp.asarray(k), interpret=True))
    got = K.sort_words(_u64_as_i64(k)).numpy().view(np.uint64)
    assert np.array_equal(got, want)


def _lsd_by_digits(words: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """What the radix route of K3 computes: stable passes over the 8-bit
    digits of bits [lo, hi), least significant first, and nothing else."""
    w = words.view(np.uint64)
    for shift in range(lo, hi, 8):
        width = min(8, hi - shift)
        digit = (w >> np.uint64(shift)) & np.uint64((1 << width) - 1)
        w = w[np.argsort(digit, kind="stable")]
    return w.view(np.int64)


def _packed_words(rng, r: int, cw: int, keys: str) -> np.ndarray:
    """Words as the packed argsort builds them, (key << r) | row id, with
    keys of `cw` bits: random, all equal (one digit bucket a pass), or
    with the top bit set on about half."""
    n = 1 << r
    if keys == "one_bucket":
        key = np.full(n, (1 << cw) - 3, dtype=np.uint64)
    else:
        key = rng.randint(0, 2**62, n).astype(np.uint64) \
            | (rng.randint(0, 4, n).astype(np.uint64) << np.uint64(62))
        key &= np.uint64((1 << cw) - 1)
    return ((key << np.uint64(r))
            | np.arange(n, dtype=np.uint64)).view(np.int64)


@pytest.mark.parametrize("keys", ["random", "one_bucket", "top_bit"])
@pytest.mark.parametrize("r,cw", [(11, 53), (11, 14), (13, 51), (13, 3),
                                  (10, 0)])
def test_sort_words_bits_promise_on_packed_words(r, cw, keys):
    """On words built as packed_argsort builds them, the plain version
    gives the same result with and without `bits`, and a stable sort on
    the digits of bits [r, r + cw) alone gives the full sort."""
    if keys == "top_bit" and r + cw < 64:
        cw = 64 - r  # the key reaches bit 63
    w = _packed_words(np.random.RandomState(r * 100 + cw), r, cw, keys)
    full = K.sort_words_plain(torch.from_numpy(w))
    bits = (r, r + cw)
    assert torch.equal(K.sort_words(torch.from_numpy(w), bits), full)
    assert torch.equal(K.sort_words_plain(torch.from_numpy(w), bits), full)
    assert np.array_equal(_lsd_by_digits(w, *bits), full.numpy())


@pytest.mark.parametrize("bits", [(0, 64), (0, 8), (5, 63), (3, 64)])
def test_sort_words_digits_of_general_words(bits):
    """Arbitrary words (top bit set on half, many equal) sorted on all 64
    bits, and words that agree outside [lo, hi) sorted on those bits."""
    rng = np.random.RandomState(sum(bits))
    n = 4096
    lo, hi = bits
    w = (rng.randint(0, 2**63, n).astype(np.uint64)
         | (rng.randint(0, 2, n).astype(np.uint64) << np.uint64(63)))
    w[rng.rand(n) < 0.3] = w[0]
    inside = np.uint64(((1 << hi) - 1) ^ ((1 << lo) - 1))
    w = (w & inside) | (np.uint64(0xA5A5A5A5A5A5A5A5) & ~inside)
    w = w.view(np.int64)
    full = K.sort_words_plain(torch.from_numpy(w)).numpy()
    assert np.array_equal(_lsd_by_digits(w, lo, hi), full)


@pytest.mark.parametrize("bits", [(-1, 64), (10, 5), (0, 65)])
def test_sort_words_rejects_bad_bits(bits):
    with pytest.raises(ValueError):
        K.sort_words(torch.zeros(8, dtype=torch.int64), bits)


def test_packed_argsort_keeps_its_bits_promise(monkeypatch):
    """Every word sort packed_argsort asks for names the key bits of its
    pass, and the words keep the promise: zero above them, and a stable
    sort on their digits alone gives the full sort (two 64-bit hashes,
    q18's grouping, at a small capacity: passes of 53, 53 and 22 bits)."""
    calls = []

    def spy(words, bits=(0, 64)):
        calls.append(bits)
        lo, hi = bits
        w = words.numpy()
        if hi < 64:
            assert not np.any(w.view(np.uint64) >> np.uint64(hi))
        full = K.sort_words_plain(words)
        assert np.array_equal(_lsd_by_digits(w, lo, hi), full.numpy())
        return K.sort_words(words, bits)

    monkeypatch.setattr(PS, "sort_words", spy)
    rng = np.random.RandomState(6)
    cap = 2048
    h1 = rng.randint(0, 2**63, cap).astype(np.uint64) << np.uint64(1)
    h2 = rng.randint(0, 2**63, cap).astype(np.uint64)
    h1[::7] = h1[0]  # ties on the first hash
    comps = [(jnp.asarray(h1), 64), (jnp.asarray(h2), 64)]
    want = np.asarray(JPS.packed_argsort(comps, cap))
    got = PS.packed_argsort([(_u64_as_i64(h1), 64), (_u64_as_i64(h2), 64)],
                            cap).numpy()
    assert np.array_equal(got, want)
    assert calls == [(11, 64), (11, 64), (11, 33)]


def test_kernel_wrappers_take_plain_version_on_cpu():
    K.reset_launches()
    x = torch.arange(1024, dtype=torch.int64)
    K.cumsum(x)
    K.sort_words(x)
    K.seg_scan(torch.zeros(1024, dtype=torch.int32), [x, x.double()],
               ["sum", "min"])
    assert K.launch_counts() == {"seg_scan": 0, "cumsum": 0,
                                 "sort_words": 0}
    assert all(not k.shapes for k in K.KERNELS)


@pytest.mark.parametrize("kernel,tpu_kernel", [
    (K.seg_scan, PK.seg_agg_1d), (K.cumsum, PK.cumsum_1d),
    (K.sort_words, PK.bitonic_sort_u64)], ids=lambda k: k.__name__)
def test_kernel_wrapper_names_its_source_and_tpu_kernel(kernel, tpu_kernel):
    """`source` is the CUDA file in the repo; `replaces` is the file:line
    where the Pallas function it ports is defined."""
    root = pathlib.Path(__file__).resolve().parents[1]
    assert (root / kernel.source).is_file()
    assert kernel.source.startswith("spark_rapids_tpu_torch/csrc/")
    path, line = kernel.replaces.rsplit(":", 1)
    src, first = inspect.getsourcelines(tpu_kernel)
    assert (root / path).resolve() == pathlib.Path(
        inspect.getsourcefile(tpu_kernel)).resolve()
    assert int(line) == first and src[0].startswith(
        f"def {tpu_kernel.__name__}(")


def test_seg_scan_limits_match_the_cuda_source():
    """The wrapper's column limit, dtype codes and op codes are the ones
    `csrc/seg_scan.cu` takes: SS_MAX_COLS and the codes its `Column`
    descriptor documents."""
    root = pathlib.Path(__file__).resolve().parents[1]
    src = (root / K.seg_scan.source).read_text()
    cols = re.search(r"^#define SS_MAX_COLS (\d+)$", src, re.M)
    assert cols and int(cols.group(1)) == K.SEG_MAX_COLUMNS
    dtypes = re.search(r"int dtype;\s*// (.*)", src).group(1)
    assert dtypes == ", ".join(f"{code} {str(dt).split('.')[1]}" for dt, code
                               in sorted(K._SEG_DTYPES.items(),
                                         key=lambda kv: kv[1]))
    ops = re.search(r"int op;\s*// (.*)", src).group(1)
    assert ops == ", ".join(f"{i} {op}" for i, op in enumerate(K.SEG_OPS))


# --------------------------------------------------------------------------
# hashing
# --------------------------------------------------------------------------

def test_mix64_bit_identical():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 2**63, 5000).astype(np.uint64) \
        | (rng.randint(0, 2, 5000).astype(np.uint64) << np.uint64(63))
    want = np.asarray(JH.mix64(jnp.asarray(x)))
    got = H.mix64(_u64_as_i64(x)).numpy().view(np.uint64)
    assert np.array_equal(got, want)


def _columns(rng, n):
    """The same key columns for both packages: long, int, double with
    NaN/-0.0/nulls, boolean, and strings of several lengths."""
    lng = rng.randint(-2**40, 2**40, n).astype(np.int64)
    i32 = rng.randint(-50, 50, n).astype(np.int32)
    dbl = rng.randn(n)
    dbl[rng.rand(n) < 0.05] = np.nan
    dbl[rng.rand(n) < 0.05] = -0.0
    bol = rng.rand(n) < 0.5
    words = np.array(["", "a", "R", "N", "hello", "longer string!",
                      "x" * 20])[rng.randint(0, 7, n)]
    valid = rng.rand(n) > 0.1
    return [(lng, JLong, LongType), (i32, JInt, IntegerType),
            (dbl, JDouble, DoubleType), (bol, JBool, BooleanType),
            (words, JString, StringType)], valid


def test_hash_columns_double_bit_identical():
    rng = np.random.RandomState(4)
    n = 2048
    cols, valid = _columns(rng, n)
    live = rng.rand(n) > 0.2
    jcols, tcols = [], []
    for data, jt, tt in cols:
        if tt is StringType:
            jc = JColumn.from_strings([s if ok else None
                                       for s, ok in zip(data, valid)])
            tc = Column.from_strings(data, valid, n, "cpu",
                                     max_len=jc.max_len)
        else:
            jc = JColumn.from_numpy(data, valid, jt)
            tc = Column.from_numpy(data, valid, tt, n, "cpu")
        jcols.append(jc)
        tcols.append(tc)
    for i in range(len(cols)):
        jh1, jh2 = JH.hash_columns_double(jcols[:i + 1], jnp.asarray(live))
        th1, th2 = H.hash_columns_double(tcols[:i + 1], torch.from_numpy(live))
        assert np.array_equal(th1.numpy().view(np.uint64), np.asarray(jh1)), i
        assert np.array_equal(th2.numpy().view(np.uint64), np.asarray(jh2)), i


# --------------------------------------------------------------------------
# packed argsort (the shapes of tests/test_pallas.py's packed tests)
# --------------------------------------------------------------------------

def test_packed_argsort_bit_identical_one_word():
    rng = np.random.RandomState(2)
    cap = 4096
    a = rng.randint(0, 50, cap).astype(np.uint64)     # many ties
    b = rng.randint(0, 1 << 40, cap).astype(np.uint64)
    want = np.asarray(JPS.packed_argsort(
        [(jnp.asarray(a), 6), (jnp.asarray(b), 40)], cap))
    got = PS.packed_argsort([(_u64_as_i64(a), 6), (_u64_as_i64(b), 40)],
                            cap).numpy()
    assert np.array_equal(got, want)


def test_packed_argsort_bit_identical_multiword_radix():
    rng = np.random.RandomState(3)
    cap = 2048
    comps = [rng.randint(0, 2**60, cap).astype(np.uint64)
             | (rng.randint(0, 16, cap).astype(np.uint64) << np.uint64(60))
             for _ in range(3)]
    want = np.asarray(JPS.packed_argsort(
        [(jnp.asarray(c), 64) for c in comps], cap))
    got = PS.packed_argsort([(_u64_as_i64(c), 64) for c in comps],
                            cap).numpy()
    assert np.array_equal(got, want)
    # and the multi-key lexsort path gives the same permutation
    lex = PS.lexsort([_u64_as_i64(c) ^ (-(1 << 63)) for c in comps]).numpy()
    assert np.array_equal(lex, want)
