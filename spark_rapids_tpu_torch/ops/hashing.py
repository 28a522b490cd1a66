"""Hashes (port of spark_rapids_tpu/ops/hashing.py): 64-bit mix hashes
for sort-based grouping and joins, and Spark's 32-bit murmur3 (its
`hash()` expression and the partition function of every hash exchange).

Grouping sorts rows by two independent 64-bit hashes (h1, h2) and checks
key equality against the previous row; a join sorts its build side by h1
and verifies the keys of every candidate pair.  The hashes are bit-identical to
the JAX package's, so both packages order groups the same way.  uint64
values are carried in int64 tensors: right shifts are made logical by
masking; multiplication, xor and shifts left wrap as uint64 arithmetic
does.  Float keys hash their exact IEEE bits on every device.

Murmur3 carries its uint32 words in int64 tensors, masked to 32 bits
after each multiply and shift left (the low 32 bits of an int64 product
that wraps are the uint32 product's), so a right shift of a word is
logical; the result is the int32 of the final word's bits, the same on
the CPU and on the card.
"""
from __future__ import annotations

import torch

from ..columnar import Column
from ..types import IntegerType
from .expressions import Expression

_M64 = (1 << 64) - 1


def _s64(x: int) -> int:
    """The int64 with the bit pattern of uint64 `x`."""
    x &= _M64
    return x - (1 << 64) if x >= 1 << 63 else x


_C1 = _s64(0xff51afd7ed558ccd)
_C2 = _s64(0xc4ceb9fe1a85ec53)
_LOW31 = (1 << 31) - 1  # mask after an arithmetic >> 33
_NAN_BITS = 0x7FF8000000000000
_FNV_PRIME = 1099511628211


def _shr33(x: torch.Tensor) -> torch.Tensor:
    return (x >> 33) & _LOW31


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64-style finalizer over int64-stored uint64 values."""
    x = x ^ _shr33(x)
    x = x * _C1
    x = x ^ _shr33(x)
    x = x * _C2
    x = x ^ _shr33(x)
    return x


def _mix64_int(x: int) -> int:
    """mix64 of one Python integer, as an int64."""
    x &= _M64
    for c in (0xff51afd7ed558ccd, 0xc4ceb9fe1a85ec53):
        x ^= x >> 33
        x = (x * c) & _M64
    x ^= x >> 33
    return _s64(x)


def f64_bits(d: torch.Tensor) -> torch.Tensor:
    """Exact IEEE bit pattern of float64 values, as int64."""
    return d.to(torch.float64).contiguous().view(torch.int64)


def _normalize_bits(col: Column) -> torch.Tensor:
    """Value bits with Spark key semantics: -0.0 == 0.0, all NaN equal."""
    if col.dtype.is_floating:
        d = col.data.to(torch.float64)
        d = torch.where(d == 0.0, torch.zeros((), dtype=torch.float64,
                                              device=d.device), d)
        bits = f64_bits(d)
        return torch.where(torch.isnan(d), _NAN_BITS, bits)
    if col.dtype.is_string:
        raise AssertionError("use the string path")
    return col.data.to(torch.int64)


def hash_column64(col: Column, seed: int) -> torch.Tensor:
    """int64-stored uint64 hash of one column (nulls get a fixed tag)."""
    if col.dtype.is_string:
        h = _hash_bytes(col, seed)
    else:
        h = mix64(_normalize_bits(col)
                  ^ _s64(seed * 0x9e3779b97f4a7c15))
    null_h = _mix64_int(seed + 0x51ed2701)
    return torch.where(col.valid, h, null_h)


def _hash_bytes(col: Column, seed: int) -> torch.Tensor:
    """Polynomial rolling hash over the byte matrix, mixed; vectorized over
    rows, a loop over the (static) byte width."""
    data = col.data
    cap, width = data.shape
    lengths = col.lengths.to(torch.int64)
    h = torch.full((cap,), _s64(14695981039346656037 + seed * 31),
                   dtype=torch.int64, device=data.device)
    for j in range(width):
        m = j < lengths
        byte = torch.where(m, data[:, j].to(torch.int64), 0)
        h = torch.where(m, (h * _FNV_PRIME) ^ byte, h)
    return mix64(h ^ lengths)


def _hash_columns(cols, live: torch.Tensor, seed) -> torch.Tensor:
    h = torch.zeros(live.shape, dtype=torch.int64, device=live.device)
    for i, c in enumerate(cols):
        h = mix64(h ^ hash_column64(c, seed(i)))
    return torch.where(live, h, -1)


def hash_columns_h1(cols, live: torch.Tensor) -> torch.Tensor:
    """The h1 of hash_columns_double alone (what a join sorts and probes
    by)."""
    return _hash_columns(cols, live, lambda i: 2 * i + 1)


def hash_columns_double(cols, live: torch.Tensor):
    """(h1, h2) independent 64-bit hashes over the key columns; dead rows
    get all-ones so an ascending unsigned sort puts them last."""
    return (hash_columns_h1(cols, live),
            _hash_columns(cols, live, lambda i: 7919 * (i + 1)))


# ---- murmur3 32-bit, Spark-compatible (seed 42) ---------------------------

_M32 = (1 << 32) - 1


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _mmh3_mix_k(k: torch.Tensor) -> torch.Tensor:
    k = (k * 0xcc9e2d51) & _M32
    k = _rotl32(k, 15)
    return (k * 0x1b873593) & _M32


def _mmh3_mix_h(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    h = h ^ _mmh3_mix_k(k)
    h = _rotl32(h, 13)
    return (h * 5 + 0xe6546b64) & _M32


def _mmh3_final(h: torch.Tensor, length) -> torch.Tensor:
    """The finalizer over uint32 words `h` and byte length(s) `length`;
    the int32 of its bits."""
    h = h ^ length
    h = h ^ (h >> 16)
    h = (h * 0x85ebca6b) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xc2b2ae35) & _M32
    h = h ^ (h >> 16)
    return h.to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 word of int32 (or narrower, sign-extended) values."""
    return x.to(torch.int64) & _M32


def _seed_u32(seed, like: torch.Tensor) -> torch.Tensor:
    """The running seed as uint32 words: an int for every row, or the
    int32 hash of the columns before."""
    if isinstance(seed, int):
        return torch.full(like.shape[:1], seed & _M32, dtype=torch.int64,
                          device=like.device)
    return _u32(seed)


def murmur3_int(x_i32: torch.Tensor, seed) -> torch.Tensor:
    """Spark's hashInt: one 4-byte block."""
    return _mmh3_final(_mmh3_mix_h(_seed_u32(seed, x_i32), _u32(x_i32)), 4)


def murmur3_long(x_i64: torch.Tensor, seed) -> torch.Tensor:
    """Spark's hashLong: the low word, then the high word."""
    lo = x_i64 & _M32
    hi = (x_i64 >> 32) & _M32
    h = _mmh3_mix_h(_seed_u32(seed, x_i64), lo)
    return _mmh3_final(_mmh3_mix_h(h, hi), 8)


_F32_NAN, _F32_EXP, _F32_MANT = 0x7FC00000, 0x7F800000, 0x007FFFFF
_F64_EXP, _F64_MANT = 0x7FF0000000000000, 0x000FFFFFFFFFFFFF


def spark_hash_column(col: Column, seed) -> torch.Tensor:
    """Spark's Murmur3Hash of one column, per type, seeded by `seed` (an
    int, or the int32 hash of the columns before); a null row passes the
    seed through.  Int, short, byte, date and boolean hash as an int;
    long and timestamp as a long; a float and a double by their bits
    with -0.0 as 0.0 and every NaN as one, normalised in the integer
    domain; a string by its UTF-8 bytes."""
    dt = col.dtype
    if dt.is_string:
        h = _spark_hash_string(col, seed)
    elif dt.name in ("int", "short", "byte", "date", "boolean"):
        h = murmur3_int(col.data.to(torch.int32), seed)
    elif dt.name in ("long", "timestamp"):
        h = murmur3_long(col.data, seed)
    elif dt.name == "float":
        bits = col.data.to(torch.float32).contiguous().view(torch.int32)
        bits = torch.where(bits == -2 ** 31, 0, bits)
        nan = ((bits & _F32_EXP) == _F32_EXP) & ((bits & _F32_MANT) != 0)
        h = murmur3_int(torch.where(nan, _F32_NAN, bits), seed)
    elif dt.name == "double":
        bits = f64_bits(col.data)
        bits = torch.where(bits == -2 ** 63, 0, bits)
        nan = ((bits & _F64_EXP) == _F64_EXP) & ((bits & _F64_MANT) != 0)
        h = murmur3_long(torch.where(nan, _NAN_BITS, bits), seed)
    else:
        raise NotImplementedError(f"spark hash of {dt.name}")
    return torch.where(col.valid, h, seed)


def _spark_hash_string(col: Column, seed) -> torch.Tensor:
    """Murmur3 over a string's UTF-8 bytes as Spark's hashUnsafeBytes
    takes them: 4-byte little-endian blocks, then each of the up to 3
    bytes left mixed alone as a sign-extended int, then the finalizer
    with the byte length.  A loop over the row width's words, each row
    mixing only the blocks within its length."""
    data = col.data
    if data.stride(-1) != 1 or data.stride(0) % 4 \
            or data.storage_offset() % 4:
        data = data.contiguous()
    width = data.shape[1]
    lens = col.lengths.to(torch.int64)
    nblocks = lens >> 2
    h = _seed_u32(seed, lens)
    words = data[:, :width // 4 * 4].view(torch.int32)
    for j in range(width // 4):
        h = torch.where(j < nblocks, _mmh3_mix_h(h, _u32(words[:, j])), h)
    tail = nblocks << 2
    for t in range(3):
        at = tail + t
        byte = torch.gather(data, 1, at.clamp(0, width - 1)[:, None])[:, 0]
        h = torch.where(at < lens, _mmh3_mix_h(h, _u32(byte.view(
            torch.int8))), h)
    return _mmh3_final(h, lens)


def spark_hash_columns(cols, seed: int = 42) -> torch.Tensor:
    """Spark's Murmur3Hash(cols): a fold over the columns, each seeded by
    the hash of the ones before (what a hash exchange partitions by,
    with pmod by the partition count)."""
    h = seed
    for c in cols:
        h = spark_hash_column(c, h)
    return h


class Murmur3Hash(Expression):
    """Spark's `hash(...)`: murmur3_32 folded over the argument columns
    from seed 42, a null passing the running seed through; never null.
    With no arguments, the seed on every row."""

    def __init__(self, *children: Expression, seed: int = 42):
        self.children = tuple(children)
        self.seed = int(seed)

    @property
    def dtype(self):
        return IntegerType

    def eval(self, batch):
        cap, dev = batch.capacity, batch.device
        h = spark_hash_columns([ch.eval(batch) for ch in self.children],
                               self.seed)
        if isinstance(h, int):
            h = torch.full((cap,), h, dtype=torch.int32, device=dev)
        return Column(h, torch.ones(cap, dtype=torch.bool, device=dev),
                      IntegerType)
