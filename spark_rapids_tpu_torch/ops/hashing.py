"""64-bit mix hashes for sort-based grouping and joins (port of the
grouping half of spark_rapids_tpu/ops/hashing.py).

Grouping sorts rows by two independent 64-bit hashes (h1, h2) and checks
key equality against the previous row; a join sorts its build side by h1
and verifies the keys of every candidate pair.  The hashes are bit-identical to
the JAX package's, so both packages order groups the same way.  uint64
values are carried in int64 tensors: right shifts are made logical by
masking; multiplication, xor and shifts left wrap as uint64 arithmetic
does.  Float keys hash their exact IEEE bits on every device.
"""
from __future__ import annotations

import torch

from ..columnar import Column

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
