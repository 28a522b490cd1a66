"""Sort (port of spark_rapids_tpu/exec/sort.py).

Every sort column is encoded into order-preserving unsigned integer key
components and the packed-key argsort (utils/packed_sort) orders the
batch with word sorts (kernel K3 on the card):

  * integers/dates/timestamps -> the value biased by 2^(width-1);
  * floats -> the IEEE monotone bit transform (NaN above +inf, all NaN
    equal, -0.0 == 0.0), exact on every device;
  * strings -> big-endian 64-bit words of the padded bytes + the length;
  * null placement -> a one-bit rank per column, dead rows -> a most
    significant bit that sends them last.

Descending columns complement their components within the width.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from ..columnar import Column, ColumnarBatch, concat_batches
from ..config import SORT_PACKED_ENABLED
from ..ops import expressions as E
from ..types import FloatType
from ..utils import packed_sort as PS
from .base import ExecContext, ExecNode

_I64_MIN = -(1 << 63)
_I32_MIN = -(1 << 31)
_NAN_BITS = 0x7FF8000000000000
_NAN_BITS32 = 0x7FC00000
_INT_WIDTHS = {"boolean": 1, "byte": 8, "short": 16, "int": 32,
               "date": 32, "long": 64, "timestamp": 64}


def float_sort_key(data: torch.Tensor) -> torch.Tensor:
    """Signed int64 order key of float64 values with Spark semantics."""
    d = data.to(torch.float64).contiguous()
    bits = d.view(torch.int64)
    bits = torch.where(bits == _I64_MIN, 0, bits)  # -0.0 -> 0.0
    bits = torch.where(torch.isnan(d), _NAN_BITS, bits)
    return torch.where(bits >= 0, bits, ~bits + _I64_MIN)


def _f32_key(data: torch.Tensor) -> torch.Tensor:
    """The same order on float32's own 32-bit pattern."""
    d = data.to(torch.float32).contiguous()
    bits = d.view(torch.int32)
    bits = torch.where(bits == _I32_MIN, 0, bits)
    bits = torch.where(torch.isnan(d), _NAN_BITS32, bits)
    return torch.where(bits >= 0, bits, ~bits + _I32_MIN).to(torch.int64)


def _string_words(c: Column) -> Iterator[torch.Tensor]:
    """Big-endian 64-bit words (int64-stored unsigned) of the padded bytes,
    made one at a time (widening the whole byte matrix to int64 at once
    takes 8x its bytes); UTF-8 byte order is code-point order."""
    width = c.data.shape[1]
    assert width % 8 == 0, width  # bucket_strlen yields powers of two >= 8
    shifts = torch.arange(56, -8, -8, device=c.device)
    for j in range(0, width, 8):
        # disjoint bits: the sum is an or
        yield (c.data[:, j:j + 8].to(torch.int64) << shifts).sum(dim=1)


def _biased(vals: torch.Tensor, width: int) -> torch.Tensor:
    """Signed values that fit `width` bits -> unsigned with the same order
    (flip the sign bit of the width-bit representation)."""
    if width == 64:
        return vals ^ _I64_MIN
    return vals.to(torch.int64) + (1 << (width - 1))


def column_key_components(c: Column, ascending: bool):
    """Packed-sort components `(int64 tensor of uint64 values, width)` of
    one column, most significant first.  Null rows are zeroed (the
    caller's null-rank component places them)."""
    comps = []  # (values, width, already unsigned)
    if c.dtype.is_string:
        width = c.data.shape[1]
        comps += [(w, 64, True) for w in _string_words(c)]
        comps.append((c.lengths.to(torch.int64),
                      max(1, int(width).bit_length()), True))
    elif c.dtype.is_floating:
        if c.dtype is FloatType:
            comps.append((_f32_key(c.data), 32, False))
        else:
            comps.append((float_sort_key(c.data), 64, False))
    else:
        width = _INT_WIDTHS[c.dtype.name]
        comps.append((c.data.to(torch.int64), width,
                      c.dtype.name == "boolean"))
    out = []
    for vals, width, unsigned in comps:
        u = vals if unsigned else _biased(vals, width)
        u = torch.where(c.valid, u, 0)
        if not ascending:
            u = ~u & PS._mask(width)
        out.append((u, width))
    return out


def column_sort_keys(c: Column, ascending: bool) -> List[torch.Tensor]:
    """Signed int64 order keys of one column for the multi-key lexsort
    path (unsigned components biased into signed order)."""
    keys = []
    for u, width in column_key_components(c, True):
        keys.append(u ^ _I64_MIN if width == 64 else u)
    keys = [torch.where(c.valid, k, 0) for k in keys]
    if not ascending:
        keys = [~k for k in keys]
    return keys


def packed_sort_components(live: torch.Tensor, cols: Sequence[Column],
                           ascending: Sequence[bool],
                           nulls_first: Sequence[bool]):
    """Components of the whole sort spec: live flag, then per column its
    null rank and keys."""
    comps = [((~live).long(), 1)]
    for c, asc, nf in zip(cols, ascending, nulls_first):
        null_rank = torch.where(c.valid, 1 if nf else 0, 0 if nf else 1)
        comps.append((null_rank.long(), 1))
        comps.extend(column_key_components(c, asc))
    return comps


def sort_order(batch: ColumnarBatch, exprs: Sequence[E.Expression],
               ascending: Sequence[bool], nulls_first: Sequence[bool],
               packed: bool = True) -> torch.Tensor:
    """Stable permutation ordering live rows by the sort spec, dead rows
    last.  `nulls_first` is the effective placement.  The packed path
    (default) and the lexsort path give the same permutation."""
    return order_of_columns(batch.sel, [e.eval(batch) for e in exprs],
                            ascending, nulls_first, packed)


def order_of_columns(live: torch.Tensor, cols: Sequence[Column],
                     ascending: Sequence[bool], nulls_first: Sequence[bool],
                     packed: bool = True) -> torch.Tensor:
    """sort_order's permutation from the spec's evaluated columns and the
    live-row mask."""
    cap = live.shape[0]
    if packed and cap & (cap - 1) == 0:
        comps = packed_sort_components(live, cols, ascending, nulls_first)
        total = sum(w for _, w in comps)
        npasses = PS.plan_passes(total, cap)
        # a very wide spec can need more radix passes than lexsort keys
        if npasses <= max(8, len(comps)):
            return PS.packed_argsort(comps, cap)
    major = [(~live).long()]
    for c, asc, nf in zip(cols, ascending, nulls_first):
        major.append(torch.where(c.valid, 1, 0 if nf else 2).long())
        major.extend(column_sort_keys(c, asc))
    return PS.lexsort(major)


class TpuSortExec(ExecNode):
    """Global sort: the input concatenated into one batch, shrunk when
    mostly dead, ordered by one permutation."""

    def __init__(self, sort_exprs: Sequence[E.Expression],
                 ascending: Sequence[bool], nulls_first: Sequence[bool],
                 child: ExecNode):
        super().__init__(child)
        self.sort_exprs = list(sort_exprs)
        self.ascending = list(ascending)
        self.nulls_first = list(nulls_first)

    @property
    def schema(self):
        return self.children[0].schema

    def execute(self, ctx: ExecContext):
        packed = ctx.conf.get(SORT_PACKED_ENABLED)
        batches = list(self.children[0].execute(ctx))
        if not batches:
            return
        batch = (batches[0] if len(batches) == 1
                 else concat_batches(batches, packed))
        batch = batch.maybe_shrink(batch.num_rows_host())
        order = sort_order(batch, self.sort_exprs, self.ascending,
                           self.nulls_first, packed)
        yield batch.take(order)
