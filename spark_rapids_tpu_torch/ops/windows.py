"""Window functions: resolution and the device functions (port of
spark_rapids_tpu/ops/windows.py).

The exec (exec/window.py) sorts a batch once by (partition keys, order
keys) and every function is arithmetic on the sorted rows, as in the
JAX package:

  * segment starts          = a live flag or a partition key differing
                              from the previous row's (nulls equal, NaN
                              equal, -0.0 == 0.0); peer starts add the
                              order keys
  * row_number/rank/dense   = row indices against segment and peer
                              starts (dense_rank's steps summed by K2)
  * sum/count/avg any frame = prefix sums gathered at the frame bounds:
                              integer counts and sums over one global
                              int64 prefix (K2, exact under wraparound),
                              float sums over a prefix segmented at each
                              partition (K1), its inf and NaN counted apart
  * min/max unbounded side  = segmented running min/max (K1) of an
                              order-preserving int64 key, forward, or
                              over flipped rows for a frame that runs to
                              the partition's end
  * min/max bounded frames  = a stack of shifted gathers (at most
                              MAX_BOUNDED_MINMAX_WIDTH rows)
  * string min/max          = each row's rank in one sort of the column
                              (K3), its running min/max (K1), and the
                              bytes of the row that holds the winner
  * lag/lead                = shifted gathers fenced at segment bounds
  * default frame with an ORDER BY = RANGE UNBOUNDED PRECEDING to
                              CURRENT ROW: the frame ends at the last peer

K1 takes ascending int32 group ids: the running count of segment starts
less one, and for a reverse scan `G - 1 - flip(gid)` over the flipped
rows.  K1 also finds the segment and peer bounds (running max and min
of row indices, two columns a launch), where the JAX package runs
lax.cummax over the batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..columnar import Column, ColumnarBatch
from ..types import DataType, DoubleType, IntegerType, LongType, Schema
from . import expressions as E
from . import kernels as K
from .aggregates import AGG_FUNCS

UNBOUNDED = 1 << 62
MAX_BOUNDED_MINMAX_WIDTH = 256

RANKING_FUNCS = ("RowNumber", "Rank", "DenseRank")
OFFSET_FUNCS = ("Lag", "Lead")

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


@dataclass
class WindowFunc:
    """One resolved window function over a shared (partition, order)
    spec."""
    kind: str
    child: Optional[E.Expression]      # value expression (aggs, lag/lead)
    frame: Tuple                       # ("rows", start, end) |
                                       # ("range_to_current",) | ("whole",)
    name: str
    dtype: DataType
    offset: int = 1                    # lag/lead
    default: object = None             # lag/lead


class WindowUnsupported(Exception):
    pass


def _result_dtype(kind: str, child: Optional[E.Expression]) -> DataType:
    if kind in RANKING_FUNCS:
        return IntegerType
    if kind == "Count":
        return LongType
    if kind == "Average":
        return DoubleType
    if kind == "Sum":
        return LongType if child.dtype.is_integral else DoubleType
    return child.dtype


def resolve_window_func(func_ce, spec, schema: Schema, resolve,
                        device: bool = True) -> WindowFunc:
    """A window call and its WindowSpec -> WindowFunc.

    A semantic violation raises WindowUnsupported always; the limits of
    the device functions (a bounded Min/Max frame wider than
    MAX_BOUNDED_MINMAX_WIDTH, a string Min/Max whose frame start is
    bounded) only when `device` is True: the JAX package runs those on
    its CPU executor."""
    op = func_ce.op
    name = func_ce.output_name
    has_order = bool(spec.orders)

    if spec.frame is not None:
        _kind, start, end = spec.frame
        start = -UNBOUNDED if start <= -UNBOUNDED else start
        end = UNBOUNDED if end >= UNBOUNDED else end
        if start > end:
            raise WindowUnsupported(f"empty frame [{start}, {end}]")
        frame = ("rows", start, end)
    elif has_order:
        frame = ("range_to_current",)
    else:
        frame = ("whole",)

    if op in RANKING_FUNCS:
        if not has_order:
            raise WindowUnsupported(f"{op} requires an ORDER BY")
        return WindowFunc(op, None, frame, name, IntegerType)

    if op in OFFSET_FUNCS:
        child_ce, offset, default = func_ce.args
        if not has_order:
            raise WindowUnsupported(f"{op} requires an ORDER BY")
        child = resolve(child_ce, schema)
        return WindowFunc(op, child, frame, name, child.dtype,
                          offset=int(offset), default=default)

    if op in AGG_FUNCS:
        if op == "Percentile":
            raise WindowUnsupported("percentile window aggregates")
        child_ce, distinct = func_ce.args
        if distinct:
            raise WindowUnsupported("DISTINCT window aggregates")
        if op == "Count" and (child_ce.op == "lit"
                              and child_ce.args[0] in (1, "*")):
            child = None
        else:
            child = resolve(child_ce, schema)
        if op in ("Sum", "Average") and child is not None \
                and not child.dtype.is_numeric:
            raise WindowUnsupported(f"{op} over {child.dtype.name}")
        if device and op in ("Min", "Max") and frame[0] == "rows":
            start, end = frame[1], frame[2]
            bounded = start > -UNBOUNDED and end < UNBOUNDED
            if bounded and end - start + 1 > MAX_BOUNDED_MINMAX_WIDTH:
                raise WindowUnsupported(
                    f"bounded {op} frame wider than "
                    f"{MAX_BOUNDED_MINMAX_WIDTH} rows")
            if start > -UNBOUNDED and child is not None \
                    and child.dtype.is_string:
                # the string route is a forward segmented scan: the frame
                # must start at the partition's start
                raise WindowUnsupported(
                    f"{op} over strings with a bounded frame start")
        if child is not None and child.dtype.is_string \
                and op not in ("Min", "Max", "First", "Last", "Count"):
            raise WindowUnsupported(f"{op} over strings")
        return WindowFunc(op, child, frame, name, _result_dtype(op, child))

    raise WindowUnsupported(f"{op} is not a window function")


# --------------------------------------------------------------------------
# device functions (all over the SORTED rows; segments contiguous)
# --------------------------------------------------------------------------

def segment_flags(live: torch.Tensor, part_cols: Sequence[Column],
                  order_cols: Sequence[Column]):
    """(seg_start, new_peer) of sorted rows: `live` is their live mask,
    the columns the partition and order keys in sorted order."""
    from ..exec.aggregate import _col_differs_from_prev
    first = torch.zeros_like(live)
    first[0] = True
    seg_start = first | (live != torch.roll(live, 1, 0))
    for c in part_cols:
        seg_start = seg_start | _col_differs_from_prev(c)
    new_peer = seg_start
    for c in order_cols:
        new_peer = new_peer | _col_differs_from_prev(c)
    return seg_start, new_peer


def segment_indices(seg_start: torch.Tensor, new_peer: torch.Tensor,
                    gid: torch.Tensor, gid_rev: torch.Tensor):
    """Per-row segment-first / segment-last / peer-first / peer-last row
    indices (int64), from the flags and K1's group ids of the rows and of
    the flipped rows.  A first index is a running max of the start rows'
    indices, a last index a running min of the end rows' from the end:
    one K1 launch each way.  Every segment opens with a segment and a
    peer start, so these segmented scans equal the JAX package's
    lax.cummax over the whole batch."""
    cap = seg_start.shape[0]
    iota = torch.arange(cap, dtype=torch.int64, device=seg_start.device)

    def ends(starts):
        return torch.flip(torch.cat([starts[1:], torch.ones_like(starts[:1])]),
                          (0,))
    seg_first, peer_first = K.seg_scan(
        gid, [torch.where(seg_start, iota, 0),
              torch.where(new_peer, iota, 0)], ["max", "max"])
    flipped = torch.flip(iota, (0,))
    seg_last, peer_last = K.seg_scan(
        gid_rev, [torch.where(ends(seg_start), flipped, cap),
                  torch.where(ends(new_peer), flipped, cap)], ["min", "min"])
    return (seg_first, torch.flip(seg_last, (0,)), peer_first,
            torch.flip(peer_last, (0,)))


def _at(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t at the indices, clamped into range (the caller masks rows whose
    index lay outside)."""
    return t[idx.clamp(0, t.shape[0] - 1)]


class Segments:
    """The sorted rows' segment structure, shared by every function of
    one window exec: flags, bounds, and K1's group ids of the rows and of
    the flipped rows."""

    def __init__(self, live: torch.Tensor, part_cols: Sequence[Column],
                 order_cols: Sequence[Column]):
        self.live = live
        self.cap = live.shape[0]
        self.device = live.device
        self.iota = torch.arange(self.cap, dtype=torch.int64,
                                 device=self.device)
        self.seg_start, self.new_peer = segment_flags(live, part_cols,
                                                      order_cols)
        self.gid = K.cumsum(self.seg_start.to(torch.int32)) - 1
        # ascending too: segment G - 1 - g of the flipped rows is g
        self.gid_rev = self.gid[-1] - torch.flip(self.gid, (0,))
        self.seg_first, self.seg_last, self.peer_first, self.peer_last = \
            segment_indices(self.seg_start, self.new_peer, self.gid,
                            self.gid_rev)
        self._prefixes = {}  # key -> prefix sums, see prefix_frame

    def scan(self, vals: torch.Tensor, op: str,
             reverse: bool = False) -> torch.Tensor:
        """Running `op` within each segment (K1), from the segment's
        start, or from its end when `reverse`."""
        if not reverse:
            return K.seg_scan(self.gid, [vals], [op])[0]
        out = K.seg_scan(self.gid_rev, [torch.flip(vals, (0,))], [op])[0]
        return torch.flip(out, (0,))

    def frame_bounds(self, func: WindowFunc):
        """Per-row inclusive [a, b] frame row-index bounds."""
        if func.frame[0] == "whole":
            return self.seg_first, self.seg_last
        if func.frame[0] == "range_to_current":
            return self.seg_first, self.peer_last
        _r, start, end = func.frame
        a = self.seg_first if start <= -UNBOUNDED else \
            torch.maximum(self.seg_first, self.iota + start)
        b = self.seg_last if end >= UNBOUNDED else \
            torch.minimum(self.seg_last, self.iota + end)
        return a, b

    def prefix_frame(self, make, a, b, segmented: bool = False,
                     key=None) -> torch.Tensor:
        """Sum over rows [a, b] of the values `make()` gives, through
        prefix sums; an empty frame gives 0.  Integer sums take one global
        prefix (K2): wrapping, and exact, since modular addition is
        associative.  Float sums (`segmented`) take a prefix that restarts
        at every segment (K1): across segments one huge value would
        swallow every later frame's terms, or an inf turn them into
        inf - inf.  A prefix with a `key` (what is summed, of which child)
        is computed once and shared by every function that asks for it."""
        p = self._prefixes.get(key) if key is not None else None
        if p is None:
            vals = make()
            p = self.scan(vals, "sum") if segmented else K.cumsum(vals)
            p = torch.cat([torch.zeros_like(p[:1]), p])
            if key is not None:
                self._prefixes[key] = p
        upper = _at(p, b + 1)
        lower = _at(p, a)
        if segmented:
            # a frame starting at its segment's start subtracts nothing:
            # p[a] is the previous segment's tail, which the restart
            # already left out of p[b + 1]
            lower = torch.where(_at(self.seg_start, a),
                                torch.zeros_like(lower), lower)
        return torch.where(b >= a, upper - lower, torch.zeros_like(upper))


def eval_window_func(func: WindowFunc, c: Optional[Column],
                     seg: Segments, key: Optional[str] = None) -> Column:
    """One window function over the sorted rows; `c` is its child's
    column in sorted order (None for ranking functions and count(*)).
    Functions whose children share a `key` share their prefix sums."""
    cap, dev = seg.cap, seg.device

    def of(what: str):
        return None if key is None else (what, key)
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    if func.kind == "RowNumber":
        return Column((seg.iota - seg.seg_first + 1).to(torch.int32), ones,
                      IntegerType)
    if func.kind == "Rank":
        return Column((seg.peer_first - seg.seg_first + 1).to(torch.int32),
                      ones, IntegerType)
    if func.kind == "DenseRank":
        steps = K.cumsum((seg.new_peer & ~seg.seg_start).to(torch.int32))
        return Column(steps - steps[seg.seg_first] + 1, ones, IntegerType)

    if func.kind in OFFSET_FUNCS:
        return _offset(func, c, seg)

    a, b = seg.frame_bounds(func)
    if func.kind == "Count":
        if c is None:
            n = seg.prefix_frame(lambda: torch.ones(cap, dtype=torch.int64,
                                                    device=dev),
                                 a, b, key=("rows",))
        else:
            n = seg.prefix_frame(lambda: c.valid.long(), a, b,
                                 key=of("valid"))
        return Column(n, ones, LongType)

    c = c.mask_invalid()
    if func.kind in ("First", "Last"):
        g = c.take(a if func.kind == "First" else b)
        return Column(g.data, (b >= a) & g.valid, func.dtype, g.lengths)

    n = seg.prefix_frame(lambda: c.valid.long(), a, b, key=of("valid"))
    if func.kind in ("Sum", "Average"):
        if func.kind == "Sum" and c.dtype.is_integral:
            s = seg.prefix_frame(lambda: c.data.long(), a, b,
                                 key=of("sum"))
            return Column(s, n > 0, func.dtype)
        s = _float_sum(c.data.to(torch.float64), a, b, seg, of)
        if func.kind == "Sum":
            return Column(s, n > 0, func.dtype)
        return Column(s / n.clamp_min(1).to(torch.float64), n > 0,
                      DoubleType)

    assert func.kind in ("Min", "Max"), func.kind
    if c.dtype.is_string:
        return _min_max_string(func, c, a, b, n, seg)
    return _min_max(func, c, a, b, n, seg)


def _offset(func: WindowFunc, c: Column, seg: Segments) -> Column:
    """Lag/Lead: the value `offset` rows back (Lag) or ahead (Lead)
    within the segment, else the default (null when there is none)."""
    k = func.offset if func.kind == "Lag" else -func.offset
    src = seg.iota - k
    ok = (src >= seg.seg_first) & (src <= seg.seg_last)
    g = c.take(src)
    if func.default is None:
        return Column(g.data, ok & g.valid, func.dtype, g.lengths)
    frame = ColumnarBatch([], seg.live, Schema([]))
    dflt = E.Literal(func.default, func.dtype).eval(frame)
    if func.dtype.is_string:
        # the wider of the two byte widths
        width = max(dflt.max_len, g.max_len)
        dflt, g = dflt.pad_strings_to(width), g.pad_strings_to(width)
        data = torch.where(ok[:, None], g.data, dflt.data)
        return Column(data, torch.where(ok, g.valid, dflt.valid),
                      func.dtype, torch.where(ok, g.lengths, dflt.lengths))
    return Column(torch.where(ok, g.data, dflt.data),
                  torch.where(ok, g.valid, dflt.valid), func.dtype)


def _float_sum(v: torch.Tensor, a, b, seg: Segments, of) -> torch.Tensor:
    """IEEE sum of float64 values (nulls already 0) over each frame: the
    finite part through a segmented prefix, rebuilt from the frame's
    counts of NaN, +inf and -inf, so a non-finite value inside the
    segment but outside a bounded frame never reaches it.  `of` names
    each prefix for the segments' cache."""
    s = seg.prefix_frame(lambda: torch.where(torch.isfinite(v), v, 0.0),
                         a, b, segmented=True, key=of("finite"))
    n_nan = seg.prefix_frame(lambda: torch.isnan(v).long(), a, b,
                             key=of("nan"))
    n_pinf = seg.prefix_frame(lambda: (v == float("inf")).long(), a, b,
                              key=of("+inf"))
    n_ninf = seg.prefix_frame(lambda: (v == float("-inf")).long(), a, b,
                              key=of("-inf"))
    nan = torch.full_like(s, float("nan"))
    s = torch.where(n_ninf > 0, torch.full_like(s, float("-inf")), s)
    s = torch.where(n_pinf > 0, torch.full_like(s, float("inf")), s)
    return torch.where((n_nan > 0) | ((n_pinf > 0) & (n_ninf > 0)), nan, s)


def _order_key(c: Column) -> torch.Tensor:
    """int64 keys whose signed order is Spark's order of the values:
    floats by the monotone bit transform (NaN greatest, -0.0 == 0.0)."""
    from ..exec.sort import float_sort_key
    if c.dtype.is_floating:
        return float_sort_key(c.data)
    return c.data.to(torch.int64)


def _decode_key(k: torch.Tensor, dtype: DataType) -> torch.Tensor:
    """Invert _order_key (a float key decodes to the normalised value:
    one NaN, 0.0 for -0.0)."""
    if dtype.is_floating:
        bits = torch.where(k >= 0, k, ~(k ^ _I64_MIN))
        return bits.view(torch.float64).to(dtype.torch_dtype)
    return k.to(dtype.torch_dtype)


def _best_key(func: WindowFunc, k: torch.Tensor, a, b,
              seg: Segments) -> torch.Tensor:
    """Each frame's least (Min) or greatest (Max) of int64 keys `k`, in
    which null rows already hold the identity."""
    is_min = func.kind == "Min"
    op = "min" if is_min else "max"
    frame = func.frame
    if frame[0] != "rows" or frame[1] <= -UNBOUNDED:
        return _at(seg.scan(k, op), b)
    if frame[2] >= UNBOUNDED:
        return _at(seg.scan(k, op, reverse=True), a)
    # bounded on both sides: one shifted gather per offset
    ident = _I64_MAX if is_min else _I64_MIN
    reduce = torch.minimum if is_min else torch.maximum
    best = torch.full_like(k, ident)
    for off in range(frame[1], frame[2] + 1):
        src = seg.iota + off
        inside = (src >= a) & (src <= b)
        best = reduce(best, torch.where(inside, _at(k, src),
                                        torch.full_like(k, ident)))
    return best


def _min_max(func: WindowFunc, c: Column, a, b, n: torch.Tensor,
             seg: Segments) -> Column:
    """Min/Max of numbers, dates, timestamps and booleans over an
    order-preserving int64 key; nulls never win (NaN's key lies below
    int64's extremes, so a NaN beats a null)."""
    ident = _I64_MAX if func.kind == "Min" else _I64_MIN
    k = torch.where(c.valid, _order_key(c), ident)
    best = _best_key(func, k, a, b, seg)
    return Column(_decode_key(best, c.dtype), n > 0, func.dtype) \
        .mask_invalid()


def _min_max_string(func: WindowFunc, c: Column, a, b, n: torch.Tensor,
                    seg: Segments) -> Column:
    """Min/Max of strings over a frame that starts at the partition's
    start: each row's rank in one ascending sort of the column (K3)
    stands for its bytes, K1 runs the min/max of the valid rows' ranks,
    and the winning rank's row gives the bytes."""
    from ..exec.sort import order_of_columns
    perm = order_of_columns(c.valid, [c], [True], [True]).long()
    rank = torch.empty_like(perm)
    rank[perm] = seg.iota
    ident = _I64_MAX if func.kind == "Min" else _I64_MIN
    k = torch.where(c.valid, rank, ident)
    best = _best_key(func, k, a, b, seg)
    win = _at(perm, best)
    return c.take(win).with_valid(n > 0).mask_invalid()
