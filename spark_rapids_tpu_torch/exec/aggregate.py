"""Hash aggregate (port of spark_rapids_tpu/exec/aggregate.py).

Grouping is sort-based, as in the JAX package:

  1. hash the keys twice (64 bits each) and order rows by (h1, h2) with
     the packed argsort (kernel K3); dead rows hash to all-ones and go
     last;
  2. a group boundary is a hash change or any key differing from the
     previous sorted row (Spark key equality: nulls equal, NaN equal,
     -0.0 == 0.0);
  3. group id = running count of boundaries; segmented reductions over the
     sorted ids, split as the JAX package splits them: integer sums and
     counts as prefix differences (kernel K2), float sums and every min
     and max as segmented scans (kernel K1), all sharing one searchsorted
     pair.

Beyond those, as the JAX package computes them:
  * First and Last (nulls included) keep (value, position) states: the
    position is a row's rank among the live rows of its batch plus the
    live rows of every earlier batch (the driver's row offset), so a
    filtered batch gives the same positions compacted or not, and the
    merge keeps the least (First) or greatest (Last);
  * a distinct Sum, Count or Average dedups its child inside one update:
    rows sort by (group, value) with two more hash words and only the
    first row of each (group, value) run counts.  Partial states of two
    batches could count one value twice, so the planner coalesces the
    input into one batch (exec/basic.TpuCoalesceBatchesExec);
  * Min and Max over strings narrow each group's candidates one 8-byte
    word at a time (big-endian, so an integer order of the words is the
    byte order), then the length, and gather the winning row's bytes.

Low-cardinality batches take the sort-free bucket path first: rows
scatter into 1024 hash buckets and an exact check proves every bucket
holds one key; a dirty batch takes the sort path, and the exec stops
probing for the rest of the query.  First, Last, distinct aggregates and
string Min/Max never take it.  Per-batch partial states are merged
`mergeFanIn` at a time (concat + the same sort-based grouping), then
finalized.  `update_paths` counts which path each batch's update took.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from ..columnar import Column, ColumnarBatch, concat_batches
from ..config import (AGG_BUCKET_GROUPS, AGG_MERGE_FAN_IN,
                      SORT_PACKED_ENABLED)
from ..ops import expressions as E
from ..ops import kernels as K
from ..ops.aggregates import AggregateExpression
from ..ops.hashing import _normalize_bits, hash_columns_double
from ..types import DoubleType, LongType, Schema, StructField
from ..utils import packed_sort as PS
from .base import ExecContext, ExecNode
from .sort import _string_words

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
_SIGN = _I64_MIN


def _full(n: int, value, dtype, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=dtype, device=device)


def _type_max(dt):
    """Identity of Min over dtype dt (its largest value)."""
    if dt.is_floating:
        return float("inf")
    if dt.name == "boolean":
        return True
    return torch.iinfo(dt.torch_dtype).max


def _type_min(dt):
    """Identity of Max over dtype dt (its smallest value)."""
    if dt.is_floating:
        return float("-inf")
    if dt.name == "boolean":
        return False
    return torch.iinfo(dt.torch_dtype).min


def _shift1(x: torch.Tensor) -> torch.Tensor:
    """x[i-1] at position i; position 0 gets x[0]'s wrapped neighbour, as
    jnp.roll does."""
    return torch.roll(x, 1, 0)


def _key_equal_at(c: Column, idx: torch.Tensor) -> torch.Tensor:
    """Row i's key value-equals the key at row idx[i] (Spark grouping
    equality)."""
    idx = idx.long()
    vg = c.valid[idx]
    both_null = ~c.valid & ~vg
    if c.dtype.is_string:
        dd = torch.all(c.data == c.data[idx], dim=1) & \
            (c.lengths == c.lengths[idx])
    else:
        bits = _normalize_bits(c)
        dd = bits == bits[idx]
    return torch.where(both_null, True,
                       torch.where(c.valid != vg, False,
                                   torch.where(c.valid, dd, True)))


def _col_differs_from_prev(c: Column) -> torch.Tensor:
    """Row i's key differs from row i-1's (Spark grouping equality)."""
    vprev = _shift1(c.valid)
    both_null = ~c.valid & ~vprev
    if c.dtype.is_string:
        diff = torch.any(c.data != _shift1(c.data), dim=1) | \
            (c.lengths != _shift1(c.lengths))
    else:
        bits = _normalize_bits(c)
        diff = bits != _shift1(bits)
    return torch.where(both_null, False,
                       torch.where(c.valid != vprev, True,
                                   torch.where(c.valid, diff, False)))


def group_rows(key_cols: Sequence[Column], live: torch.Tensor,
               packed: bool = True, value_cols: Sequence[Column] = ()):
    """-> (order, gid_sorted, boundary_sorted, num_groups).

    order: stable permutation putting equal keys adjacent, dead rows last.
    With `value_cols`, equal values also lie adjacent within each group
    (the distinct dedup's order: two more 64-bit hash words, minor to the
    keys').  With no key columns every live row is one group.
    gid_sorted[i]: group id of sorted position i (garbage for dead rows).
    num_groups: a 0-d device tensor."""
    cap = live.shape[0]
    comps = []
    if key_cols:
        h1, h2 = hash_columns_double(key_cols, live)
        comps += [(h1, 64), (h2, 64)]
    if value_cols:
        comps += [(h, 64) for h in hash_columns_double(value_cols, live)]
    if not comps:  # one group: the sort only sends the dead rows last
        comps = [((~live).long(), 1)]
    if packed and cap & (cap - 1) == 0:
        order = PS.packed_argsort(comps, cap)
    else:
        order = PS.lexsort([c ^ _SIGN for c, _ in comps])
    o = order.long()
    live_s = live[o]
    if not key_cols:
        boundary = torch.zeros(cap, dtype=torch.bool, device=live.device)
        boundary[0] = live_s[0]
        return (order, torch.zeros(cap, dtype=torch.int32,
                                   device=live.device),
                boundary, boundary.sum(dtype=torch.int32))
    h1s, h2s = h1[o], h2[o]
    differs = (h1s != _shift1(h1s)) | (h2s != _shift1(h2s))
    for c in key_cols:
        differs = differs | _col_differs_from_prev(c.take(order))
    boundary = live_s & differs
    boundary[0] = live_s[0]
    gid = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    return order, gid, boundary, boundary.sum(dtype=torch.int32)


# --------------------------------------------------------------------------
# segment reducers over sorted ids
# --------------------------------------------------------------------------
#
# Integer sums and counts are prefix differences over a running sum (K2):
# exact under int64 wraparound, since modular addition is associative.
# Float sums cannot be: a difference of two running prefixes loses a small
# segment once the running total dwarfs it.  They take the segmented scan
# (K1), which restarts at every boundary, as do min and max, which have no
# invertible prefix form.

def _masked_cumsum(v: torch.Tensor) -> torch.Tensor:
    return K.cumsum(v)


def _seg_multi(reqs, gid: torch.Tensor, cap: int) -> List[torch.Tensor]:
    """All requested segmented reductions over ascending `gid`.

    `reqs`: (op, vals, contribute, fill[, is_count]) with op in
    'sum'|'min'|'max'; rows where `contribute` is false add 0 to a sum or
    compare as `fill`.  Returns one [cap] tensor per request; an empty
    segment gets 0 (sum) or `fill` (min/max).  Every K1 request of the
    call (float sums, every min and max) goes to one K1 launch, as the
    JAX package's fused path hands them all to one seg_agg_1d pass (a
    launch takes K.SEG_MAX_COLUMNS of them: more take more launches)."""
    n = gid.shape[0]
    device = gid.device
    seg = torch.arange(cap, dtype=gid.dtype, device=device)
    start = torch.searchsorted(gid, seg, right=False)
    end = torch.searchsorted(gid, seg, right=True)
    end_ix = (end - 1).clamp(0, n - 1)
    nonempty = end > start
    results = [None] * len(reqs)
    scans = []  # (request index, masked values, op, empty-segment value)
    for i, req in enumerate(reqs):
        op, vals, contribute, fill = req[0], req[1], req[2], req[3]
        if op == "sum" and not vals.is_floating_point():
            v = torch.where(contribute, vals, 0)
            c = _masked_cumsum(v)
            total = torch.where(end > 0, c[end_ix], 0)
            prev = torch.where(start > 0, c[(start - 1).clamp(0, n - 1)], 0)
            results[i] = torch.where(nonempty, total - prev, 0) \
                .to(vals.dtype)
        elif op == "sum":
            scans.append((i, torch.where(contribute, vals, 0), op, 0))
        else:
            scans.append((i, torch.where(
                contribute, vals,
                torch.as_tensor(fill, dtype=vals.dtype, device=device)),
                op, fill))
    for c in range(0, len(scans), K.SEG_MAX_COLUMNS):
        part = scans[c:c + K.SEG_MAX_COLUMNS]
        runs = K.seg_scan(gid, [v for _, v, _, _ in part],
                          [op for _, _, op, _ in part])
        for (i, _, _, ident), run in zip(part, runs):
            results[i] = torch.where(
                nonempty, run[end_ix],
                torch.as_tensor(ident, dtype=run.dtype, device=device))
    return results


def _seg_min(vals, gid, contribute, cap, fill):
    return _seg_multi([("min", vals, contribute, fill)], gid, cap)[0]


def _agg_state_fields(agg: AggregateExpression):
    """State layout of one aggregate: (field_suffix, dtype) pairs."""
    f = agg.func
    if f == "Count":
        return [("count", LongType)]
    if f == "Average":
        return [("sum", DoubleType), ("count", LongType)]
    if f == "Sum":
        return [("sum", agg.dtype)]
    if f in ("Min", "Max"):
        return [(f.lower(), agg.child.dtype)]
    if f in ("First", "Last"):
        return [("val", agg.child.dtype), ("pos", LongType)]
    raise NotImplementedError(f)


def _ones(cap, device):
    return torch.ones(cap, dtype=torch.bool, device=device)


def _update_one(agg: AggregateExpression, col, gid, live_s, cap,
                dedup=None):
    """State columns of one aggregate from sorted input values.  `dedup`:
    for a distinct aggregate, the sorted rows that open a (group, value)
    run; the other rows of a run add nothing."""
    device = live_s.device
    f = agg.func
    if agg.distinct and dedup is not None and f in ("Sum", "Count",
                                                    "Average"):
        live_c = live_s & dedup
    else:
        live_c = live_s
    if f == "Count":
        contribute = live_c if col is None else live_c & col.valid
        cnt = _seg_multi([("sum", contribute.long(), live_s, 0, True)],
                         gid, cap)[0]
        return [Column(cnt, _ones(cap, device), LongType)]
    contribute = live_c & col.valid
    if f in ("Sum", "Average"):
        out_t = DoubleType if f == "Average" else agg.dtype
        v = col.data.to(out_t.torch_dtype)
        s, nvalid = _seg_multi([("sum", v, contribute, 0),
                                ("sum", contribute.long(), live_s, 0, True)],
                               gid, cap)
        sum_col = Column(s, nvalid > 0, out_t).mask_invalid()
        if f == "Sum":
            return [sum_col]
        return [sum_col, Column(nvalid, _ones(cap, device), LongType)]
    if f in ("Min", "Max"):  # distinct changes neither
        if col.dtype.is_string:
            return [_minmax_string(f, col, gid, contribute, cap)]
        return [_minmax(f, agg.child.dtype, col.data, gid, contribute, cap)]
    raise NotImplementedError(f)


def _string_order_keys(col: Column) -> Iterator[torch.Tensor]:
    """int64 keys of a string column whose signed order, most significant
    first, is the strings' byte order, made one at a time: each
    big-endian 8-byte word with its sign bit flipped (a signed compare of
    them is the unsigned one), then the length (a shorter string ties a
    longer one's prefix padded with zero bytes)."""
    for w in _string_words(col):
        yield w ^ _SIGN
    yield col.lengths.long()


def _minmax_string(f, scol: Column, gid, contribute, cap) -> Column:
    """Per-group byte-order min/max of a sorted string column: K1 narrows
    each group's candidate rows one order key at a time (one launch a
    key, the first with the valid count), then the first candidate's
    bytes are gathered."""
    ones = torch.ones_like(contribute)
    g = gid.clamp(0, cap - 1).long()
    op, fill = ("min", _I64_MAX) if f == "Min" else ("max", _I64_MIN)
    cand = contribute
    nvalid = None
    for k in _string_order_keys(scol):
        reqs = [(op, k, cand, fill)]
        if nvalid is None:
            reqs.append(("sum", contribute.long(), ones, 0, True))
        res = _seg_multi(reqs, gid, cap)
        if nvalid is None:
            nvalid = res[1]
        cand = cand & (k == res[0][g])
    rowpos = torch.arange(gid.shape[0], dtype=torch.int64, device=gid.device)
    win = _seg_min(torch.where(cand, rowpos, _I64_MAX), gid, ones, cap,
                   _I64_MAX)
    return scol.take(win.clamp(0, gid.shape[0] - 1)) \
        .with_valid(nvalid > 0).mask_invalid()


def _first_last(reqs, gid, live_s, cap):
    """For each (func, pos) of `reqs` ("First" or "Last", an int64
    position per sorted row): each group's least (First) or greatest
    (Last) position among its live rows, and the sorted row that holds
    it (positions are unique).  One K1 launch finds every position, one
    more every row."""
    bests = _seg_multi([("min", pos, live_s, _I64_MAX) if f == "First"
                        else ("max", pos, live_s, -1) for f, pos in reqs],
                       gid, cap)
    g = gid.clamp(0, cap - 1).long()
    rowpos = torch.arange(gid.shape[0], dtype=torch.int64, device=gid.device)
    wins = _seg_multi([("min", torch.where(pos == best[g], rowpos, _I64_MAX),
                        live_s, _I64_MAX)
                       for (_, pos), best in zip(reqs, bests)], gid, cap)
    return [(b, w.clamp(0, gid.shape[0] - 1)) for b, w in zip(bests, wins)]


def _minmax(f, dtype, vals, gid, contribute, cap):
    """Per-group min/max with Spark's float order (NaN greatest)."""
    ones = torch.ones_like(contribute)
    if dtype.is_floating:
        v = vals.to(torch.float64)
        isnan = torch.isnan(v)
        if f == "Min":
            has_nan, nvalid, n_non_nan, r = _seg_multi(
                [("max", (contribute & isnan).int(), ones, 0),
                 ("sum", contribute.long(), ones, 0, True),
                 ("sum", (contribute & ~isnan).int(), ones, 0, True),
                 ("min", torch.where(isnan, float("inf"), v), contribute,
                  float("inf"))], gid, cap)
            # NaN wins min only when the group has no other value
            r = torch.where((has_nan > 0) & (n_non_nan == 0),
                            float("nan"), r)
        else:
            has_nan, nvalid, r = _seg_multi(
                [("max", (contribute & isnan).int(), ones, 0),
                 ("sum", contribute.long(), ones, 0, True),
                 ("max", torch.where(isnan, float("-inf"), v), contribute,
                  float("-inf"))], gid, cap)
            r = torch.where(has_nan > 0, float("nan"), r)
        return Column(r.to(dtype.torch_dtype), nvalid > 0,
                      dtype).mask_invalid()
    v = vals.to(torch.int64)
    fill = _I64_MAX if f == "Min" else _I64_MIN
    nvalid, r = _seg_multi([("sum", contribute.long(), ones, 0, True),
                            (f.lower(), v, contribute, fill)], gid, cap)
    return Column(r.to(dtype.torch_dtype), nvalid > 0, dtype).mask_invalid()


def _scalar_col(value: torch.Tensor, valid, dtype, cap, device) -> Column:
    data = torch.zeros(cap, dtype=dtype.torch_dtype, device=device)
    data[0] = value
    v = torch.zeros(cap, dtype=torch.bool, device=device)
    v[0] = valid
    return Column(data, v, dtype).mask_invalid()


def _row_col(c: Column, idx: torch.Tensor, valid, cap) -> Column:
    """Row idx[0] of `c` (any type, strings too) as a `cap`-row state
    column that holds it in row 0 alone, null unless `valid`."""
    taken = c.take(idx[:1].expand(cap))
    row0 = torch.arange(cap, device=c.device) < 1
    return taken.with_valid(taken.valid & row0 & valid).mask_invalid()


class TpuHashAggregateExec(ExecNode):
    BUCKETS = 1024

    def __init__(self, grouping: Sequence[E.Expression],
                 group_names: Sequence[str],
                 aggregates: Sequence[AggregateExpression], child: ExecNode):
        super().__init__(child)
        self.grouping = list(grouping)
        self.group_names = list(group_names)
        self.aggregates = list(aggregates)
        fields = [StructField(n, g.dtype)
                  for n, g in zip(group_names, grouping)]
        fields += [StructField(a.output_name or a.func.lower(), a.dtype)
                   for a in self.aggregates]
        self._schema = Schema(fields)
        state = [StructField(f"_k{i}", g.dtype)
                 for i, g in enumerate(self.grouping)]
        for ai, a in enumerate(self.aggregates):
            state += [StructField(f"_a{ai}_{s}", dt)
                      for s, dt in _agg_state_fields(a)]
        self._state_schema = Schema(state)
        self.packed = True
        # which path each input batch's update took, this execution
        self.update_paths = {"bucket": 0, "sort": 0}
        # a distinct dedup runs inside one update: the planner puts a
        # coalesce of the input into one batch under this exec
        self.child_coalesce_goal = ("single" if self._distinct_child()
                                    is not None else None)

    @property
    def schema(self):
        return self._schema

    def _distinct_child(self):
        """The one child that distinct Sum, Count and Average dedup, or
        None (the planner refuses two)."""
        for a in self.aggregates:
            if a.distinct and a.func in ("Sum", "Count", "Average") \
                    and a.child is not None:
                return a.child
        return None

    def _positions(self, live, order, gid, live_s, cap):
        """{"First"/"Last": (each group's winning row as an index of the
        batch, its rank among the batch's live rows)} for the functions
        the aggregates hold.  A state's position is that rank plus the
        live rows of every earlier batch."""
        funcs = sorted({a.func for a in self.aggregates
                        if a.func in ("First", "Last")})
        if not funcs:
            return {}
        pos = (K.cumsum(live.long()) - 1)[order.long()]
        picks = _first_last([(f, pos) for f in funcs], gid, live_s, cap)
        return {f: (order[win], best) for f, (best, win) in zip(funcs, picks)}

    # ---- per-batch kernels --------------------------------------------------

    def _finish_state(self, cols, sel) -> ColumnarBatch:
        """Zero the dead state rows (string keys keep their bytes)."""
        cols = [c.with_valid(c.valid & sel).mask_invalid()
                if not c.dtype.is_string else c for c in cols]
        return ColumnarBatch(cols, sel, self._state_schema)

    def _first_rows(self, order, gid, live_s, cap):
        """Original index of each group's first sorted row."""
        iota = torch.arange(cap, dtype=torch.int64, device=gid.device)
        first_pos = _seg_min(iota, gid, live_s, cap, _I64_MAX)
        return order[first_pos.clamp(0, cap - 1)]

    def _update_kernel(self, batch: ColumnarBatch,
                       offset: int = 0) -> ColumnarBatch:
        """Input batch -> state batch (sort path).  `offset`: the live rows
        of the earlier batches (First/Last positions)."""
        cap = batch.capacity
        keys = [g.eval(batch) for g in self.grouping]
        live = batch.sel
        dchild = self._distinct_child()
        dval = dchild.eval(batch) if dchild is not None else None
        order, gid, boundary, ngroups = group_rows(
            keys, live, self.packed, [dval] if dval is not None else ())
        o = order.long()
        live_s = live[o]
        gid = torch.where(live_s, gid, cap - 1)
        dedup = None
        if dval is not None:
            # the first row of each (group, value) run
            dedup = boundary | _col_differs_from_prev(dval.take(order))
            dedup[0] = True
        first_idx = self._first_rows(order, gid, live_s, cap)
        state = [k.take(first_idx) for k in keys]
        picks = self._positions(live, order, gid, live_s, cap)
        for a in self.aggregates:
            if a.func in ("First", "Last"):
                widx, best = picks[a.func]
                state += [a.child.eval(batch).take(widx),
                          Column(best + offset, _ones(cap, batch.device),
                                 LongType)]
                continue
            col = a.child.eval(batch).take(order) \
                if a.child is not None else None
            state.extend(_update_one(a, col, gid, live_s, cap, dedup))
        sel = torch.arange(cap, device=batch.device) < ngroups
        return self._finish_state(state, sel)

    def _bucketable(self) -> bool:
        """Every aggregate has a scatter-computable state: no distinct
        dedup, no arrival order (First/Last), no string min/max."""
        if not self.grouping:
            return False
        return not any(a.distinct or a.func in ("First", "Last")
                       or (a.func in ("Min", "Max")
                           and a.child.dtype.is_string)
                       for a in self.aggregates)

    def _bucket_update_kernel(self, batch: ColumnarBatch):
        """-> (clean: bool, state batch at capacity BUCKETS).

        Rows scatter into h1-hash buckets; `clean` checks exactly that
        every live row's key value-equals its bucket representative's, so
        each occupied bucket holds one group.  More groups than buckets
        forces a collision, so high-cardinality batches come back dirty."""
        B = self.BUCKETS
        dev = batch.device
        keys = [g.eval(batch) for g in self.grouping]
        live = batch.sel
        cap = batch.capacity
        h1, _h2 = hash_columns_double(keys, live)
        ids = h1 & (B - 1)
        sid = torch.where(live, ids, B)  # bucket B collects dead rows
        iota = torch.arange(cap, dtype=torch.int32, device=dev)
        rep = torch.zeros(B + 1, dtype=torch.int32, device=dev) \
            .scatter_(0, sid, iota)[:B]
        occ = torch.zeros(B + 1, dtype=torch.bool, device=dev) \
            .scatter_(0, sid, True)[:B]
        rep_of_row = rep[ids]
        eq = torch.ones(cap, dtype=torch.bool, device=dev)
        for k in keys:
            eq &= _key_equal_at(k, rep_of_row)
        clean = bool(torch.all(torch.where(live, eq, True)))
        if not clean:
            return False, None

        def seg(vals, mask, reduce, fill):
            full = torch.where(mask, vals, torch.as_tensor(
                fill, dtype=vals.dtype, device=dev))
            out = _full(B + 1, fill, vals.dtype, dev)
            return out.scatter_reduce_(0, sid, full, reduce)[:B]

        state = [k.take(rep) for k in keys]
        for a in self.aggregates:
            col = a.child.eval(batch) if a.child is not None else None
            f = a.func
            if f == "Count":
                contribute = live if col is None else live & col.valid
                state.append(Column(seg(contribute.long(), live, "sum", 0),
                                    _ones(B, dev), LongType))
                continue
            contribute = live & col.valid
            nvalid = seg(contribute.long(), live, "sum", 0)
            if f in ("Sum", "Average"):
                out_t = DoubleType if f == "Average" else a.dtype
                s = seg(col.data.to(out_t.torch_dtype), contribute, "sum", 0)
                state.append(Column(s, nvalid > 0, out_t).mask_invalid())
                if f == "Average":
                    state.append(Column(nvalid, _ones(B, dev), LongType))
                continue
            dt = a.child.dtype
            v = col.data
            if dt.is_floating:
                # Spark float order: NaN greatest, -0.0 == 0.0
                isnan = torch.isnan(v)
                v = torch.where(v == 0.0, torch.zeros((), dtype=v.dtype,
                                                      device=dev), v)
                nn_mask = contribute & ~isnan
                n_nonnan = seg(nn_mask.long(), live, "sum", 0)
                if f == "Min":
                    m = seg(v, nn_mask, "amin", _type_max(dt))
                    m = torch.where((nvalid > 0) & (n_nonnan == 0),
                                    float("nan"), m)
                else:
                    m = seg(v, nn_mask, "amax", _type_min(dt))
                    m = torch.where(nvalid > n_nonnan, float("nan"), m)
            elif f == "Min":
                m = seg(v, contribute, "amin", _type_max(dt))
            else:
                m = seg(v, contribute, "amax", _type_min(dt))
            state.append(Column(m, nvalid > 0, dt).mask_invalid())
        return True, self._finish_state(state, occ)

    def _merge_kernel(self, state: ColumnarBatch) -> ColumnarBatch:
        """Concatenated partial states -> merged state batch."""
        cap = state.capacity
        nkeys = len(self.grouping)
        keys = list(state.columns[:nkeys])
        live = state.sel
        order, gid, _b, ngroups = group_rows(keys, live, self.packed)
        live_s = live[order.long()]
        gid = torch.where(live_s, gid, cap - 1)
        out = [k.take(self._first_rows(order, gid, live_s, cap))
               for k in keys]
        per_agg = []
        ci = nkeys
        for a in self.aggregates:
            nfields = len(_agg_state_fields(a))
            per_agg.append([c.take(order)
                            for c in state.columns[ci:ci + nfields]])
            ci += nfields
        # every First/Last keeps its least/greatest position: one pass
        picks = iter(_first_last(
            [(a.func, cols[1].data) for a, cols in zip(self.aggregates,
                                                       per_agg)
             if a.func in ("First", "Last")], gid, live_s, cap))
        for a, cols in zip(self.aggregates, per_agg):
            f = a.func
            if f in ("First", "Last"):
                best, win = next(picks)
                out += [cols[0].take(win),
                        Column(best, _ones(cap, gid.device), LongType)]
            elif f == "Count":
                s = _seg_multi([("sum", cols[0].data,
                                 live_s & cols[0].valid, 0)], gid, cap)[0]
                out.append(Column(s, _ones(cap, gid.device), LongType))
            elif f == "Sum":
                contribute = live_s & cols[0].valid
                s, nvalid = _seg_multi(
                    [("sum", cols[0].data, contribute, 0),
                     ("sum", contribute.long(), live_s, 0, True)], gid, cap)
                out.append(Column(s, nvalid > 0, cols[0].dtype)
                           .mask_invalid())
            elif f == "Average":
                contribute = live_s & cols[0].valid
                # the count column holds per-partial counts, not 0/1 flags
                s, n = _seg_multi(
                    [("sum", cols[0].data, contribute, 0),
                     ("sum", cols[1].data, live_s & cols[1].valid, 0)],
                    gid, cap)
                out.append(Column(s, n > 0, DoubleType).mask_invalid())
                out.append(Column(n, _ones(cap, gid.device), LongType))
            elif cols[0].dtype.is_string:  # Min / Max
                out.append(_minmax_string(f, cols[0], gid,
                                          live_s & cols[0].valid, cap))
            else:
                out.append(_minmax(f, cols[0].dtype, cols[0].data, gid,
                                   live_s & cols[0].valid, cap))
        sel = torch.arange(cap, device=gid.device) < ngroups
        return self._finish_state(out, sel)

    def _finalize_kernel(self, state: ColumnarBatch) -> ColumnarBatch:
        nkeys = len(self.grouping)
        out = list(state.columns[:nkeys])
        ci = nkeys
        for a in self.aggregates:
            nfields = len(_agg_state_fields(a))
            cols = state.columns[ci:ci + nfields]
            ci += nfields
            if a.func == "Average":
                s, n = cols[0], cols[1]
                nz = n.data > 0
                avg = s.data / torch.where(nz, n.data, 1).to(torch.float64)
                out.append(Column(avg, s.valid & nz, DoubleType)
                           .mask_invalid())
            else:  # a First/Last value, or a sum/count/min/max
                c = cols[0]
                if c.dtype is not a.dtype:
                    c = Column(c.data.to(a.dtype.torch_dtype), c.valid,
                               a.dtype)
                out.append(c)
        return ColumnarBatch(out, state.sel, self._schema)

    def _global_kernel(self, batch: ColumnarBatch,
                       offset: int = 0) -> ColumnarBatch:
        """No grouping keys: masked whole-batch reductions to a one-row
        state.  `offset`: the live rows of the earlier batches."""
        live = batch.sel
        dev = batch.device
        cap = 8
        n = batch.capacity
        one_group = torch.zeros(n, dtype=torch.int32, device=dev)
        any_live = live.any()
        dchild = self._distinct_child()
        first_occ = None
        if dchild is not None:
            # the first row of each run of equal values, in value order
            dval = dchild.eval(batch)
            dorder = group_rows([], live, self.packed, [dval])[0].long()
            occ = _col_differs_from_prev(dval.take(dorder))
            occ[0] = True
            first_occ = torch.zeros(n, dtype=torch.bool,
                                    device=dev).scatter_(0, dorder, occ)
        picks = self._positions(live, torch.arange(n, device=dev), one_group,
                                live, 1)
        cols: List[Column] = []
        for a in self.aggregates:
            col = a.child.eval(batch) if a.child is not None else None
            f = a.func
            if f in ("First", "Last"):
                widx, best = picks[f]
                # no live row: a null value and a position every merge
                # passes over
                cols += [_row_col(col, widx, any_live, cap),
                         _scalar_col(torch.where(any_live, best + offset,
                                                 best)[0],
                                     True, LongType, cap, dev)]
                continue
            live_c = live & first_occ if a.distinct and f in (
                "Sum", "Count", "Average") and first_occ is not None \
                else live
            if f == "Count":
                contribute = live_c if col is None else live_c & col.valid
                cols.append(_scalar_col(contribute.long().sum(), True,
                                        LongType, cap, dev))
                continue
            contribute = live_c & col.valid
            nvalid = contribute.long().sum()
            if f in ("Sum", "Average"):
                out_t = DoubleType if f == "Average" else a.dtype
                v = torch.where(contribute, col.data.to(out_t.torch_dtype),
                                0).sum()
                cols.append(_scalar_col(v, nvalid > 0, out_t, cap, dev))
                if f == "Average":
                    cols.append(_scalar_col(nvalid, True, LongType, cap,
                                            dev))
            elif col.dtype.is_string:  # Min / Max
                mm = _minmax_string(f, col, one_group, contribute, 1)
                cols.append(_row_col(mm, torch.zeros(1, dtype=torch.int64,
                                                     device=dev),
                                     mm.valid[0], cap))
            else:
                mm = _minmax(f, col.dtype, col.data, one_group, contribute,
                             1)
                cols.append(_scalar_col(mm.data[0], mm.valid[0], col.dtype,
                                        cap, dev))
        sel = torch.arange(cap, device=dev) < 1
        return ColumnarBatch(cols, sel, self._state_schema)

    # ---- execution ----------------------------------------------------------

    def execute(self, ctx: ExecContext):
        self.packed = ctx.conf.get(SORT_PACKED_ENABLED)
        self.update_paths = {"bucket": 0, "sort": 0}
        grouped = bool(self.grouping)
        fan_in = max(2, ctx.conf.get(AGG_MERGE_FAN_IN))
        probe = self._bucketable() and ctx.conf.get(AGG_BUCKET_GROUPS)

        def fold(state, pending):
            parts = ([state] if state is not None else []) + pending
            if len(parts) == 1:
                return parts[0]
            return self._merge_kernel(concat_batches(parts, self.packed))

        # First/Last positions count the live rows of earlier batches
        needs_offset = any(a.func in ("First", "Last")
                           for a in self.aggregates)
        offset = 0
        state = None
        pending: list = []
        for batch in self.children[0].execute(ctx):
            # the update sorts at batch capacity: shrink a mostly-dead
            # batch (after a selective filter) first
            n_live = None
            if batch.capacity >= 8192:
                n_live = batch.num_rows_host()
                batch = batch.maybe_shrink(n_live)
            if not grouped:
                partial = self._global_kernel(batch, offset)
            else:
                partial = None
                if probe:
                    clean, partial = self._bucket_update_kernel(batch)
                    # a high-cardinality input stays dirty: stop probing
                    probe = clean
                if partial is not None:
                    self.update_paths["bucket"] += 1
                else:
                    partial = self._update_kernel(batch, offset)
                    self.update_paths["sort"] += 1
            if needs_offset:
                offset += n_live if n_live is not None \
                    else batch.num_rows_host()
            pending.append(partial)
            # hold no input batch while the stream makes the next one
            del batch, partial
            if len(pending) >= fan_in:
                state = fold(state, pending)
                pending = []
        if pending:
            state = fold(state, pending)
        if state is None:
            if grouped:
                return
            # a global aggregate over no input still yields one row
            child_schema = self.children[0].schema
            empty = ColumnarBatch.from_numpy(
                {f.name: [] for f in child_schema}, child_schema, ctx.device)
            state = self._global_kernel(empty)
        yield self._finalize_kernel(state)
