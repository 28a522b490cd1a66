"""Hash join: inner, left outer, full outer, left_semi and left_anti
equi-joins (port of spark_rapids_tpu/exec/join.py); a right outer join
arrives as a left outer join with its sides swapped (plan/physical.py).

No hash table: the join is a sort and a binary search, shaped like cuDF's
count-then-gather join API, as in the JAX package.

  1. BUILD: hash the build keys (h1, 64 bits) and sort the build batch by
     it, dead rows (h1 all ones) last: the packed argsort (utils/
     packed_sort, K3 on the card) when the capacity is a power of two,
     else a stable argsort.  Once per join; every stream batch reuses it.
  2. WINDOW: per stream row, `searchsorted` of its h1 in the sorted build
     hashes gives a candidate window [lo, hi).  One host read takes the
     widest window, `max_dup`.
  3. COUNT: a loop over d < max_dup counts, per stream row, the build rows
     lo + d whose keys really equal its own (hash collisions are rejected
     here) and that pass the residual condition.  Semi and anti joins end
     here: they keep the stream rows with counts > 0 or == 0.  Left and
     full joins count a live stream row without a match (a null key too)
     as 1.
  4. GATHER: `starts` is the exclusive prefix sum of the counts; a second
     host read takes the total, which sets the output capacity.  The same
     loop writes each match's (stream row, build row) pair to slot
     starts[i] + rank[i], so the output comes by stream row, then by build
     position, as in the JAX package.  A left or full join writes a stream
     row without a match to its slot starts[i] with `matched` false, and
     its right columns come out null (zeros in the slots).
  5. TAIL (full joins): a mask over the sorted build batch, ORed across
     the stream batches, marks the build rows that matched; after the last
     stream batch, the build rows it leaves out come once more with every
     left column null, in the build's sorted order (one host read, their
     count, as in the JAX package).

Keys compare with Spark's semantics: a null key matches nothing, NaN
equals NaN, -0.0 equals 0.0, strings compare by length and bytes.  A
stream row with a null key gets an empty window, since it cannot match.

Left out of the JAX module, with where each goes:
  * `execute_with_cpu_fallback` and `_cpu_twin`: the port has no CPU
    executor and no fallback;
  * `run_retryable` and `ctx.runtime.reserve`: the device memory runtime
    (ROADMAP Queue 1 item 5);
  * `cached_kernel` and the speculative `max_dup` guess, which exist to
    reuse compiled programs: the port runs eagerly (item 8);
  * `record_cost` and the metrics timers (item 12);
  * TpuShuffledHashJoinExec, which needs the exchange (item 9).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..columnar import Column, ColumnarBatch, bucket_rows, concat_batches
from ..config import SORT_PACKED_ENABLED
from ..ops import expressions as E
from ..ops import kernels as K
from ..ops.hashing import _normalize_bits, hash_columns_h1
from ..types import Schema, StructField
from ..utils import packed_sort as PS
from .base import ExecContext, ExecNode, map_batches

_SIGN = -(1 << 63)  # xor flips unsigned order into signed order


def _key_bits(c: Column) -> Optional[torch.Tensor]:
    """The bits a non-string key compares by (None for strings)."""
    return None if c.dtype.is_string else _normalize_bits(c)


def _row_equal(lcol: Column, lbits, bcol: Column, bbits,
               bidx: torch.Tensor) -> torch.Tensor:
    """Per stream row, whether lcol[i] equals bcol[bidx[i]] as a join key
    (null keys never match).  `lbits`/`bbits` are the columns' _key_bits;
    `bidx` is in range."""
    ok = lcol.valid & bcol.valid[bidx]
    if lcol.dtype.is_string:
        ok &= lcol.lengths == bcol.lengths[bidx]
        width = min(lcol.max_len, bcol.max_len)
        bdata = bcol.data[bidx, :width]
        pos = torch.arange(width, device=bidx.device)[None, :]
        in_str = pos < lcol.lengths[:, None]
        same = torch.where(in_str, lcol.data[:, :width] == bdata, True)
        ok &= same.all(dim=1)
    else:
        ok &= lbits == bbits[bidx]
    return ok


def _empty_batch(schema: Schema, device) -> ColumnarBatch:
    return ColumnarBatch.from_numpy({f.name: [] for f in schema}, schema,
                                    device)


def joined_schema(lschema: Schema, rschema: Schema) -> Schema:
    """The schema of a joined pair of rows: left fields as they are, right
    fields renamed `name_r` where a left field has the name.  The one
    definition the residual condition is resolved against, the pair view
    evaluates it over, and a side-swapped join's output takes."""
    return Schema(list(lschema.fields) + [
        StructField(f.name + "_r" if f.name in lschema.names else f.name,
                    f.dtype) for f in rschema])


class TpuReorderColumnsExec(ExecNode):
    """Selects and reorders a side-swapped join's [R..., L...] output back
    to the logical plan's column order (and drops a USING join's repeated
    keys)."""

    def __init__(self, child: ExecNode, perm: Sequence[int],
                 out_schema: Schema):
        super().__init__(child)
        self.perm = list(perm)
        self._schema = out_schema

    @property
    def schema(self):
        return self._schema

    def execute(self, ctx):
        yield from map_batches(
            self.children[0].execute(ctx),
            lambda b: b.select_columns(self.perm, self._schema))


class _Build:
    """The sorted build side: batch, keys and their _key_bits, and the
    sorted h1 in signed order (for searchsorted)."""

    def __init__(self, batch, keys, bits, h1s):
        self.batch = batch
        self.keys = keys
        self.bits = bits
        self.h1s = h1s


class TpuHashJoinExec(ExecNode):
    """Equi hash join streaming the LEFT child against one sorted build
    batch of the RIGHT child: inner, left, full, left_semi or left_anti
    (a right join comes side-swapped under TpuReorderColumnsExec)."""

    def __init__(self, left: ExecNode, right: ExecNode, join_type: str,
                 left_keys: Sequence[E.Expression],
                 right_keys: Sequence[E.Expression],
                 condition: Optional[E.Expression], out_schema: Schema,
                 using_drop: Optional[List[int]] = None):
        super().__init__(left, right)
        if join_type not in ("inner", "left", "full", "left_semi",
                             "left_anti"):
            raise ValueError(f"no {join_type} join in the port")
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self._schema = out_schema
        self.using_drop = using_drop or []
        self.build_sorts: Optional[int] = None  # K3 launches of the build

    @property
    def schema(self):
        return self._schema

    # ---- phases -------------------------------------------------------------

    def _build(self, rbatch: ColumnarBatch, packed: bool) -> _Build:
        """Sort the build batch by key hash; dead rows last."""
        keys = [e.eval(rbatch) for e in self.right_keys]
        h1 = hash_columns_h1(keys, rbatch.sel)
        cap = rbatch.capacity
        if packed and cap & (cap - 1) == 0:
            order = PS.packed_argsort([(h1, 64)], cap).long()
        else:
            order = torch.argsort(h1 ^ _SIGN, stable=True)
        skeys = [k.take(order) for k in keys]
        return _Build(rbatch.take(order), skeys,
                      [_key_bits(k) for k in skeys], h1[order] ^ _SIGN)

    def _pair_condition_ok(self, lbatch: ColumnarBatch,
                           build: ColumnarBatch, bidx: torch.Tensor):
        """Residual condition of the candidate pairs (stream row i, build
        row bidx[i]), evaluated over a joined-schema view."""
        rcols = [c.take(bidx) for c in build.columns]
        pair = ColumnarBatch(list(lbatch.columns) + rcols, lbatch.sel,
                             joined_schema(lbatch.schema, build.schema))
        cond = self.condition.eval(pair)
        return cond.valid & cond.data

    def _probe(self, lbatch: ColumnarBatch, b: _Build):
        """-> (max_dup, match): the widest candidate window (one host
        read), and match(d) -> (ok, bidx), the verified pairs of each
        stream row with the build row at offset d of its window."""
        keys = [e.eval(lbatch) for e in self.left_keys]
        bits = [_key_bits(k) for k in keys]
        live = lbatch.sel
        q = hash_columns_h1(keys, live) ^ _SIGN
        lo = torch.searchsorted(b.h1s, q, side="left")
        hi = torch.searchsorted(b.h1s, q, side="right")
        can_match = live
        for k in keys:
            can_match = can_match & k.valid
        width = torch.where(can_match, hi - lo, 0)
        max_dup = int(width.max()) if width.numel() else 0
        cap_b = b.batch.capacity
        bsel = b.batch.sel

        def match(d: int):
            bidx = (lo + d).clamp(0, cap_b - 1)
            ok = can_match & (lo + d < hi) & bsel[bidx]
            for lk, lb, bk, bb in zip(keys, bits, b.keys, b.bits):
                ok &= _row_equal(lk, lb, bk, bb, bidx)
            if self.condition is not None:
                ok &= self._pair_condition_ok(lbatch, b.batch, bidx)
            return ok, bidx
        return max_dup, match

    def _join_batch(self, lbatch: ColumnarBatch, b: _Build,
                    hit: Optional[torch.Tensor]) -> ColumnarBatch:
        """One stream batch joined with the build.  A full join sets
        hit[j] for every build row j it matches (`hit` has one more slot,
        where the pairs that do not match write)."""
        max_dup, match = self._probe(lbatch, b)
        cap = lbatch.capacity
        dev = lbatch.device
        counts = torch.zeros(cap, dtype=torch.int64, device=dev)
        for d in range(max_dup):
            counts += match(d)[0]
        if self.join_type in ("left_semi", "left_anti"):
            keep = counts > 0 if self.join_type == "left_semi" \
                else counts == 0
            out = lbatch.filter(keep)
            return ColumnarBatch(out.columns, out.sel, self._schema)
        outer = self.join_type != "inner"
        if outer:
            # a live stream row without a match keeps one slot
            alone = lbatch.sel & (counts == 0)
            counts = counts + alone
        starts = torch.cumsum(counts, 0) - counts
        total = int(counts.sum())
        out_cap = bucket_rows(max(total, 1))
        rows = torch.arange(cap, dtype=torch.int64, device=dev)
        # pairs that do not match write to their row's own slot past out_cap
        trash = out_cap + rows
        l_idx = torch.zeros(out_cap + cap, dtype=torch.int64, device=dev)
        b_idx = torch.zeros(out_cap + cap, dtype=torch.int64, device=dev)
        matched = torch.zeros(out_cap + cap, dtype=torch.bool, device=dev) \
            if outer else None
        rank = torch.zeros(cap, dtype=torch.int64, device=dev)
        cap_b = b.batch.capacity
        for d in range(max_dup):
            ok, bidx = match(d)
            slot = torch.where(ok, starts + rank, trash)
            l_idx.scatter_(0, slot, rows)
            b_idx.scatter_(0, slot, bidx)
            if outer:
                matched.scatter_(0, slot, ok)
            if hit is not None:
                hit[torch.where(ok, bidx, cap_b)] = True
            rank += ok
        rcols = [c.take(b_idx[:out_cap]) for c in b.batch.columns]
        if outer:
            # the row without a match takes its slot starts[i], `matched`
            # false there: its right columns are null, their slots zeros
            l_idx.scatter_(0, torch.where(alone, starts, trash), rows)
            m = matched[:out_cap]
            rcols = [c.with_valid(c.valid & m).mask_invalid() for c in rcols]
        cols = [c.take(l_idx[:out_cap]) for c in lbatch.columns] + rcols
        out = ColumnarBatch(self._drop_using(cols),
                            torch.arange(out_cap, device=dev) < total,
                            self._schema)
        out.known_rows = total
        return out

    def _tail(self, b: _Build, hit: torch.Tensor) -> Optional[ColumnarBatch]:
        """A full join's build rows that no stream row matched, every left
        column null, in the build's sorted order; None when there are
        none (one host read, their count)."""
        build = b.batch
        cols = [Column.all_null(f.dtype, build.capacity, build.device)
                for f in self.children[0].schema] + list(build.columns)
        out = ColumnarBatch(self._drop_using(cols),
                            build.sel & ~hit[:build.capacity], self._schema)
        out.known_rows = int(out.num_rows())
        return out if out.known_rows else None

    def _drop_using(self, cols: List[Column]) -> List[Column]:
        return [c for i, c in enumerate(cols) if i not in self.using_drop]

    # ---- execution ------------------------------------------------------

    def _build_batch(self, ctx: ExecContext) -> ColumnarBatch:
        """The right child as one batch, shrunk when mostly dead."""
        batches = list(self.children[1].execute(ctx))
        if not batches:
            return _empty_batch(self.children[1].schema, ctx.device)
        batch = batches[0] if len(batches) == 1 else concat_batches(
            batches, ctx.conf.get(SORT_PACKED_ENABLED))
        return batch.maybe_shrink(batch.num_rows_host())

    def execute(self, ctx: ExecContext):
        rbatch = self._build_batch(ctx)
        before = K.sort_words.launches
        build = self._build(rbatch, ctx.conf.get(SORT_PACKED_ENABLED))
        self.build_sorts = K.sort_words.launches - before
        # full join: the build rows matched by any stream batch so far
        hit = torch.zeros(build.batch.capacity + 1, dtype=torch.bool,
                          device=ctx.device) \
            if self.join_type == "full" else None
        yield from map_batches(
            self.children[0].execute(ctx),
            lambda lbatch: self._join_batch(lbatch, build, hit))
        if hit is not None:
            tail = self._tail(build, hit)
            if tail is not None:
                yield tail
