"""Physical planning: a direct conversion of the logical plan into the
port's execs.

The JAX package tags every node for the device or the CPU
(plan/tagging.py, overrides.py) and inserts transitions between them
(transitions.py).  The port has no CPU executor, so none of that applies
yet: every node becomes its device exec, and a node, expression or
aggregate outside the slice raises NotImplementedError here, at planning
time, as does a union whose children differ in arity or in a column's
type (the JAX package widens no type, and cannot run such a union
whole), a cast the JAX package's tagging sends to its CPU executor
(string -> timestamp without castStringToTimestamp, string -> float or
double without castStringToFloat), and an aggregate list it sends there
(Percentile, distinct First or Last, two distinct children).  An
aggregate that dedups a distinct child reads its input through a
TpuCoalesceBatchesExec: its update must see every row in one batch.
A distinct is a hash aggregate over every column with no aggregate
expression, as Spark plans it.  A window node becomes a TpuWindowExec
over a TpuCoalesceBatchesExec with the "target" goal (the JAX package's
insert_coalesce); a window function both packages refuse raises
AnalysisError, and one the JAX package sends to its CPU executor (a
bounded Min/Max frame wider than MAX_BOUNDED_MINMAX_WIDTH rows, a string
Min/Max whose frame start is bounded) NotImplementedError.  The session
prunes the scans' columns first (plan/pushdown.py).

A join is planned by the JAX package's rules (its plan/physical.py), so
both packages choose the same exec and the same build side:
  * a right outer join is a left outer join with the sides swapped (the
    columns reordered back after, a USING key taken from the right
    side), decided before the rules below, so they apply to it;
  * an inner join without a residual condition builds its left child
    instead (the sides swapped, the columns reordered back after) when
    that child is hinted for broadcast, or estimated at less than half
    the right child's bytes, unless the right child is hinted;
  * the build side is broadcast when hinted or estimated at most
    `spark.sql.autoBroadcastJoinThreshold` bytes, except in a full outer
    join, which never broadcasts (its tail is emitted once per stream);
  * otherwise the JAX package partitions the join when the build side
    is estimated above `spark.rapids.sql.tpu.join.partitioned.threshold`
    (or unknown).  The port has no exchange yet, so it raises there
    unless `spark.rapids.sql.tpu.join.partitioned.enabled` is false, and
    builds the whole right side as one batch.
Estimates are the JAX package's: rows from the scans (kept through row-
local nodes and windows, a limit's n, one row for a global aggregate,
the larger side for a join, the left side for semi/anti, a distinct's
child's, the sum of a union's children, an expand's child's times its
projections) times the output schema's width (strings at 32 bytes); a
scan's bytes are its table's.
"""
from __future__ import annotations

from typing import Optional

from ..config import (AUTO_BROADCAST_JOIN_THRESHOLD, CAST_STRING_TO_FLOAT,
                      CAST_STRING_TO_TIMESTAMP, PARTITIONED_JOIN_ENABLED,
                      PARTITIONED_JOIN_THRESHOLD, VARIABLE_FLOAT_AGG,
                      TpuConf)
from ..exec.aggregate import TpuHashAggregateExec
from ..exec.base import ExecNode
from ..exec.basic import (TpuCoalesceBatchesExec, TpuExpandExec,
                          TpuFilterExec, TpuGlobalLimitExec, TpuProjectExec,
                          TpuScanMemoryExec, TpuUnionExec)
from ..exec.broadcast import TpuBroadcastExchangeExec, TpuBroadcastHashJoinExec
from ..exec.join import TpuHashJoinExec, TpuReorderColumnsExec, joined_schema
from ..exec.sort import TpuSortExec
from ..exec.window import TpuWindowExec
from ..ops.aggregates import AggregateExpression
from ..ops.cast import Cast
from ..ops.expressions import Expression
from ..ops.windows import WindowUnsupported, resolve_window_func
from ..types import Schema, StringType, StructField, TimestampType
from . import logical as L
from .analysis import AnalysisError, resolve, resolve_join


def _resolved(ce: L.ColumnExpr, schema: Schema, conf: TpuConf
              ) -> Expression:
    return _gated(resolve(ce, schema), conf)


def _gated(e: Expression, conf: TpuConf) -> Expression:
    """`e`, checked for a string -> timestamp cast and a string -> float
    or double cast, folded string literals' among them, which the JAX
    package runs on its device only when castStringToTimestamp and
    castStringToFloat are true (its CPU executor runs them otherwise;
    the port has none, so it raises)."""
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, Cast) and x.child.dtype is StringType:
            if x.to is TimestampType \
                    and not conf.get(CAST_STRING_TO_TIMESTAMP):
                raise NotImplementedError(
                    "cast string -> timestamp supports only a subset of "
                    f"formats; set {CAST_STRING_TO_TIMESTAMP.key}=true to "
                    "run it")
            if x.to.is_floating and not conf.get(CAST_STRING_TO_FLOAT):
                raise NotImplementedError(
                    f"cast string -> {x.to.name} can differ from Spark in "
                    f"corner cases; set {CAST_STRING_TO_FLOAT.key}=true to "
                    "run it")
        stack.extend(x.children)
    return e


def plan_schema(plan: L.LogicalPlan, conf: TpuConf) -> Schema:
    if isinstance(plan, L.LogicalScan):
        return plan.schema
    if isinstance(plan, (L.LogicalFilter, L.LogicalSort, L.LogicalLimit,
                         L.LogicalDistinct, L.LogicalUnion)):
        # a union takes its first child's names and types
        return plan_schema(plan.children[0], conf)
    if isinstance(plan, L.LogicalExpand):
        child = plan_schema(plan.children[0], conf)
        return Schema([StructField(ce.output_name, resolve(ce, child).dtype)
                       for ce in plan.projections[0]])
    if isinstance(plan, (L.LogicalProject, L.LogicalAggregate)):
        child = plan_schema(plan.children[0], conf)
        exprs = (plan.exprs if isinstance(plan, L.LogicalProject)
                 else plan.grouping + plan.aggregates)
        return Schema([StructField(ce.output_name, resolve(ce, child).dtype)
                       for ce in exprs])
    if isinstance(plan, L.LogicalWindow):
        child = plan_schema(plan.children[0], conf)
        return Schema(list(child.fields)
                      + [StructField(f.name, f.dtype)
                         for f in window_funcs(plan, child, device=False)])
    if isinstance(plan, L.LogicalJoin):
        ls = plan_schema(plan.children[0], conf)
        rs = plan_schema(plan.children[1], conf)
        if plan.join_type in ("left_semi", "left_anti"):
            return ls
        if plan.using:
            return Schema(list(ls.fields)
                          + [f for f in rs if f.name not in plan.using])
        return Schema(list(ls.fields) + list(rs.fields))
    raise NotImplementedError(
        f"{type(plan).__name__} is not in the port's slice")


def _aggregate(plan: L.LogicalAggregate, child: ExecNode,
               conf: TpuConf) -> TpuHashAggregateExec:
    schema = child.schema
    aggs = []
    for ce in plan.aggregates:
        a = _resolved(ce, schema, conf)
        if not isinstance(a, AggregateExpression):
            raise NotImplementedError(
                f"{ce!r} in an agg list is not an aggregate function")
        # the JAX package runs the next two on its CPU executor (tagging,
        # overrides); the port has none, so it raises
        if a.func == "Percentile":
            raise NotImplementedError(
                "percentile is not supported on the device: the JAX "
                "package runs it on its CPU executor, which is not ported")
        if a.distinct and a.func in ("First", "Last"):
            raise NotImplementedError(
                f"distinct {a.func} is not supported on the device")
        if a.func in ("Sum", "Average") and a.child.dtype.is_floating \
                and not conf.get(VARIABLE_FLOAT_AGG):
            # the JAX package runs these on its CPU executor; the port has
            # none, so it asks for the conf rather than fall back
            raise NotImplementedError(
                "float aggregation reduces in a different order than Spark; "
                f"set {VARIABLE_FLOAT_AGG.key}=true to run it")
        aggs.append(a)
    if len({repr(a.child) for a in aggs if a.distinct}) > 1:
        # one sorted pass dedups one distinct child
        raise NotImplementedError(
            "multiple distinct aggregate children are not supported on the "
            "device")
    grouping = [_resolved(ce, schema, conf) for ce in plan.grouping]
    agg = TpuHashAggregateExec(grouping,
                               [ce.output_name for ce in plan.grouping],
                               aggs, child)
    if agg.child_coalesce_goal == "single":
        # the JAX package's insert_coalesce (plan/transitions.py), for the
        # one goal the port has
        agg.children = [TpuCoalesceBatchesExec(child)]
    return agg


def window_funcs(plan: L.LogicalWindow, schema: Schema,
                 device: bool = True) -> list:
    """The window node's functions resolved against its child's schema
    (plan/tagging.py's `_tag_window`): AnalysisError where both packages
    refuse one; with `device`, NotImplementedError where the JAX package
    runs it on its CPU executor, which is not ported."""
    def resolved(on_device):
        funcs = []
        for ce in plan.window_exprs:
            func_ce, spec = ce.args
            f = resolve_window_func(func_ce, spec, schema, resolve,
                                    device=on_device)
            f.name = ce.output_name
            funcs.append(f)
        return funcs
    try:
        return resolved(device)
    except WindowUnsupported as e:
        try:
            resolved(False)
        except WindowUnsupported as e2:
            raise AnalysisError(f"window: {e2}") from e2
        raise NotImplementedError(
            f"window: {e}: the JAX package runs this window on its CPU "
            "executor, which is not ported") from e


def _window(plan: L.LogicalWindow, child: ExecNode, conf: TpuConf
            ) -> TpuWindowExec:
    schema = child.schema
    funcs = window_funcs(plan, schema)
    for f in funcs:
        if f.child is not None:
            _gated(f.child, conf)
    if not isinstance(child, TpuCoalesceBatchesExec):
        child = TpuCoalesceBatchesExec(child, goal="target")
    return TpuWindowExec([_resolved(ce, schema, conf)
                          for ce in plan.partition_by],
                         [_resolved(o.child, schema, conf)
                          for o in plan.order_by],
                         [o.ascending for o in plan.order_by],
                         [o.effective_nulls_first for o in plan.order_by],
                         funcs, child)


def _union(children) -> TpuUnionExec:
    """A union of children alike in arity and in every column's type.
    The JAX package checks neither: it concatenates the batches by
    position and fails, or promotes, where they differ (its collect
    raises for any two schemas that differ, names included)."""
    first = children[0].schema
    for c in children[1:]:
        s = c.schema
        if len(s) != len(first) or any(a.dtype is not b.dtype
                                        for a, b in zip(first, s)):
            raise NotImplementedError(
                f"a union of {first!r} and {s!r}: its children differ in "
                "arity or in a column's type, which the JAX package cannot "
                "evaluate (it widens no type)")
    return TpuUnionExec(children)


def convert(plan: L.LogicalPlan, conf: TpuConf) -> ExecNode:
    """Logical plan -> physical exec tree."""
    if isinstance(plan, L.LogicalScan):
        return TpuScanMemoryExec(plan.table, plan.num_rows, plan.schema)
    if isinstance(plan, L.LogicalUnion):
        return _union([convert(c, conf) for c in plan.children])
    if isinstance(plan, L.LogicalJoin):
        return _join(plan, conf, convert(plan.children[0], conf),
                     convert(plan.children[1], conf))
    child = convert(plan.children[0], conf)
    schema = child.schema
    if isinstance(plan, L.LogicalProject):
        return TpuProjectExec([_resolved(ce, schema, conf)
                               for ce in plan.exprs],
                              [ce.output_name for ce in plan.exprs], child)
    if isinstance(plan, L.LogicalFilter):
        return TpuFilterExec(_resolved(plan.condition, schema, conf), child)
    if isinstance(plan, L.LogicalAggregate):
        return _aggregate(plan, child, conf)
    if isinstance(plan, L.LogicalSort):
        return TpuSortExec([_resolved(o.child, schema, conf)
                            for o in plan.orders],
                           [o.ascending for o in plan.orders],
                           [o.effective_nulls_first for o in plan.orders],
                           child)
    if isinstance(plan, L.LogicalLimit):
        return TpuGlobalLimitExec(plan.n, child)
    if isinstance(plan, L.LogicalDistinct):
        return TpuHashAggregateExec(
            [_resolved(L.col(n), schema, conf) for n in schema.names],
            schema.names, [], child)
    if isinstance(plan, L.LogicalWindow):
        return _window(plan, child, conf)
    if isinstance(plan, L.LogicalExpand):
        return TpuExpandExec([[_resolved(ce, schema, conf) for ce in proj]
                              for proj in plan.projections],
                             [ce.output_name for ce in plan.projections[0]],
                             child)
    raise NotImplementedError(
        f"{type(plan).__name__} is not in the port's slice")


# --------------------------------------------------------------------------
# joins
# --------------------------------------------------------------------------

def _hints(plan: L.LogicalPlan):
    return getattr(plan, "_hints", ())


def _join(plan: L.LogicalJoin, conf: TpuConf, lc: ExecNode,
          rc: ExecNode) -> ExecNode:
    jt, lkeys, rkeys, cond = resolve_join(plan, lc.schema, rc.schema)
    for e in lkeys + rkeys + ([cond] if cond is not None else []):
        _gated(e, conf)
    out_schema = plan_schema(plan, conf)
    using_drop = [len(lc.schema) + rc.schema.index_of(n)
                  for n in plan.using or ()]
    build_plan = plan.children[1]
    join_schema = out_schema
    reorder = None
    build_bytes = None  # the estimate, when the swap check made it
    swap = key_from_right = jt == "right"
    if swap:
        # resolve_join refused a residual here, so none is dropped
        jt = "left"
    elif jt == "inner" and cond is None \
            and "broadcast" not in _hints(plan.children[1]):
        # build the smaller side: the execs always build their right
        # child, so a clearly smaller (or hinted) left child swaps in
        lb = _estimate_plan_bytes(plan.children[0], conf)
        rb = _estimate_plan_bytes(plan.children[1], conf)
        swap = "broadcast" in _hints(plan.children[0]) or (
            lb is not None and rb is not None and lb * 2 < rb)
        build_bytes = lb if swap else rb
    if swap:
        lc, rc = rc, lc
        lkeys, rkeys = rkeys, lkeys
        build_plan, join_schema, using_drop, reorder = _swap_sides(
            plan, conf, key_from_right)

    def wrap(node: ExecNode) -> ExecNode:
        return node if reorder is None \
            else TpuReorderColumnsExec(node, reorder, out_schema)

    if jt != "full" and _should_broadcast_build(conf, build_plan,
                                                build_bytes):
        return wrap(TpuBroadcastHashJoinExec(
            lc, TpuBroadcastExchangeExec(rc), jt, lkeys, rkeys, cond,
            join_schema, using_drop))
    if _should_partition_join(conf, build_plan, build_bytes):
        raise NotImplementedError(
            "this join's build side is estimated above "
            f"{PARTITIONED_JOIN_THRESHOLD.key} (or is of unknown size), so "
            "the JAX package plans a partitioned hash join, whose exchange "
            f"is not ported; set {PARTITIONED_JOIN_ENABLED.key}=false to "
            "build the whole side as one batch")
    return wrap(TpuHashJoinExec(lc, rc, jt, lkeys, rkeys, cond, join_schema,
                                using_drop))


def _swap_sides(plan: L.LogicalJoin, conf: TpuConf, key_from_right: bool):
    """Column bookkeeping for a join run with its children swapped (a
    right outer join, or an inner join building its left child): the
    exec emits [R..., L... renamed on collision], and `reorder` selects
    the logical [L..., R minus USING keys] back.  A USING key comes from
    the right block when `key_from_right` (a right join preserves every
    right row, so Spark's coalesced key is the right side's), else from
    the left (an inner join's values are equal across sides).
    Returns (build_plan, join_schema, using_drop, reorder)."""
    ls = plan_schema(plan.children[0], conf)
    rs = plan_schema(plan.children[1], conf)
    n_l, n_r = len(ls), len(rs)
    if plan.using:
        reorder = [rs.index_of(f.name)
                   if key_from_right and f.name in plan.using else n_r + i
                   for i, f in enumerate(ls)]
        reorder += [i for i, f in enumerate(rs) if f.name not in plan.using]
    else:
        reorder = list(range(n_r, n_r + n_l)) + list(range(n_r))
    return plan.children[0], joined_schema(rs, ls), [], reorder


def _should_partition_join(conf: TpuConf, build_plan: L.LogicalPlan,
                           build_bytes: Optional[int]) -> bool:
    """Whether the JAX package would partition this non-broadcast join:
    its build side is estimated above the threshold, or unknown."""
    if not conf.get(PARTITIONED_JOIN_ENABLED):
        return False
    est = build_bytes if build_bytes is not None \
        else _estimate_plan_bytes(build_plan, conf)
    return est is None or est > int(conf.get(PARTITIONED_JOIN_THRESHOLD))


def _should_broadcast_build(conf: TpuConf, build_plan: L.LogicalPlan,
                            build_bytes: Optional[int]) -> bool:
    """Broadcast the build side when hinted, or when its estimated size is
    at most spark.sql.autoBroadcastJoinThreshold (negative: never)."""
    if "broadcast" in _hints(build_plan):
        return True
    threshold = conf.get(AUTO_BROADCAST_JOIN_THRESHOLD)
    if threshold is None or int(threshold) < 0:
        return False
    est = build_bytes if build_bytes is not None \
        else _estimate_plan_bytes(build_plan, conf)
    return est is not None and est <= int(threshold)


def _schema_row_bytes(schema: Schema) -> int:
    """Estimated bytes per row of a schema (strings at a fixed 32)."""
    total = 0
    for f in schema:
        total += f.dtype.np_dtype.itemsize if f.dtype.np_dtype is not None \
            else 32
    return max(total, 1)


def _estimate_plan_rows(plan: L.LogicalPlan, conf: TpuConf
                        ) -> Optional[int]:
    """Rough output row count, an upper bound where it can be: row-local
    nodes keep their child's (a filter too: guessing its selectivity
    would under-estimate, the side that wrongly broadcasts)."""
    if isinstance(plan, L.LogicalScan):
        return plan.num_rows
    if isinstance(plan, (L.LogicalProject, L.LogicalFilter, L.LogicalSort,
                         L.LogicalDistinct, L.LogicalWindow)):
        return _estimate_plan_rows(plan.children[0], conf)
    if isinstance(plan, L.LogicalUnion):
        parts = [_estimate_plan_rows(c, conf) for c in plan.children]
        return None if any(p is None for p in parts) else sum(parts)
    if isinstance(plan, L.LogicalExpand):
        child = _estimate_plan_rows(plan.children[0], conf)
        return None if child is None else child * len(plan.projections)
    if isinstance(plan, L.LogicalLimit):
        child = _estimate_plan_rows(plan.children[0], conf)
        return plan.n if child is None else min(plan.n, child)
    if isinstance(plan, L.LogicalAggregate):
        if not plan.grouping:
            return 1
        return _estimate_plan_rows(plan.children[0], conf)
    if isinstance(plan, L.LogicalJoin):
        left = _estimate_plan_rows(plan.children[0], conf)
        right = _estimate_plan_rows(plan.children[1], conf)
        if left is None or right is None:
            return None
        if plan.join_type in ("left_semi", "left_anti"):
            return left
        # star-join heuristic: the fact side dominates the output
        return max(left, right)
    return None


def _estimate_plan_bytes(plan: L.LogicalPlan, conf: TpuConf
                         ) -> Optional[int]:
    """Rough output bytes: a scan's table size, else estimated rows times
    the output schema's width."""
    if isinstance(plan, L.LogicalScan):
        return plan.nbytes
    rows = _estimate_plan_rows(plan, conf)
    if rows is None:
        return None
    return rows * _schema_row_bytes(plan_schema(plan, conf))
