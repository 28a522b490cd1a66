"""Physical planning: a direct conversion of the logical plan into the
port's execs.

The JAX package tags every node for the device or the CPU
(plan/tagging.py, overrides.py), inserts transitions between them
(transitions.py) and pushes filters and projections into scans
(pushdown.py).  The port has no CPU executor, so none of that applies
yet: every node becomes its device exec, and a node, expression or
aggregate outside the slice raises NotImplementedError here, at planning
time.
"""
from __future__ import annotations

from ..config import VARIABLE_FLOAT_AGG, TpuConf
from ..exec.aggregate import TpuHashAggregateExec
from ..exec.base import ExecNode
from ..exec.basic import TpuFilterExec, TpuProjectExec, TpuScanMemoryExec
from ..exec.sort import TpuSortExec
from ..ops.aggregates import AggregateExpression
from ..types import Schema, StructField
from . import logical as L
from .analysis import resolve


def plan_schema(plan: L.LogicalPlan, conf: TpuConf) -> Schema:
    if isinstance(plan, L.LogicalScan):
        return plan.schema
    if isinstance(plan, (L.LogicalFilter, L.LogicalSort)):
        return plan_schema(plan.children[0], conf)
    if isinstance(plan, (L.LogicalProject, L.LogicalAggregate)):
        child = plan_schema(plan.children[0], conf)
        exprs = (plan.exprs if isinstance(plan, L.LogicalProject)
                 else plan.grouping + plan.aggregates)
        return Schema([StructField(ce.output_name, resolve(ce, child).dtype)
                       for ce in exprs])
    raise NotImplementedError(
        f"{type(plan).__name__} is not in the port's slice")


def _aggregate(plan: L.LogicalAggregate, child: ExecNode,
               conf: TpuConf) -> TpuHashAggregateExec:
    schema = child.schema
    aggs = []
    for ce in plan.aggregates:
        a = resolve(ce, schema)
        if not isinstance(a, AggregateExpression):
            raise NotImplementedError(
                f"{ce!r} in an agg list is not an aggregate function")
        if a.func in ("Min", "Max") and a.child.dtype.is_string:
            raise NotImplementedError("min/max over strings is not ported")
        if a.func in ("Sum", "Average") and a.child.dtype.is_floating \
                and not conf.get(VARIABLE_FLOAT_AGG):
            # the JAX package runs these on its CPU executor; the port has
            # none, so it asks for the conf rather than fall back
            raise NotImplementedError(
                "float aggregation reduces in a different order than Spark; "
                f"set {VARIABLE_FLOAT_AGG.key}=true to run it")
        aggs.append(a)
    grouping = [resolve(ce, schema) for ce in plan.grouping]
    return TpuHashAggregateExec(grouping,
                                [ce.output_name for ce in plan.grouping],
                                aggs, child)


def convert(plan: L.LogicalPlan, conf: TpuConf) -> ExecNode:
    """Logical plan -> physical exec tree."""
    if isinstance(plan, L.LogicalScan):
        return TpuScanMemoryExec(plan.table, plan.num_rows)
    child = convert(plan.children[0], conf)
    schema = child.schema
    if isinstance(plan, L.LogicalProject):
        return TpuProjectExec([resolve(ce, schema) for ce in plan.exprs],
                              [ce.output_name for ce in plan.exprs], child)
    if isinstance(plan, L.LogicalFilter):
        return TpuFilterExec(resolve(plan.condition, schema), child)
    if isinstance(plan, L.LogicalAggregate):
        return _aggregate(plan, child, conf)
    if isinstance(plan, L.LogicalSort):
        return TpuSortExec([resolve(o.child, schema) for o in plan.orders],
                           [o.ascending for o in plan.orders],
                           [o.effective_nulls_first for o in plan.orders],
                           child)
    raise NotImplementedError(
        f"{type(plan).__name__} is not in the port's slice")
