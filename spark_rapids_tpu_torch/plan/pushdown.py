"""Column pruning (port of the in-memory half of
spark_rapids_tpu/plan/pushdown.py).

A functional rewrite of the logical plan that narrows every scan's schema
to the columns something above it reads, so operators carry only those.
The planner's size estimates read the pruned widths (plan/physical.py),
as the JAX package's do, so the two packages choose the same joins.  The
JAX package also pushes predicates into file scans; the port has no file
scans, so that half is not ported.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Set

from ..config import TpuConf
from ..types import Schema
from . import logical as L
from .logical import ColumnExpr, SortOrder


def col_refs(e, out: Set[str]) -> None:
    """Collect the column names an expression tree reads (a window
    expression's spec is not searched: its node lists its keys)."""
    if isinstance(e, SortOrder):
        col_refs(e.child, out)
        return
    if isinstance(e, (list, tuple)):
        for x in e:
            col_refs(x, out)
        return
    if not isinstance(e, ColumnExpr):
        return
    if e.op == "col":
        out.add(e.args[0])
        return
    for a in e.args:
        col_refs(a, out)


def prune_columns(plan: L.LogicalPlan, conf: TpuConf) -> L.LogicalPlan:
    """A plan whose scans produce only the columns the nodes above them
    read.  Never mutates the input tree (DataFrames share nodes)."""
    return _rewrite(plan, None, conf)


def _rebuild(node: L.LogicalPlan, children: List[L.LogicalPlan]
             ) -> L.LogicalPlan:
    """Shallow copy of a node with new children (hints ride along)."""
    if all(c is old for c, old in zip(children, node.children)):
        return node
    new = copy.copy(node)
    new.children = tuple(children)
    return new


def _rewrite(node: L.LogicalPlan, required: Optional[Set[str]],
             conf: TpuConf) -> L.LogicalPlan:
    """`required`: the column names the parent reads (None: all)."""
    from .physical import plan_schema
    if isinstance(node, L.LogicalScan):
        return _rewrite_scan(node, required)
    if isinstance(node, (L.LogicalFilter, L.LogicalSort)):
        child_req = None
        if required is not None:
            child_req = set(required)
            col_refs(node.condition if isinstance(node, L.LogicalFilter)
                     else node.orders, child_req)
        return _rebuild(node, [_rewrite(node.children[0], child_req, conf)])
    if isinstance(node, (L.LogicalProject, L.LogicalAggregate)):
        child_req: Set[str] = set()
        col_refs(node.exprs if isinstance(node, L.LogicalProject)
                 else node.grouping + node.aggregates, child_req)
        return _rebuild(node, [_rewrite(node.children[0], child_req, conf)])
    if isinstance(node, L.LogicalJoin):
        refs: Set[str] = set() if required is None else set(required)
        if node.condition is not None:
            col_refs(node.condition, refs)
        if node.using:
            refs.update(node.using)
        children = [
            _rewrite(c, None if required is None
                     else refs & set(plan_schema(c, conf).names), conf)
            for c in node.children]
        return _rebuild(node, children)
    if isinstance(node, L.LogicalExpand):
        child_req = set()
        col_refs(node.projections, child_req)
        return _rebuild(node, [_rewrite(node.children[0], child_req, conf)])
    if isinstance(node, L.LogicalWindow):
        child_req = None
        if required is not None:
            child_req = set(required)
            col_refs(node.window_exprs + node.partition_by + node.order_by,
                     child_req)
        return _rebuild(node, [_rewrite(node.children[0], child_req, conf)])
    if isinstance(node, L.LogicalLimit):
        return _rebuild(node, [_rewrite(node.children[0], required, conf)])
    # a union's children concatenate by position, each keeping its
    # declared output; a distinct dedups whole rows
    return _rebuild(node, [_rewrite(c, None, conf) for c in node.children])


def _rewrite_scan(scan: L.LogicalScan, required: Optional[Set[str]]
                  ) -> L.LogicalScan:
    if required is None:
        return scan
    keep = [f for f in scan.schema.fields if f.name in required]
    if not keep:  # count(*): keep one narrow column for the row count
        keep = [min(scan.schema.fields,
                    key=lambda f: 99 if f.dtype.is_string else 1)]
    if len(keep) == len(scan.schema.fields):
        return scan
    # a new node, as the JAX package makes: hints on the scan do not
    # carry over
    return L.LogicalScan(scan.table, scan.num_rows, Schema(keep),
                         scan.nbytes)
