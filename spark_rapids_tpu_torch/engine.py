"""Session and DataFrame API of the port (the slice of
spark_rapids_tpu/engine.py that its TPC-H queries use, with union,
distinct, rollup, cube and window expressions).

    s = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": "true"})
    df = s.from_numpy({"k": np.array([1, 2, 1]), "v": np.array([.5, 1., 2.])})
    df.group_by("k").agg(F.sum(col("v")).alias("s")).order_by("k").collect()

A session runs on the card (`device="cuda"`) unless the caller asks for
the CPU; with no card present it raises rather than carry on elsewhere.
Tables are copied to the device once, when the DataFrame is made.
`collect()` returns Python rows and `to_pydict()` numpy columns; the main
path needs no pyarrow.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .columnar import ColumnarBatch, bucket_rows
from .columnar.batch import check_unique_names
from .config import TpuConf
from .device import resolve_device
from .exec.base import ExecContext, ExecNode
from .exec.basic import DeviceToHostExec
from .ops.aggregates import AGG_FUNCS
from .plan import logical as L
from .plan.logical import ColumnExpr, SortOrder, col, lit
from .plan.physical import convert, plan_schema
from .plan.pushdown import prune_columns
from .types import (BooleanType, ByteType, DataType, DateType, DoubleType,
                    FloatType, IntegerType, LongType, NullType, Schema,
                    ShortType, StringType, StructField, TimestampType)


_BY_NUMPY = {t.np_dtype: t for t in (BooleanType, ByteType, ShortType,
                                      IntegerType, LongType, FloatType,
                                      DoubleType)}


def _infer_type(values) -> DataType:
    """Column type of host values: numpy's own type; Python ints become
    long, floats double, str string; datetime64[D] is a date."""
    arr = np.asarray(values)
    if arr.dtype == object:
        vals = [v for v in arr.tolist() if v is not None]
        if vals and isinstance(vals[0], str):
            return StringType
        arr = np.asarray(vals if vals else [0])
    kind = arr.dtype.kind
    if kind in "SU":
        return StringType
    if kind == "M":
        return DateType if arr.dtype == np.dtype("datetime64[D]") \
            else TimestampType
    if arr.dtype in _BY_NUMPY:
        return _BY_NUMPY[arr.dtype]
    raise TypeError(f"cannot infer a column type from {arr.dtype}")


class TpuSession:
    def __init__(self, conf: Optional[Dict] = None, device="cuda"):
        self.conf = TpuConf(conf)
        self.device = resolve_device(device)
        # the physical plan of the last executed query (tests read the
        # aggregate's update_paths from it)
        self.last_plan: Optional[ExecNode] = None

    def from_numpy(self, columns: Dict[str, object],
                   schema: Optional[Schema] = None) -> "DataFrame":
        """A DataFrame over host columns, copied to the device now.
        Columns are numpy arrays (dates as int32 days or datetime64[D],
        strings as `S`/`U` arrays), numpy masked arrays, or lists."""
        if schema is None:
            schema = Schema([StructField(k, _infer_type(v))
                             for k, v in columns.items()])
        n = len(next(iter(columns.values()))) if columns else 0
        table = ColumnarBatch.from_numpy(columns, schema, self.device,
                                         capacity=bucket_rows(max(n, 1)))
        return DataFrame(self, L.LogicalScan(table, n, schema,
                                             table.arrow_nbytes(n)))

    def plan(self, logical: L.LogicalPlan) -> ExecNode:
        """The physical plan.  Raises NotImplementedError for a
        null-typed output column, which the JAX package cannot collect
        (it has no Arrow type for null); a null inside the tree runs."""
        root = convert(prune_columns(logical, self.conf), self.conf)
        nulls = [f.name for f in root.schema if f.dtype is NullType]
        if nulls:
            raise NotImplementedError(
                f"null-typed output columns {nulls} are not ported: the JAX "
                "package cannot collect them")
        return root

    def _execute(self, logical: L.LogicalPlan, rows: bool):
        root = DeviceToHostExec(self.plan(logical))
        self.last_plan = root
        ctx = ExecContext(self.conf, self.device)
        return list(root.execute_host(ctx, rows))


class DataFrame:
    def __init__(self, session: TpuSession, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan

    def _wrap_cols(self, cols) -> List[ColumnExpr]:
        return [col(c) if isinstance(c, str)
                else c if isinstance(c, ColumnExpr) else lit(c)
                for c in cols]

    def _project(self, exprs: List[ColumnExpr]) -> "DataFrame":
        """A projection; its window expressions, nested ones too (e.g.
        `sum(v).over(w) + 1`), are lifted into LogicalWindow nodes beneath
        it, each replaced by a column reference, as Spark's
        ExtractWindowExpressions does.  An expression without a name is
        called `_w<n>`.  One node per spec group (`WindowSpec._group_key`),
        the first group's lowest."""
        win: List[ColumnExpr] = []

        def extract(e):
            if not isinstance(e, ColumnExpr):
                return e
            if e.op == "WindowExpr":
                if e._alias is None:
                    e = e.alias(f"_w{len(win)}")
                win.append(e)
                return col(e.output_name)

            def walk(a):
                if isinstance(a, ColumnExpr):
                    return extract(a)
                if isinstance(a, (list, tuple)):
                    return type(a)(walk(x) for x in a)
                return a
            return ColumnExpr(e.op, tuple(walk(a) for a in e.args),
                              alias=e._alias)

        rewritten = [extract(e) for e in exprs]
        if not win:
            return DataFrame(self.session, L.LogicalProject(exprs, self.plan))
        groups: Dict[tuple, tuple] = {}
        for e in win:
            spec = e.args[1]
            groups.setdefault(spec._group_key(), (spec, []))[1].append(e)
        child = self.plan
        for spec, es in groups.values():
            child = L.LogicalWindow(es, spec.parts, spec.orders, child)
        return DataFrame(self.session, L.LogicalProject(rewritten, child))

    def select(self, *cols) -> "DataFrame":
        return self._project(self._wrap_cols(cols))

    def with_column(self, name: str, expr: ColumnExpr) -> "DataFrame":
        exprs = [col(n) for n in self.schema.names if n != name]
        return self.select(*exprs, expr.alias(name))

    def filter(self, condition: ColumnExpr) -> "DataFrame":
        return DataFrame(self.session, L.LogicalFilter(condition, self.plan))

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData(self, self._wrap_cols(cols))

    def rollup(self, *cols) -> "GroupedData":
        """GROUP BY ROLLUP: grouping sets {(k1..kn), (k1..kn-1), ..., ()},
        planned as an Expand fan-out and one hash aggregate keyed on
        (keys..., grouping id)."""
        return GroupedData(self, self._wrap_cols(cols), rollup=True)

    def cube(self, *cols) -> "GroupedData":
        """GROUP BY CUBE: every subset of the keys as a grouping set (the
        rollup's plan with 2^n projections)."""
        return GroupedData(self, self._wrap_cols(cols), rollup=True,
                           cube=True)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL, by position: the columns take this DataFrame's names.
        The planner raises where the children differ in arity or in a
        column's type (the JAX package widens no type)."""
        return DataFrame(self.session,
                         L.LogicalUnion([self.plan, other.plan]))

    unionAll = union

    def distinct(self) -> "DataFrame":
        return DataFrame(self.session, L.LogicalDistinct(self.plan))

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Join with `other` on a condition, a column name or a list of
        names (USING).  `how` takes Spark's spellings; the port plans
        inner, left, right, full, left_semi and left_anti joins with equi
        keys, and raises when the plan is made where the JAX package
        would run the join on its CPU executor: a cross join, a residual
        condition on an outer join, a full USING join."""
        how = how.replace("outer", "").rstrip("_") or how
        how = {"leftsemi": "left_semi", "leftanti": "left_anti"}.get(how,
                                                                     how)
        if isinstance(on, (list, tuple)) and on \
                and all(isinstance(x, str) for x in on):
            return DataFrame(self.session, L.LogicalJoin(
                self.plan, other.plan, how, using=list(on)))
        if isinstance(on, str):
            return DataFrame(self.session, L.LogicalJoin(
                self.plan, other.plan, how, using=[on]))
        return DataFrame(self.session, L.LogicalJoin(
            self.plan, other.plan, how, condition=on))

    def order_by(self, *orders) -> "DataFrame":
        os = [o if isinstance(o, SortOrder)
              else SortOrder(col(o) if isinstance(o, str) else o)
              for o in orders]
        return DataFrame(self.session, L.LogicalSort(os, self.plan))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, L.LogicalLimit(n, self.plan))

    def hint(self, name: str, *args) -> "DataFrame":
        """Spark-style plan hints; "broadcast" marks this side for a
        broadcast hash join."""
        hints = set(getattr(self.plan, "_hints", ())) | {name.lower()}
        self.plan._hints = hints
        return self

    @property
    def schema(self) -> Schema:
        return plan_schema(self.plan, self.session.conf)

    def physical_plan(self) -> ExecNode:
        return self.session.plan(self.plan)

    def collect(self) -> List[tuple]:
        """The result as Python rows."""
        out: List[tuple] = []
        for part in self.session._execute(self.plan, rows=True):
            out.extend(part)
        return out

    def to_pydict(self) -> Dict[str, np.ndarray]:
        """The result as numpy columns (masked arrays where nulls occur).
        Raises ValueError when two output columns share a name."""
        check_unique_names(self.schema)
        parts = self.session._execute(self.plan, rows=False)
        names = self.schema.names
        if not parts:
            return {n: np.array([]) for n in names}
        if len(parts) == 1:
            return parts[0]
        return {n: (np.ma.concatenate([p[n] for p in parts])
                    if any(np.ma.isMaskedArray(p[n]) for p in parts)
                    else np.concatenate([p[n] for p in parts]))
                for n in names}


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[ColumnExpr],
                 rollup: bool = False, cube: bool = False):
        self.df = df
        self.keys = keys
        self.rollup = rollup
        self.cube = cube

    def agg(self, *aggs) -> DataFrame:
        """Aggregate.  An entry that computes over aggregates (e.g.
        `sum(a) / sum(b)`) is split as Spark's analyzer splits it: each
        aggregate in it becomes a leaf of the aggregate, named `_agg{i}`,
        and the entry a projection over those leaves after it, under the
        entry's own output name.  A plain list of aggregates stays one
        aggregate node."""
        leaf_aggs: List[ColumnExpr] = []
        projections: List[ColumnExpr] = []
        compound = False

        def walk(e):
            if not isinstance(e, ColumnExpr):
                return e
            if e.op in AGG_FUNCS:
                name = f"_agg{len(leaf_aggs)}"
                leaf_aggs.append(e.alias(name))
                return col(name)

            def sub(a):
                if isinstance(a, ColumnExpr):
                    return walk(a)
                if isinstance(a, (list, tuple)):
                    return type(a)(sub(x) for x in a)
                return a
            return ColumnExpr(e.op, tuple(sub(a) for a in e.args),
                              alias=e._alias)

        for e in aggs:
            if isinstance(e, ColumnExpr) and e.op in AGG_FUNCS:
                leaf_aggs.append(e)
                projections.append(col(e.output_name))
            else:
                before = len(leaf_aggs)
                rewritten = walk(e)
                if len(leaf_aggs) == before:
                    raise ValueError(
                        f"aggregate expression {e!r} contains no aggregate "
                        "function")
                compound = True
                projections.append(rewritten.alias(e.output_name))

        child_plan = self.df.plan
        group_keys = list(self.keys)
        if self.rollup:
            child_plan, group_keys = self._expand_rollup(child_plan)
        agg_plan = L.LogicalAggregate(group_keys, leaf_aggs, child_plan)
        if not compound and not self.rollup:
            return DataFrame(self.df.session, agg_plan)
        if not compound:
            projections = [col(a.output_name) for a in leaf_aggs]
        # a rollup's projection drops the grouping id
        key_cols = [col(k.output_name) for k in self.keys]
        return DataFrame(self.df.session, L.LogicalProject(
            key_cols + projections, agg_plan))

    def _expand_rollup(self, child_plan):
        """The Expand of the grouping sets, one projection each, and the
        aggregate's keys.  Every original column passes through unchanged
        (an aggregate over a key column sees its real values in subtotal
        rows), then one nullable copy per key, `_gkey_<name>`, null where
        the set rolls the key up, and `_grouping_id`, so that a rolled-up
        null never merges with a data null.  The id follows Spark's
        grouping_id: a cube's bits mark the pruned keys, the first key
        the highest bit; a rollup keeping g of n keys has 2^(n-g) - 1."""
        schema = self.df.schema
        key_names = [k.output_name for k in self.keys]
        for k, name in zip(self.keys, key_names):
            if k.op != "col" or name not in schema.names:
                raise ValueError(
                    "rollup keys must be existing columns; project "
                    f"{name!r} first")
        gid = "_grouping_id"
        n = len(self.keys)
        if self.cube:
            sets = [[name for b, name in enumerate(key_names)
                     if not (mask >> (n - 1 - b)) & 1]
                    for mask in range(1 << n)]
            gids = list(range(1 << n))
        else:
            sets = [key_names[:g] for g in range(n, -1, -1)]
            gids = [(1 << (n - g)) - 1 for g in range(n, -1, -1)]
        projections = []
        for kept, g_val in zip(sets, gids):
            proj = [col(f.name) for f in schema]
            for name in key_names:
                copy = (col(name) if name in kept
                        else lit(None).cast(
                            schema[schema.index_of(name)].dtype))
                proj.append(copy.alias(f"_gkey_{name}"))
            proj.append(lit(g_val).alias(gid))
            projections.append(proj)
        group_keys = [col(f"_gkey_{name}").alias(name)
                      for name in key_names] + [col(gid)]
        return L.LogicalExpand(projections, child_plan), group_keys

    def count(self) -> DataFrame:
        return self.agg(L.functions.count(lit(1)).alias("count"))
