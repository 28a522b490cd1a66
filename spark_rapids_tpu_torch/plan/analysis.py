"""Analysis: resolve the unresolved DSL against child schemas (port of the
slice's part of spark_rapids_tpu/plan/analysis.py).

Produces typed, bound Expression trees.  Type coercion follows the JAX
package's `coerce_pair`: numeric pairs promote inside the binary op, and
a string literal compared with a date column is cast to a date.  That
cast is folded here, at analysis, into a date literal; a cast of a string
column raises (ops/cast.py is not ported yet).
"""
from __future__ import annotations

import datetime
import re
from typing import Tuple

from ..ops import expressions as E
from ..ops.aggregates import AGG_FUNCS, AggregateExpression
from ..types import DateType, NullType, Schema
from .logical import ColumnExpr

_DATE_RE = re.compile(r"(\d{4})-(\d{1,2})-(\d{1,2})")
_EPOCH = datetime.date(1970, 1, 1)


class AnalysisError(Exception):
    pass


def _fold_string_to_date(e: E.Expression) -> E.Expression:
    """Cast(string -> date) of a literal, folded: `yyyy-M-d` with
    surrounding whitespace becomes a date literal, anything else null
    (Spark's and the JAX package's cast).  A column child raises."""
    if not isinstance(e, E.Literal):
        raise NotImplementedError(
            "cast of a string column to date is not ported; only string "
            "literals fold into dates")
    if e.value is None:
        return E.Literal(None, DateType)
    m = _DATE_RE.fullmatch(e.value.strip())
    days = None
    if m:
        try:
            d = datetime.date(int(m[1]), int(m[2]), int(m[3]))
            days = (d - _EPOCH).days
        except ValueError:
            pass
    return E.Literal(days, DateType)


def coerce_pair(l: E.Expression, r: E.Expression, op: str
                ) -> Tuple[E.Expression, E.Expression]:
    """Make a binary op's operand types compatible."""
    lt, rt = l.dtype, r.dtype
    if lt is rt:
        return l, r
    if lt is NullType:
        return E.Literal(None, rt), r
    if rt is NullType:
        return l, E.Literal(None, lt)
    if lt.is_numeric and rt.is_numeric:
        return l, r  # BinaryExpression promotes internally
    if lt.is_string and rt is DateType:
        return _fold_string_to_date(l), r
    if rt.is_string and lt is DateType:
        return l, _fold_string_to_date(r)
    raise AnalysisError(f"cannot apply {op} to {lt.name} and {rt.name}")


def resolve(ce, schema: Schema) -> E.Expression:
    """ColumnExpr -> typed bound Expression."""
    if not isinstance(ce, ColumnExpr):
        return E.Literal(ce)
    op = ce.op
    if op == "col":
        name = ce.args[0]
        try:
            idx = schema.index_of(name)
        except KeyError:
            raise AnalysisError(
                f"column {name!r} not found in {schema.names}") from None
        return E.BoundReference(idx, schema[idx].dtype, name)
    if op == "lit":
        return E.Literal(ce.args[0])
    if op in AGG_FUNCS:
        child_ce = ce.args[0]
        child = None
        if not (child_ce.op == "lit" and child_ce.args[0] in (1, "*")):
            child = resolve(child_ce, schema)
        return AggregateExpression(op, child, output_name=ce.output_name)
    if op in E.EXPRESSIONS:
        args = [resolve(a, schema) for a in ce.args]
        if len(args) == 2 and (op in E.COMPARISONS or op in E.ARITHMETIC):
            args = list(coerce_pair(args[0], args[1], op))
        return E.EXPRESSIONS[op](*args)
    raise NotImplementedError(
        f"expression {op!r} is not in the port's slice")
