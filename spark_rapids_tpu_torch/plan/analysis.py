"""Analysis: resolve the unresolved DSL against child schemas (port of the
slice's part of spark_rapids_tpu/plan/analysis.py), and a join's keys and
residual condition (port of `_tag_join` in spark_rapids_tpu/plan/
tagging.py; the CPU placement tagging does is not ported, so where the
JAX package would send a join to its CPU executor the port raises
NotImplementedError with the same message).

Produces typed, bound Expression trees.  Type coercion follows the JAX
package's `coerce_pair`: numeric pairs promote inside the binary op, a
string side is cast to the other side's type (a number, a boolean, a
date or a timestamp) and a date side widened to a timestamp.  A string
literal's cast is folded when it is made (ops/cast.py), through the
parse the cast runs over a column; it stays a Cast node, so the
planner's conf gates see it (plan/physical.py).  AnalysisError is left
for the pairs the JAX package rejects too.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..ops import datetime_exprs as D
from ..ops import expressions as E
from ..ops import math as M
from ..ops import strings as S
from ..ops.aggregates import AGG_FUNCS, AggregateExpression
from ..exec.join import joined_schema
from ..ops.cast import Cast, supported_cast
from ..ops.hashing import Murmur3Hash
from ..types import DateType, NullType, Schema, TimestampType, promote
from .logical import ColumnExpr, LogicalJoin, col


class AnalysisError(Exception):
    pass


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
    # string vs date/timestamp/numeric/boolean: the string side is cast
    if lt.is_string and supported_cast(lt, rt):
        return Cast(l, rt), r
    if rt.is_string and supported_cast(rt, lt):
        return l, Cast(r, lt)
    # date vs timestamp: the date widens
    if lt is DateType and rt is TimestampType:
        return Cast(l, TimestampType), r
    if lt is TimestampType and rt is DateType:
        return l, Cast(r, TimestampType)
    if op in E.COMPARISONS and lt.name == rt.name:
        raise NotImplementedError(
            f"{op} of two distinct {lt.name} type objects is not ported")
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
    if op == "Cast":
        child = resolve(ce.args[0], schema)
        to = ce.args[1]
        if child.dtype is NullType:
            return E.Literal(None, to)
        if not supported_cast(child.dtype, to):
            raise AnalysisError(f"cast {child.dtype.name}->{to.name} "
                                "not supported")
        return Cast(child, to)
    if op in AGG_FUNCS:
        if op == "Percentile":
            child_ce, distinct, pct = ce.args
            if distinct:
                raise AnalysisError("percentile(DISTINCT) is not supported")
            if not (0.0 <= float(pct) <= 1.0):
                raise AnalysisError(f"percentile p={pct} outside [0, 1]")
            child = resolve(child_ce, schema)
            if not child.dtype.is_numeric:
                raise AnalysisError(f"percentile over {child.dtype.name}")
            return AggregateExpression(op, child, False,
                                       output_name=ce.output_name,
                                       param=float(pct))
        child_ce, distinct = ce.args
        child = None
        if not (child_ce.op == "lit" and child_ce.args[0] in (1, "*")):
            child = resolve(child_ce, schema)
        return AggregateExpression(op, child, distinct,
                                   output_name=ce.output_name)
    if op == "In":
        return E.In(resolve(ce.args[0], schema), list(ce.args[1]))
    if op == "CaseWhen":
        branches, otherwise = ce.args
        return E.CaseWhen(
            [(resolve(p, schema), resolve(v, schema)) for p, v in branches],
            resolve(otherwise, schema) if otherwise is not None else None)
    if op == "AtLeastNNonNulls":
        n, child_ces = ce.args
        return E.AtLeastNNonNulls(n, [resolve(a, schema) for a in child_ces])
    if op in ("Least", "Greatest"):
        return getattr(E, op)(*[resolve(a, schema) for a in ce.args])
    if op in S.STRING_EXPRESSIONS:
        return S.STRING_EXPRESSIONS[op](*[resolve(a, schema)
                                          for a in ce.args])
    if op in D.DATE_PARTS:
        return D.DATE_PARTS[op](resolve(ce.args[0], schema))
    if op in D.DATE_FUNCTIONS:
        return D.DATE_FUNCTIONS[op](*[resolve(a, schema) for a in ce.args])
    if op in M.MATH_EXPRESSIONS:
        return M.MATH_EXPRESSIONS[op](*[resolve(a, schema)
                                        for a in ce.args])
    if op == "Murmur3Hash":
        return Murmur3Hash(*[resolve(a, schema) for a in ce.args])
    if op in E.EXPRESSIONS:
        args = [resolve(a, schema) for a in ce.args]
        if len(args) == 2 and (op in E.COMPARISONS or op in E.ARITHMETIC):
            args = list(coerce_pair(args[0], args[1], op))
        return E.EXPRESSIONS[op](*args)
    raise NotImplementedError(
        f"expression {op!r} is not in the port's slice")


# --------------------------------------------------------------------------
# joins
# --------------------------------------------------------------------------

# the join types the JAX package runs on its device, and the port too, by
# their logical spellings, each to the canonical name the execs take
_TPU_JOIN_TYPES = {"inner": "inner", "left": "left", "left_outer": "left",
                   "right": "right", "right_outer": "right",
                   "full": "full", "full_outer": "full",
                   "left_semi": "left_semi", "left_anti": "left_anti"}


def split_equi(cond: ColumnExpr):
    """A join condition's conjuncts split into equi key pairs and the
    residual (the other conjuncts, ANDed; None when there are none)."""
    eqs, residual = [], []

    def walk(ce):
        if ce.op == "And":
            walk(ce.args[0])
            walk(ce.args[1])
        elif ce.op == "EqualTo":
            eqs.append((ce.args[0], ce.args[1]))
        else:
            residual.append(ce)
    walk(cond)
    res = None
    for r in residual:
        res = r if res is None else (res & r)
    return eqs, res


def resolve_join(plan: LogicalJoin, ls: Schema, rs: Schema
                 ) -> Tuple[str, List[E.Expression], List[E.Expression],
                            Optional[E.Expression]]:
    """(canonical join type, left keys, right keys, residual condition) of
    a join, each key pair of one type.  Raises NotImplementedError where
    the JAX package plans the join for its CPU executor: a cross join, a
    full USING join, a residual condition on a left, right or full join,
    and a join without an equi key."""
    if plan.join_type not in _TPU_JOIN_TYPES:
        raise NotImplementedError(
            f"{plan.join_type} joins are not supported on TPU "
            "(Inner/Left/Right/Full/LeftSemi/LeftAnti; the reference "
            "stops at Inner/Left/LeftSemi/LeftAnti — device RIGHT and "
            "FULL OUTER go beyond it)")
    jt = _TPU_JOIN_TYPES[plan.join_type]
    if jt == "full" and plan.using:
        # a full USING join coalesces the key across both preserved
        # sides per row; the exec carries one side's keys
        raise NotImplementedError(
            f"{jt} USING joins (coalesced keys) are not supported on TPU")
    lkeys, rkeys, cond = [], [], None
    if plan.using:
        for name in plan.using:
            lkeys.append(resolve(col(name), ls))
            rkeys.append(resolve(col(name), rs))
    elif plan.condition is not None:
        eqs, residual = split_equi(plan.condition)
        for lc, rc in eqs:
            try:
                lk, rk = resolve(lc, ls), resolve(rc, rs)
            except AnalysisError:
                lk, rk = resolve(rc, ls), resolve(lc, rs)
            lkeys.append(lk)
            rkeys.append(rk)
        if residual is not None:
            if jt not in ("inner", "left_semi", "left_anti"):
                # the pair-wise residual is exact for inner and semi/anti
                # joins only; an outer join would need per-pair matched
                # bookkeeping the exec does not carry
                raise NotImplementedError(
                    f"conditional {jt} joins are not supported on TPU "
                    "(inner/semi/anti only)")
            cond = resolve(residual, joined_schema(ls, rs))
    if not lkeys:
        raise NotImplementedError(
            "join without equi-join keys is not supported on TPU (no "
            "cross/theta join)")
    # int32 against int64 hashes differently: a key pair of two numeric
    # types is widened to one by a materialised cast
    for i, (lk, rk) in enumerate(zip(lkeys, rkeys)):
        if lk.dtype is rk.dtype:
            continue
        try:
            lk, rk = coerce_pair(lk, rk, "EqualTo")
        except AnalysisError as e:
            raise NotImplementedError(f"join key: {e}") from None
        if lk.dtype is not rk.dtype:
            if not (lk.dtype.is_numeric and rk.dtype.is_numeric):
                raise NotImplementedError(
                    f"join key type mismatch {lk.dtype.name} vs "
                    f"{rk.dtype.name} has no implicit coercion")
            target = promote(lk.dtype, rk.dtype)
            if lk.dtype is not target:
                lk = Cast(lk, target)
            if rk.dtype is not target:
                rk = Cast(rk, target)
        lkeys[i], rkeys[i] = lk, rk
    return jt, lkeys, rkeys, cond
