"""TPC-H lineitem for the port: a vectorised generator of the columns that
q1, q6 and q18 read, the three queries in the port's DataFrame API, and
numpy oracles for them.

The generator draws from the distributions of the JAX package's
benchmarks/tpch/datagen.py (lineitem: 1-7 lines per order, ship date
1-121 days after an order date in [1992-01-01, 1998-08-02 - 151 days),
quantity 1-50, price = quantity * U(900, 1100) rounded to cents, discount
U(0, 0.10) and tax U(0, 0.08) rounded to cents, return flag A/N/R, line
status F/O), with numpy's own generator seeded by `seed`: the same shapes
and distributions, not the same rows.  About 6,000,000 * sf rows.
"""
from __future__ import annotations

import datetime
import math
from typing import Dict, List

import numpy as np

from .plan.logical import col, functions as F, lit
from .types import (DateType, DoubleType, LongType, Schema, StringType,
                    StructField)

_EPOCH = datetime.date(1970, 1, 1)


def days(s: str) -> int:
    """'1994-01-01' -> days since 1970-01-01."""
    y, m, d = map(int, s.split("-"))
    return (datetime.date(y, m, d) - _EPOCH).days


START = days("1992-01-01")
END = days("1998-08-02")

LINEITEM = Schema([StructField("l_orderkey", LongType),
                   StructField("l_quantity", DoubleType),
                   StructField("l_extendedprice", DoubleType),
                   StructField("l_discount", DoubleType),
                   StructField("l_tax", DoubleType),
                   StructField("l_returnflag", StringType),
                   StructField("l_linestatus", StringType),
                   StructField("l_shipdate", DateType)])


def generate_lineitem(sf: float, seed: int = 42) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    n_ord = max(100, int(1_500_000 * sf))
    o_date = rng.integers(START, END - 151, n_ord, dtype=np.int32)
    nl_per = rng.integers(1, 8, n_ord, dtype=np.int64)
    n = int(nl_per.sum())
    qty = rng.integers(1, 51, n).astype(np.float64)
    return {
        "l_orderkey": np.repeat(np.arange(1, n_ord + 1, dtype=np.int64),
                                nl_per),
        "l_quantity": qty,
        "l_extendedprice": np.round(qty * (900 + rng.uniform(0, 200, n)), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.10, n), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n), 2),
        "l_returnflag": np.array([b"A", b"N", b"R"])[
            rng.integers(0, 3, n, dtype=np.int8)],
        "l_linestatus": np.array([b"F", b"O"])[
            rng.integers(0, 2, n, dtype=np.int8)],
        "l_shipdate": (np.repeat(o_date, nl_per)
                       + rng.integers(1, 122, n, dtype=np.int32)),
    }


# --------------------------------------------------------------------------
# the queries (benchmarks/tpch/queries.py q1, q6, and q18's inner
# lineitem aggregate)
# --------------------------------------------------------------------------

def q1(li):
    li = li.filter(col("l_shipdate") <= "1998-09-02")
    disc = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (li.group_by(col("l_returnflag"), col("l_linestatus"))
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.sum(col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(disc).alias("sum_disc_price"),
                 F.sum(disc * (lit(1.0) + col("l_tax"))).alias("sum_charge"),
                 F.avg(col("l_quantity")).alias("avg_qty"),
                 F.avg(col("l_extendedprice")).alias("avg_price"),
                 F.avg(col("l_discount")).alias("avg_disc"),
                 F.count(lit(1)).alias("count_order"))
            .order_by("l_returnflag", "l_linestatus"))


def q6(li):
    return (li.filter((col("l_shipdate") >= "1994-01-01")
                      & (col("l_shipdate") < "1995-01-01")
                      & col("l_discount").between(0.05, 0.07)
                      & (col("l_quantity") < 24))
            .agg(F.sum(col("l_extendedprice") * col("l_discount"))
                 .alias("revenue")))


def q18_inner(li, min_qty: float = 300):
    """q18's big-order aggregate: orders whose lines sum above `min_qty`
    (300 in TPC-H)."""
    return (li.group_by(col("l_orderkey"))
            .agg(F.sum(col("l_quantity")).alias("sum_qty"))
            .filter(col("sum_qty") > min_qty)
            .order_by("l_orderkey"))


QUERIES = {"q1": q1, "q6": q6, "q18_inner": q18_inner}


# --------------------------------------------------------------------------
# numpy oracles
# --------------------------------------------------------------------------

def _text(a: np.ndarray) -> np.ndarray:
    return np.char.decode(a, "utf-8") if a.dtype.kind == "S" else a


def oracle_q1(t: Dict[str, np.ndarray]) -> List[tuple]:
    m = t["l_shipdate"] <= days("1998-09-02")
    rf, ls = _text(t["l_returnflag"][m]), _text(t["l_linestatus"][m])
    keys, inv = np.unique(np.char.add(np.char.add(rf, "|"), ls),
                          return_inverse=True)
    qty, price = t["l_quantity"][m], t["l_extendedprice"][m]
    dsc, tax = t["l_discount"][m], t["l_tax"][m]
    disc = price * (1.0 - dsc)

    def s(w):
        return np.bincount(inv, weights=w, minlength=len(keys))
    cnt = np.bincount(inv, minlength=len(keys))
    rows = []
    for i, k in enumerate(keys):
        a, b = str(k).split("|")
        rows.append((a, b, s(qty)[i], s(price)[i], s(disc)[i],
                     s(disc * (1.0 + tax))[i], s(qty)[i] / cnt[i],
                     s(price)[i] / cnt[i], s(dsc)[i] / cnt[i], int(cnt[i])))
    return rows


def oracle_q6(t: Dict[str, np.ndarray]) -> List[tuple]:
    d = t["l_discount"]
    m = ((t["l_shipdate"] >= days("1994-01-01"))
         & (t["l_shipdate"] < days("1995-01-01"))
         & (d >= 0.05) & (d <= 0.07) & (t["l_quantity"] < 24))
    return [(float(np.sum(t["l_extendedprice"][m] * d[m])),)]


def oracle_q18_inner(t: Dict[str, np.ndarray],
                     min_qty: float = 300) -> List[tuple]:
    sums = np.bincount(t["l_orderkey"], weights=t["l_quantity"])
    keys = np.flatnonzero(sums > min_qty)
    return [(int(k), float(sums[k])) for k in keys]


ORACLES = {"q1": oracle_q1, "q6": oracle_q6, "q18_inner": oracle_q18_inner}


def rows_match(want: List[tuple], got: List[tuple],
               rel: float = 1e-9) -> bool:
    """Same rows in the same order: ints, strings and dates exact, floats
    within `rel` (relative, with the same absolute floor)."""
    if len(want) != len(got):
        return False
    for w, g in zip(want, got):
        if len(w) != len(g):
            return False
        for a, b in zip(w, g):
            if isinstance(a, float) or isinstance(b, float):
                if not math.isclose(a, b, rel_tol=rel, abs_tol=rel):
                    return False
            elif a != b:
                return False
    return True
