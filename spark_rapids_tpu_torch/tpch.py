"""TPC-H for the port: a vectorised generator of the columns that the 22
queries read (lineitem, orders, customer, part, supplier, partsupp,
nation and region), the queries in the port's DataFrame API, string
filters over o_comment, outer joins of orders and customers, two
queries of date arithmetic and casts over lineitem (DATE_QUERIES: a
monthly shipping-delay report, and q6 over the ship date carried as
text), two of text casts (TEXT_QUERIES: q1 over a lineitem whose numbers
arrive as text, and a round trip of keys and flags through text), four
of math, bitwise and hash expressions (MATH_QUERIES: a per-supplier
price dispersion, a log-scale price histogram, the shuffle's 200-way
hash partitioning of the lines, and a 1-in-64 sample by hash), five of
First, Last, distinct aggregates and string Min/Max (AGG_QUERIES: q16
and q21 with count(distinct), each customer's first and last order
priority, per-segment string bounds of the customers, and a global
summary of the urgent orders), six of union, distinct, rollup and cube
(SET_QUERIES: q1 with its rollup subtotals, a cube of the orders, a
three-level rollup over a join, a union of two channels, a union then
distinct, and a distinct per priority), seven of window functions
(WINDOW_QUERIES: a revenue ratio within a brand, a margin rank within a
manufacturer over a rollup, monthly deviations with lag and lead, each
customer's running spend, an order's neighbours within two rows, the
top lines of each order, and a global spend rank), and numpy oracles
for them (murmur3 among them, in numpy's uint32).

The generator draws from the distributions of the JAX package's
benchmarks/tpch/datagen.py, with numpy's own generator seeded by `seed`:
the same shapes, key ranges and distributions, not the same rows.
  * orders: ~1,500,000 * sf, o_orderkey 1..n, o_custkey uniform over the
    customers, order date uniform in [1992-01-01, 1998-08-02 - 151 days),
    priority uniform over PRIORITIES, ship priority 0, total price
    U(900, 500000) rounded to cents, comment 2-5 of WORDS joined by
    spaces, status uniform over F, O and P;
  * lineitem: 1-7 lines per order (~6,000,000 * sf rows), ship date 1-121
    days after the order date, commit date 30-90 days after it, receipt
    date 1-30 days after the ship date, quantity 1-50, price = quantity *
    U(900, 1100) rounded to cents, discount U(0, 0.10) and tax U(0, 0.08)
    rounded to cents, return flag A/N/R, line status F/O, ship mode
    uniform over SHIPMODES, ship instruction uniform over INSTRUCTS, part
    key uniform over the parts, supplier key uniform over the suppliers;
  * customer: ~150,000 * sf, c_custkey 1..n, c_name "Customer#%09d",
    c_address "caddr {i}" (i from 0), market segment uniform over
    SEGMENTS, phone "NN-NNN-NNN-NNNN" whose NN is a nation key uniform
    over 0..24 plus 10 (c_nationkey is that key), account balance
    U(-999.99, 9999.99) rounded to cents, comment as the orders';
  * part: max(20, 200,000 * sf), p_partkey 1..n, p_brand "Brand#XY" with
    X and Y uniform over 1-5, p_type one of TYPES_1 x TYPES_2 x TYPES_3
    and p_container one of CONTAINERS_1 x CONTAINERS_2, each word
    uniform, p_size uniform over 1-50;
  * supplier: max(10, 10,000 * sf), s_suppkey 1..n, s_name
    "Supplier#%09d", s_address "addr {i}" (i from 0), s_nationkey uniform
    over 0..24, s_phone as the customers' with NN = s_nationkey + 10;
  * nation and region: the 25 NATIONS, each in its NATION_REGION, and
    the 5 REGIONS.
Strings come as numpy byte arrays, built without a per-row Python loop.
Columns added in later slices draw from seeded streams of their own, so
the earlier columns keep their values.
"""
from __future__ import annotations

import datetime
import math
from typing import Dict, List

import numpy as np

from .plan import logical as _L
from .plan.logical import SortOrder, col, functions as F, lit
from .types import (DateType, DoubleType, LongType, Schema, StringType,
                    StructField)

_EPOCH = datetime.date(1970, 1, 1)


def days(s: str) -> int:
    """'1994-01-01' -> days since 1970-01-01."""
    y, m, d = map(int, s.split("-"))
    return (datetime.date(y, m, d) - _EPOCH).days


START = days("1992-01-01")
END = days("1998-08-02")
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
WORDS = ["express", "special", "pending", "deposits", "packages", "regular",
         "requests", "accounts", "ironic", "final", "unusual", "Customer",
         "Complaints", "carefully", "quickly", "furiously", "slyly"]
TYPES_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPES_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPES_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINERS_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINERS_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES"]
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
          "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
          "floral", "forest", "frosted", "gainsboro", "ghost", "gold",
          "goldenrod", "green", "grey", "honeydew", "hot", "indian", "ivory",
          "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime",
          "linen", "magenta", "maroon", "medium", "metallic", "midnight",
          "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
          "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
          "powder", "puff", "purple", "red", "rose", "rosy", "royal",
          "saddle", "salmon", "sandy", "seashell", "sienna", "sky", "slate",
          "smoke", "snow", "spring", "steel", "tan", "thistle", "tomato",
          "turquoise", "violet", "wheat", "white", "yellow"]
N_NATIONS = len(NATIONS)

LINEITEM = Schema([StructField("l_orderkey", LongType),
                   StructField("l_partkey", LongType),
                   StructField("l_quantity", DoubleType),
                   StructField("l_extendedprice", DoubleType),
                   StructField("l_discount", DoubleType),
                   StructField("l_tax", DoubleType),
                   StructField("l_returnflag", StringType),
                   StructField("l_linestatus", StringType),
                   StructField("l_shipdate", DateType),
                   StructField("l_commitdate", DateType),
                   StructField("l_receiptdate", DateType),
                   StructField("l_shipmode", StringType),
                   StructField("l_suppkey", LongType),
                   StructField("l_shipinstruct", StringType)])
ORDERS = Schema([StructField("o_orderkey", LongType),
                 StructField("o_custkey", LongType),
                 StructField("o_totalprice", DoubleType),
                 StructField("o_orderdate", DateType),
                 StructField("o_orderpriority", StringType),
                 StructField("o_shippriority", LongType),
                 StructField("o_comment", StringType),
                 StructField("o_orderstatus", StringType)])
CUSTOMER = Schema([StructField("c_custkey", LongType),
                   StructField("c_name", StringType),
                   StructField("c_mktsegment", StringType),
                   StructField("c_phone", StringType),
                   StructField("c_acctbal", DoubleType),
                   StructField("c_nationkey", LongType),
                   StructField("c_address", StringType),
                   StructField("c_comment", StringType)])
PART = Schema([StructField("p_partkey", LongType),
               StructField("p_brand", StringType),
               StructField("p_type", StringType),
               StructField("p_container", StringType),
               StructField("p_size", LongType),
               StructField("p_name", StringType),
               StructField("p_mfgr", StringType)])
SUPPLIER = Schema([StructField("s_suppkey", LongType),
                   StructField("s_name", StringType),
                   StructField("s_address", StringType),
                   StructField("s_nationkey", LongType),
                   StructField("s_phone", StringType),
                   StructField("s_acctbal", DoubleType),
                   StructField("s_comment", StringType)])
PARTSUPP = Schema([StructField("ps_partkey", LongType),
                   StructField("ps_suppkey", LongType),
                   StructField("ps_availqty", LongType),
                   StructField("ps_supplycost", DoubleType)])
NATION = Schema([StructField("n_nationkey", LongType),
                 StructField("n_name", StringType),
                 StructField("n_regionkey", LongType)])
REGION = Schema([StructField("r_regionkey", LongType),
                 StructField("r_name", StringType)])
SCHEMAS = {"lineitem": LINEITEM, "orders": ORDERS, "customer": CUSTOMER,
           "part": PART, "supplier": SUPPLIER, "nation": NATION,
           "region": REGION, "partsupp": PARTSUPP}


def _numbered(prefix: str, keys: np.ndarray, width: int) -> np.ndarray:
    """`prefix` + each key zero-padded to `width` digits, as a byte array
    built from a digit matrix."""
    pre = np.frombuffer(prefix.encode(), dtype=np.uint8)
    mat = np.concatenate([np.broadcast_to(pre, (len(keys), len(pre))),
                          _digits(keys, width)], axis=1)
    return _as_bytes(mat)


def _as_bytes(mat: np.ndarray) -> np.ndarray:
    """A uint8 matrix as a numpy byte-string array, one row a string
    (trailing zero bytes dropped)."""
    return np.ascontiguousarray(mat).view(f"S{mat.shape[1]}").reshape(-1)


def _digits(v: np.ndarray, width: int) -> np.ndarray:
    """ASCII digit matrix of `v`, zero-padded to `width` digits."""
    return ((v[:, None] // 10 ** np.arange(width - 1, -1, -1)) % 10
            + ord("0")).astype(np.uint8)


def _counted(prefix: str, n: int) -> np.ndarray:
    """`prefix` + each of 0..n-1 in decimal, unpadded: each row's digit
    matrix shifted left past its leading zeros, which trail as zero
    bytes and drop."""
    keys = np.arange(n, dtype=np.int64)
    width = len(str(max(n - 1, 0)))
    n_dig = 1 + sum((keys >= 10 ** k).astype(np.int64)
                    for k in range(1, width))
    at = (width - n_dig)[:, None] + np.arange(width)
    dig = np.take_along_axis(_digits(keys, width),
                             np.minimum(at, width - 1), axis=1)
    dig[at >= width] = 0
    pre = np.frombuffer(prefix.encode(), dtype=np.uint8)
    return _as_bytes(np.concatenate(
        [np.broadcast_to(pre, (n, len(pre))), dig], axis=1))


def _decimal_text(v: np.ndarray, scale: int = 0) -> np.ndarray:
    """Non-negative integers `v` as decimal text with their last `scale`
    digits after a dot ("17", "24386.67", "0.04" for 17, 2438667 and 4
    at scales 0, 2 and 2), at least one digit before it: a byte matrix
    of the zero-padded digits with the dot put in, each row shifted left
    past its leading zeros (one masked copy per count of them), which
    trail as zero bytes and drop.  Where the values are few against the
    rows, the text of each value is made once and looked up."""
    top = int(v.max()) if len(v) else 0
    if top < len(v) // 4:
        return _decimal_text(np.arange(top + 1), scale)[v]
    width = max(len(str(top)), scale + 1)
    mat = _digits(v, width)
    if scale:
        mat = np.insert(mat, width - scale, ord("."), axis=1)
    n_dig = np.maximum(1 + sum((v >= 10 ** k).astype(np.int64)
                               for k in range(1, width)), scale + 1)
    lead = width - n_dig
    out = np.zeros_like(mat)
    for k in np.unique(lead):
        rows = lead == k
        out[rows, :mat.shape[1] - k] = mat[rows, k:]
    return _as_bytes(out)


def _phones(rng: np.random.Generator, n: int) -> np.ndarray:
    """`n` phones "NN-NNN-NNN-NNNN" (benchmarks/tpch/datagen.py's form):
    NN = nation key + 10, the key uniform over the nations, then three
    random groups."""
    return _phones_of(rng, rng.integers(0, N_NATIONS, n))


def _phones_of(rng: np.random.Generator, nation: np.ndarray) -> np.ndarray:
    """A phone "NN-NNN-NNN-NNNN" for each of the nation keys `nation`: NN
    = key + 10, then three random groups."""
    n = len(nation)
    dash = np.full((n, 1), ord("-"), np.uint8)
    parts = [_digits(nation + 10, 2), dash,
             _digits(rng.integers(100, 999, n), 3), dash,
             _digits(rng.integers(100, 999, n), 3), dash,
             _digits(rng.integers(1000, 9999, n), 4)]
    return _as_bytes(np.concatenate(parts, axis=1))


def _phone_nation(phone: np.ndarray) -> np.ndarray:
    """The nation key of each phone "NN-...": its first two digits - 10."""
    b = np.frombuffer(np.ascontiguousarray(phone).tobytes(), np.uint8) \
        .reshape(len(phone), phone.dtype.itemsize)[:, :2].astype(np.int64)
    return (b[:, 0] - ord("0")) * 10 + (b[:, 1] - ord("0")) - 10


def _comments(rng: np.random.Generator, n: int) -> np.ndarray:
    """`n` comments of 2-5 WORDS joined by single spaces."""
    k = rng.integers(2, 6, n)
    pick = rng.integers(0, len(WORDS), (n, 5), dtype=np.int8)
    return _spelled(WORDS, pick, k)


def _spelled(words: List[str], pick: np.ndarray, k) -> np.ndarray:
    """Row i: the words `pick[i, :k[i]]` of `words` joined by single
    spaces, written into one byte matrix a word slot at a time."""
    n, slots = pick.shape
    k = np.broadcast_to(k, (n,))
    lens = np.array([len(w) for w in words])
    wmax = int(lens.max())
    table = np.zeros((len(words), wmax), np.uint8)
    for i, w in enumerate(words):
        table[i, :len(w)] = np.frombuffer(w.encode(), np.uint8)
    width = slots * (wmax + 1) - 1
    out = np.zeros(n * width, np.uint8)
    # the flat index of each row's next byte; a word is written with its
    # zero padding, which the next slot overwrites
    at = np.arange(n, dtype=np.int64) * width
    for slot in range(slots):
        live = np.flatnonzero(slot < k)
        if slot:
            out[at[live]] = ord(" ")
            at[live] += 1
        w = pick[live, slot]
        out[at[live, None] + np.arange(wmax)] = table[w]
        at[live] += lens[w]
    return _as_bytes(out.reshape(n, width))


def _distinct(rng: np.random.Generator, n: int, k: int, m: int
              ) -> np.ndarray:
    """`n` rows of `k` distinct ints of [0, m), every ordered choice
    equally likely (rng.choice(m, k, replace=False) per row, without the
    per-row loop): the j-th is drawn among the m - j values left and
    moved past the earlier ones at or below it."""
    picks = np.zeros((n, k), np.int64)
    for j in range(k):
        v = rng.integers(0, m - j, n)
        for taken in np.sort(picks[:, :j], axis=1).T:
            v += v >= taken
        picks[:, j] = v
    return picks


def _joined(rng: np.random.Generator, n: int, *words: List[str]
            ) -> np.ndarray:
    """`n` strings, each one word drawn uniformly from every list in
    `words`, joined by single spaces: a draw per list, then a lookup in
    the table of every combination (the product of the lists' sizes, not
    `n`)."""
    combos = [""]
    for ws in words:
        combos = [f"{c} {w}" if c else w for c in combos for w in ws]
    code = np.zeros(n, np.int64)
    for ws in words:
        code = code * len(ws) + rng.integers(0, len(ws), n)
    return np.array(combos, dtype="S")[code]


def _part(rng: np.random.Generator, n: int) -> Dict[str, np.ndarray]:
    """The part columns q14 and q17 read: p_partkey 1..n, p_brand
    "Brand#XY" with X and Y uniform over 1-5, p_type one of TYPES_1 x
    TYPES_2 x TYPES_3, p_container one of CONTAINERS_1 x CONTAINERS_2."""
    pre = np.frombuffer(b"Brand#", np.uint8)
    brand = np.concatenate([np.broadcast_to(pre, (n, len(pre))),
                            (rng.integers(1, 6, (n, 2)) + ord("0"))
                            .astype(np.uint8)], axis=1)
    return {"p_partkey": np.arange(1, n + 1, dtype=np.int64),
            "p_brand": _as_bytes(brand),
            "p_type": _joined(rng, n, TYPES_1, TYPES_2, TYPES_3),
            "p_container": _joined(rng, n, CONTAINERS_1, CONTAINERS_2)}


def generate(sf: float, seed: int = 42) -> Dict[str, Dict[str, np.ndarray]]:
    """{table: {column: numpy array}} for lineitem, orders, customer,
    part, supplier, nation, region and partsupp."""
    rng = np.random.default_rng(seed)
    n_ord = max(100, int(1_500_000 * sf))
    o_date = rng.integers(START, END - 151, n_ord, dtype=np.int32)
    nl_per = rng.integers(1, 8, n_ord, dtype=np.int64)
    n = int(nl_per.sum())
    qty = rng.integers(1, 51, n).astype(np.float64)
    l_odate = np.repeat(o_date, nl_per)
    lineitem = {
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
        "l_shipdate": l_odate + rng.integers(1, 122, n, dtype=np.int32),
    }
    # the columns added after the first slice draw from a second stream,
    # so the ones above keep their values
    rng2 = np.random.default_rng([seed, 1])
    lineitem["l_commitdate"] = l_odate + rng2.integers(30, 91, n,
                                                       dtype=np.int32)
    lineitem["l_receiptdate"] = (lineitem["l_shipdate"]
                                 + rng2.integers(1, 31, n, dtype=np.int32))
    # and the ship mode from a third, so the second's keep theirs
    rng3 = np.random.default_rng([seed, 2])
    lineitem["l_shipmode"] = np.array(SHIPMODES, dtype="S")[
        rng3.integers(0, len(SHIPMODES), n)]
    n_cust = max(30, int(150_000 * sf))
    c_keys = np.arange(1, n_cust + 1, dtype=np.int64)
    customer = {
        "c_custkey": c_keys,
        "c_name": _numbered("Customer#", c_keys, 9),
        "c_mktsegment": np.array(SEGMENTS, dtype="S")[
            rng2.integers(0, len(SEGMENTS), n_cust)],
    }
    orders = {
        "o_orderkey": np.arange(1, n_ord + 1, dtype=np.int64),
        "o_custkey": rng2.integers(1, n_cust + 1, n_ord, dtype=np.int64),
        "o_totalprice": np.round(rng2.uniform(900, 500_000, n_ord), 2),
        "o_orderdate": o_date,
        "o_orderpriority": np.array(PRIORITIES, dtype="S")[
            rng2.integers(0, len(PRIORITIES), n_ord)],
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
    }
    # the columns q22 and the string filters read from a fourth stream
    rng4 = np.random.default_rng([seed, 3])
    customer["c_phone"] = _phones(rng4, n_cust)
    customer["c_acctbal"] = np.round(rng4.uniform(-999.99, 9999.99, n_cust),
                                     2)
    orders["o_comment"] = _comments(rng4, n_ord)
    # part and l_partkey (q14, q17) from a fifth
    rng5 = np.random.default_rng([seed, 4])
    n_part = max(20, int(200_000 * sf))
    part = _part(rng5, n_part)
    lineitem["l_partkey"] = rng5.integers(1, n_part + 1, n, dtype=np.int64)
    # supplier and the columns that join to it, nation and region (q5,
    # q10, q15, q19, q21) from a sixth; c_nationkey is c_phone's nation,
    # which was drawn with it
    rng6 = np.random.default_rng([seed, 5])
    n_supp = max(10, int(10_000 * sf))
    s_nation = rng6.integers(0, N_NATIONS, n_supp, dtype=np.int64)
    s_keys = np.arange(1, n_supp + 1, dtype=np.int64)
    supplier = {"s_suppkey": s_keys,
                "s_name": _numbered("Supplier#", s_keys, 9),
                "s_address": _counted("addr ", n_supp),
                "s_nationkey": s_nation,
                "s_phone": _phones_of(rng6, s_nation)}
    customer["c_nationkey"] = _phone_nation(customer["c_phone"])
    customer["c_address"] = _counted("caddr ", n_cust)
    customer["c_comment"] = _comments(rng6, n_cust)
    orders["o_orderstatus"] = np.array([b"F", b"O", b"P"])[
        rng6.integers(0, 3, n_ord, dtype=np.int8)]
    lineitem["l_suppkey"] = rng6.integers(1, n_supp + 1, n, dtype=np.int64)
    lineitem["l_shipinstruct"] = np.array(INSTRUCTS, dtype="S")[
        rng6.integers(0, len(INSTRUCTS), n, dtype=np.int8)]
    part["p_size"] = rng6.integers(1, 51, n_part, dtype=np.int64)
    # partsupp and the columns q2, q9, q11, q16 and q20 read from a
    # seventh: p_name 5 distinct COLORS, p_mfgr, then partsupp's 4 rows a
    # part, then s_acctbal and s_comment
    rng7 = np.random.default_rng([seed, 6])
    part["p_name"] = _spelled(COLORS, _distinct(rng7, n_part, 5,
                                                len(COLORS)), 5)
    part["p_mfgr"] = _numbered("Manufacturer#",
                               rng7.integers(1, 6, n_part), 1)
    partsupp = {
        "ps_partkey": np.repeat(part["p_partkey"], 4),
        "ps_suppkey": rng7.integers(1, n_supp + 1, 4 * n_part,
                                    dtype=np.int64),
        "ps_availqty": rng7.integers(1, 10_000, 4 * n_part, dtype=np.int64),
        "ps_supplycost": np.round(rng7.uniform(1.0, 1000.0, 4 * n_part), 2)}
    supplier["s_acctbal"] = np.round(rng7.uniform(-999.99, 9999.99, n_supp),
                                     2)
    supplier["s_comment"] = _comments(rng7, n_supp)
    nation = {"n_nationkey": np.arange(N_NATIONS, dtype=np.int64),
              "n_name": np.array(NATIONS, dtype="S"),
              "n_regionkey": np.array(NATION_REGION, dtype=np.int64)}
    region = {"r_regionkey": np.arange(len(REGIONS), dtype=np.int64),
              "r_name": np.array(REGIONS, dtype="S")}
    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "part": part, "supplier": supplier, "nation": nation,
            "region": region, "partsupp": partsupp}


def generate_lineitem(sf: float, seed: int = 42) -> Dict[str, np.ndarray]:
    """The lineitem table of generate(sf, seed) alone."""
    return generate(sf, seed)["lineitem"]


# --------------------------------------------------------------------------
# the queries (benchmarks/tpch/queries.py q1, q3, q4, q5, q6, q10, q12,
# q13, q14, q15, q17, q18, q19, q21, q22, and q18's inner lineitem
# aggregate)
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


def q3(t):
    cust = t["customer"].filter(col("c_mktsegment") == "BUILDING")
    orders = t["orders"].filter(col("o_orderdate") < "1995-03-15")
    li = t["lineitem"].filter(col("l_shipdate") > "1995-03-15")
    return (cust.join(orders, on=col("c_custkey") == col("o_custkey"))
            .join(li, on=col("o_orderkey") == col("l_orderkey"))
            .group_by(col("l_orderkey"), col("o_orderdate"),
                      col("o_shippriority"))
            .agg(F.sum(col("l_extendedprice")
                       * (lit(1.0) - col("l_discount"))).alias("revenue"))
            .order_by(SortOrder(col("revenue"), ascending=False),
                      "o_orderdate")
            .limit(10))


def q4(t):
    orders = t["orders"].filter(
        (col("o_orderdate") >= "1993-07-01")
        & (col("o_orderdate") < "1993-10-01"))
    late = t["lineitem"].filter(col("l_commitdate") < col("l_receiptdate"))
    return (orders.join(late, on=col("o_orderkey") == col("l_orderkey"),
                        how="left_semi")
            .group_by(col("o_orderpriority"))
            .agg(F.count(lit(1)).alias("order_count"))
            .order_by("o_orderpriority"))


def q18(t, min_qty: float = 300):
    """TPC-H q18: the 100 largest orders (by total price) whose lines sum
    above `min_qty` (300 in TPC-H)."""
    big = (t["lineitem"].group_by(col("l_orderkey"))
           .agg(F.sum(col("l_quantity")).alias("sum_qty"))
           .filter(col("sum_qty") > min_qty)
           .select(col("l_orderkey").alias("big_key"), col("sum_qty")))
    return (t["orders"]
            .join(big, on=col("o_orderkey") == col("big_key"))
            .join(t["customer"], on=col("o_custkey") == col("c_custkey"))
            .select(col("c_name"), col("c_custkey"), col("o_orderkey"),
                    col("o_orderdate"), col("o_totalprice"), col("sum_qty"))
            .order_by(SortOrder(col("o_totalprice"), ascending=False),
                      "o_orderdate")
            .limit(100))


def q12(t):
    """TPC-H q12: late lines shipped by mail or ship in 1994, counted by
    ship mode and by whether their order's priority is high."""
    li = t["lineitem"].filter(
        col("l_shipmode").isin("MAIL", "SHIP")
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= "1994-01-01")
        & (col("l_receiptdate") < "1995-01-01"))
    hi = F.when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                1).otherwise(0)
    lo = F.when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                0).otherwise(1)
    return (t["orders"].join(li, on=col("o_orderkey") == col("l_orderkey"))
            .group_by(col("l_shipmode"))
            .agg(F.sum(hi).alias("high_line_count"),
                 F.sum(lo).alias("low_line_count"))
            .order_by("l_shipmode"))


Q22_CODES = ["13", "31", "23", "29", "30", "18", "17"]


def q22(t):
    """TPC-H q22: customers of seven country codes with an above-average
    positive balance and no order, counted and summed by code.  The
    average is collected first, in a query of its own."""
    cust = t["customer"].with_column("cntrycode",
                                     col("c_phone").substr(1, 2))
    cust = cust.filter(col("cntrycode").isin(*Q22_CODES))
    avg_bal = cust.filter(col("c_acctbal") > 0.0) \
        .agg(F.avg(col("c_acctbal")).alias("a")).collect()[0][0] or 0.0
    rich = cust.filter(col("c_acctbal") > avg_bal)
    no_orders = rich.join(t["orders"],
                          on=col("c_custkey") == col("o_custkey"),
                          how="left_anti")
    return (no_orders.group_by(col("cntrycode"))
            .agg(F.count(lit(1)).alias("numcust"),
                 F.sum(col("c_acctbal")).alias("totacctbal"))
            .order_by("cntrycode"))


def q13(t):
    """TPC-H q13: how many customers have each number of orders, the
    orders whose comment mentions special requests left out; a customer
    without an order counts 0 (a left outer join)."""
    orders = t["orders"].filter(STRING_FILTERS["q13_not_special_requests"][0])
    per_cust = (t["customer"]
                .join(orders, on=col("c_custkey") == col("o_custkey"),
                      how="left")
                .with_column("has_order",
                             F.when(col("o_orderkey").is_null(), 0)
                             .otherwise(1))
                .group_by(col("c_custkey"))
                .agg(F.sum(col("has_order")).alias("c_count")))
    return (per_cust.group_by(col("c_count"))
            .agg(F.count(lit(1)).alias("custdist"))
            .order_by(SortOrder(col("custdist"), ascending=False),
                      SortOrder(col("c_count"), ascending=False)))


def q14(t):
    """TPC-H q14: the share of one month's discounted revenue that comes
    from PROMO parts, in percent: a global aggregate divided by another."""
    li = t["lineitem"].filter((col("l_shipdate") >= "1995-09-01")
                              & (col("l_shipdate") < "1995-10-01"))
    joined = li.join(t["part"], on=col("l_partkey") == col("p_partkey"))
    disc = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    promo = F.when(col("p_type").startswith("PROMO"), disc).otherwise(0.0)
    return joined.agg(
        ((F.sum(promo) * 100.0) / F.sum(disc)).alias("promo_revenue"))


def q17(t):
    """TPC-H q17: the yearly revenue lost on small orders of one brand and
    container: the lines whose quantity is below a fifth of their part's
    average (a grouped aggregate times a literal, joined back to the
    lines), summed and divided by 7."""
    part = t["part"].filter((col("p_brand") == "Brand#23")
                            & (col("p_container") == "MED BOX"))
    li = t["lineitem"].join(part, on=col("l_partkey") == col("p_partkey"))
    avg_qty = (li.group_by(col("p_partkey"))
               .agg((F.avg(col("l_quantity")) * 0.2).alias("limit_qty"))
               .select(col("p_partkey").alias("ak"), col("limit_qty")))
    return (li.join(avg_qty, on=col("p_partkey") == col("ak"))
            .filter(col("l_quantity") < col("limit_qty"))
            .agg((F.sum(col("l_extendedprice")) / 7.0)
                 .alias("avg_yearly")))


def q5(t):
    """TPC-H q5: the revenue of ASIA's nations in 1994 from lines whose
    supplier and customer share a nation (a join on two keys)."""
    return (t["region"].filter(col("r_name") == "ASIA")
            .join(t["nation"], on=col("r_regionkey") == col("n_regionkey"))
            .join(t["supplier"], on=col("n_nationkey") == col("s_nationkey"))
            .join(t["lineitem"], on=col("s_suppkey") == col("l_suppkey"))
            .join(t["orders"].filter(
                (col("o_orderdate") >= "1994-01-01")
                & (col("o_orderdate") < "1995-01-01")),
                on=col("l_orderkey") == col("o_orderkey"))
            .join(t["customer"],
                  on=(col("o_custkey") == col("c_custkey"))
                  & (col("c_nationkey") == col("s_nationkey")))
            .group_by(col("n_name"))
            .agg(F.sum(col("l_extendedprice")
                       * (lit(1.0) - col("l_discount"))).alias("revenue"))
            .order_by(SortOrder(col("revenue"), ascending=False)))


def q10(t):
    """TPC-H q10: the 20 customers with the most revenue lost to returned
    lines of one quarter's orders, grouped by seven customer columns."""
    orders = t["orders"].filter((col("o_orderdate") >= "1993-10-01")
                                & (col("o_orderdate") < "1994-01-01"))
    li = t["lineitem"].filter(col("l_returnflag") == "R")
    return (t["customer"]
            .join(orders, on=col("c_custkey") == col("o_custkey"))
            .join(li, on=col("o_orderkey") == col("l_orderkey"))
            .join(t["nation"], on=col("c_nationkey") == col("n_nationkey"))
            .group_by(col("c_custkey"), col("c_name"), col("c_acctbal"),
                      col("c_phone"), col("n_name"), col("c_address"),
                      col("c_comment"))
            .agg(F.sum(col("l_extendedprice")
                       * (lit(1.0) - col("l_discount"))).alias("revenue"))
            .order_by(SortOrder(col("revenue"), ascending=False))
            .limit(20))


def q15(t):
    """TPC-H q15: the suppliers with the most revenue in one quarter.  The
    maximum is collected first, in a query of its own."""
    li = t["lineitem"].filter((col("l_shipdate") >= "1996-01-01")
                              & (col("l_shipdate") < "1996-04-01"))
    revenue = (li.group_by(col("l_suppkey"))
               .agg(F.sum(col("l_extendedprice")
                          * (lit(1.0) - col("l_discount")))
                    .alias("total_revenue")))
    top = revenue.agg(F.max(col("total_revenue")).alias("m")) \
        .collect()[0][0] or 0.0
    return (t["supplier"]
            .join(revenue.filter(col("total_revenue") >= top - 1e-6),
                  on=col("s_suppkey") == col("l_suppkey"))
            .select(col("s_suppkey"), col("s_name"), col("s_address"),
                    col("s_phone"), col("total_revenue"))
            .order_by("s_suppkey"))


Q19_BRANCHES = [  # brand, containers, quantity range, largest size
    ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), (1, 11), 5),
    ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), (10, 20),
     10),
    ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), (20, 30), 15)]


def q19(t):
    """TPC-H q19: the discounted revenue of lines shipped by air in
    person whose part matches one of three brand, container, quantity
    and size conditions (an OR of three conjunctions)."""
    li = t["lineitem"].filter(
        col("l_shipmode").isin("AIR", "REG AIR")
        & (col("l_shipinstruct") == "DELIVER IN PERSON"))
    joined = li.join(t["part"], on=col("l_partkey") == col("p_partkey"))
    b1, b2, b3 = [(col("p_brand") == brand)
                  & col("p_container").isin(*containers)
                  & col("l_quantity").between(*qty)
                  & col("p_size").between(1, size)
                  for brand, containers, qty, size in Q19_BRANCHES]
    return (joined.filter(b1 | b2 | b3)
            .agg(F.sum(col("l_extendedprice")
                       * (lit(1.0) - col("l_discount"))).alias("revenue")))


def _q21_lines(t, dsl=_L):
    """q21's lines of finished orders, and those of them received
    late."""
    col = dsl.col
    f_orders = t["orders"].filter(col("o_orderstatus") == "F") \
        .select(col("o_orderkey"))
    li = t["lineitem"].join(f_orders,
                            on=col("l_orderkey") == col("o_orderkey"),
                            how="left_semi")
    return li, li.filter(col("l_receiptdate") > col("l_commitdate"))


def _q21_blamed(t, late, supp_per_order, late_per_order, dsl=_L):
    """q21 from its late lines and the per-order counts of suppliers
    (`all_key`, `nsupp`) and of late suppliers (`late_key`, `nlate`)."""
    col, lit, F = dsl.col, dsl.lit, dsl.functions
    nation = t["nation"].filter(col("n_name") == "SAUDI ARABIA")
    blamed = (late
              .join(supp_per_order, on=col("l_orderkey") == col("all_key"))
              .join(late_per_order, on=col("l_orderkey") == col("late_key"))
              .filter((col("nsupp") > 1) & (col("nlate") == 1)))
    return (blamed
            .join(t["supplier"], on=col("l_suppkey") == col("s_suppkey"))
            .join(nation, on=col("s_nationkey") == col("n_nationkey"))
            .group_by(col("s_name"))
            .agg(F.count(lit(1)).alias("numwait"))
            .order_by(dsl.SortOrder(col("numwait"), ascending=False),
                      "s_name")
            .limit(100))


def q21(t):
    """TPC-H q21 as benchmarks/tpch/queries.py writes it: the SAUDI
    ARABIA suppliers who were the one late supplier of a finished order
    with several suppliers, counted per supplier, the 100 most first."""
    li, late = _q21_lines(t)
    # per order: number of distinct suppliers, and of distinct late ones
    supp_per_order = (li.group_by(col("l_orderkey"), col("l_suppkey"))
                      .agg(F.count(lit(1)).alias("_c"))
                      .group_by(col("l_orderkey"))
                      .agg(F.count(lit(1)).alias("nsupp"))
                      .select(col("l_orderkey").alias("all_key"),
                              col("nsupp")))
    late_per_order = (late.group_by(col("l_orderkey"), col("l_suppkey"))
                      .agg(F.count(lit(1)).alias("_c"))
                      .group_by(col("l_orderkey"))
                      .agg(F.count(lit(1)).alias("nlate"))
                      .select(col("l_orderkey").alias("late_key"),
                              col("nlate")))
    return _q21_blamed(t, late, supp_per_order, late_per_order)


def q2(t):
    """TPC-H q2: for each size-15 BRASS part, the EUROPE suppliers that
    offer it at its lowest EUROPE cost (a per-part minimum joined back on
    two keys), the 100 with the highest balance first."""
    part = t["part"].filter((col("p_size") == 15)
                            & col("p_type").endswith("BRASS"))
    europe = (t["region"].filter(col("r_name") == "EUROPE")
              .join(t["nation"],
                    on=col("r_regionkey") == col("n_regionkey"))
              .join(t["supplier"],
                    on=col("n_nationkey") == col("s_nationkey")))
    ps = t["partsupp"].join(europe,
                            on=col("ps_suppkey") == col("s_suppkey"))
    joined = part.join(ps, on=col("p_partkey") == col("ps_partkey"))
    mins = (joined.group_by(col("p_partkey"))
            .agg(F.min(col("ps_supplycost")).alias("min_cost"))
            .select(col("p_partkey").alias("mk"), col("min_cost")))
    return (joined.join(mins, on=(col("p_partkey") == col("mk"))
                        & (col("ps_supplycost") == col("min_cost")))
            .select(col("s_acctbal"), col("s_name"), col("n_name"),
                    col("p_partkey"), col("p_mfgr"), col("s_address"),
                    col("s_phone"), col("s_comment"))
            .order_by(SortOrder(col("s_acctbal"), ascending=False),
                      "n_name", "s_name", "p_partkey")
            .limit(100))


def q7(t):
    """TPC-H q7: the discounted revenue of 1995-1996 lines shipped between
    FRANCE and GERMANY, either way, by supplier nation, customer nation
    and ship year (Year)."""
    n1 = t["nation"].select(col("n_nationkey").alias("n1_key"),
                            col("n_name").alias("supp_nation"))
    n2 = t["nation"].select(col("n_nationkey").alias("n2_key"),
                            col("n_name").alias("cust_nation"))
    li = t["lineitem"].filter(col("l_shipdate").between("1995-01-01",
                                                        "1996-12-31"))
    joined = (li.join(t["supplier"], on=col("l_suppkey") == col("s_suppkey"))
              .join(t["orders"], on=col("l_orderkey") == col("o_orderkey"))
              .join(t["customer"], on=col("o_custkey") == col("c_custkey"))
              .join(n1, on=col("s_nationkey") == col("n1_key"))
              .join(n2, on=col("c_nationkey") == col("n2_key"))
              .filter(((col("supp_nation") == "FRANCE")
                       & (col("cust_nation") == "GERMANY"))
                      | ((col("supp_nation") == "GERMANY")
                         & (col("cust_nation") == "FRANCE"))))
    return (joined
            .with_column("l_year", F.year(col("l_shipdate")))
            .with_column("volume", col("l_extendedprice")
                         * (lit(1.0) - col("l_discount")))
            .group_by(col("supp_nation"), col("cust_nation"), col("l_year"))
            .agg(F.sum(col("volume")).alias("revenue"))
            .order_by("supp_nation", "cust_nation", "l_year"))


def q8(t):
    """TPC-H q8: BRAZIL's share of the revenue of one part type sold to
    AMERICA's customers, by order year (Year): a sum of a conditional
    divided by a sum."""
    n1 = t["nation"].select(col("n_nationkey").alias("n1_key"),
                            col("n_regionkey").alias("n1_region"))
    n2 = t["nation"].select(col("n_nationkey").alias("n2_key"),
                            col("n_name").alias("supp_nation"))
    america = t["region"].filter(col("r_name") == "AMERICA")
    part = t["part"].filter(col("p_type") == "ECONOMY ANODIZED STEEL")
    orders = t["orders"].filter(col("o_orderdate").between("1995-01-01",
                                                           "1996-12-31"))
    joined = (part.join(t["lineitem"],
                        on=col("p_partkey") == col("l_partkey"))
              .join(t["supplier"], on=col("l_suppkey") == col("s_suppkey"))
              .join(orders, on=col("l_orderkey") == col("o_orderkey"))
              .join(t["customer"], on=col("o_custkey") == col("c_custkey"))
              .join(n1, on=col("c_nationkey") == col("n1_key"))
              .join(america, on=col("n1_region") == col("r_regionkey"))
              .join(n2, on=col("s_nationkey") == col("n2_key")))
    vol = (joined
           .with_column("o_year", F.year(col("o_orderdate")))
           .with_column("volume", col("l_extendedprice")
                        * (lit(1.0) - col("l_discount")))
           .with_column("brazil_volume",
                        F.when(col("supp_nation") == "BRAZIL",
                               col("volume")).otherwise(0.0)))
    return (vol.group_by(col("o_year"))
            .agg((F.sum(col("brazil_volume"))
                  / F.sum(col("volume"))).alias("mkt_share"))
            .order_by("o_year"))


def q9(t):
    """TPC-H q9: the profit on "green" parts by supplier nation and order
    year (Year), through a join to partsupp on two keys."""
    part = t["part"].filter(col("p_name").contains("green"))
    joined = (part.join(t["lineitem"],
                        on=col("p_partkey") == col("l_partkey"))
              .join(t["supplier"], on=col("l_suppkey") == col("s_suppkey"))
              .join(t["partsupp"],
                    on=(col("ps_partkey") == col("l_partkey"))
                    & (col("ps_suppkey") == col("l_suppkey")))
              .join(t["orders"], on=col("l_orderkey") == col("o_orderkey"))
              .join(t["nation"], on=col("s_nationkey") == col("n_nationkey")))
    return (joined
            .with_column("o_year", F.year(col("o_orderdate")))
            .with_column("amount",
                         col("l_extendedprice")
                         * (lit(1.0) - col("l_discount"))
                         - col("ps_supplycost") * col("l_quantity"))
            .group_by(col("n_name"), col("o_year"))
            .agg(F.sum(col("amount")).alias("sum_profit"))
            .order_by("n_name", SortOrder(col("o_year"), ascending=False)))


# the share of GERMANY's stock value a part must pass in q11 as
# benchmarks/tpch/queries.py writes it; TPC-H's own is 0.0001 / SF
Q11_FRACTION = 0.0001


def q11(t, fraction: float = Q11_FRACTION):
    """TPC-H q11: the parts whose GERMANY stock value passes `fraction`
    of the whole, whose sum is collected first, in a query of its own."""
    germany = t["nation"].filter(col("n_name") == "GERMANY")
    ps = (t["partsupp"]
          .join(t["supplier"], on=col("ps_suppkey") == col("s_suppkey"))
          .join(germany, on=col("s_nationkey") == col("n_nationkey"))
          .with_column("value", col("ps_supplycost") * col("ps_availqty")))
    total = ps.agg(F.sum(col("value")).alias("tv")).collect()[0][0] or 0.0
    return (ps.group_by(col("ps_partkey"))
            .agg(F.sum(col("value")).alias("value"))
            .filter(col("value") > total * fraction)
            .order_by(SortOrder(col("value"), ascending=False)))


Q16_SIZES = (49, 14, 23, 45, 19, 3, 36, 9)


def _q16_partsupp(t, dsl=_L):
    """q16's partsupp rows: suppliers without complaints, parts of the
    sizes, brands and types it keeps."""
    col = dsl.col
    part = t["part"].filter(
        (col("p_brand") != "Brand#45")
        & ~col("p_type").startswith("MEDIUM POLISHED")
        & col("p_size").isin(*Q16_SIZES))
    bad_supp = t["supplier"].filter(
        col("s_comment").contains("Customer")
        & col("s_comment").contains("Complaints"))
    return (t["partsupp"]
            .join(bad_supp, on=col("ps_suppkey") == col("s_suppkey"),
                  how="left_anti")
            .join(part, on=col("ps_partkey") == col("p_partkey")))


def q16(t):
    """TPC-H q16: how many suppliers without complaints offer parts of
    each brand, type and size (a left_anti join, then a distinct count as
    two levels of grouping by string keys)."""
    ps = _q16_partsupp(t)
    distinct_ps = (ps.group_by(col("p_brand"), col("p_type"), col("p_size"),
                               col("ps_suppkey"))
                   .agg(F.count(lit(1)).alias("_c")))
    return (distinct_ps.group_by(col("p_brand"), col("p_type"),
                                 col("p_size"))
            .agg(F.count(lit(1)).alias("supplier_cnt"))
            .order_by(SortOrder(col("supplier_cnt"), ascending=False),
                      "p_brand", "p_type", "p_size"))


def q20(t, prefix: str = "forest", nation: str = "CANADA"):
    """TPC-H q20: the suppliers of `nation` that hold more than half of
    1994's shipped quantity of a part whose name starts with `prefix` (a
    two-key aggregate of the year's lines joined to partsupp on both
    keys).  The JAX datagen draws a line's supplier apart from its
    part's partsupp rows, so a line meets one of them with probability
    4 / suppliers: about 365 (part, supplier) pairs of 1994 match at any
    scale, ~4 of them "forest" parts, and CANADA keeps one with
    probability ~0.15.  `prefix=""` keeps every part."""
    forest_parts = t["part"].filter(col("p_name").startswith(prefix)) \
        .select(col("p_partkey").alias("fp_key"))
    li94 = t["lineitem"].filter((col("l_shipdate") >= "1994-01-01")
                                & (col("l_shipdate") < "1995-01-01"))
    half_qty = (li94.group_by(col("l_partkey"), col("l_suppkey"))
                .agg((F.sum(col("l_quantity")) * 0.5).alias("half_qty")))
    ps = (t["partsupp"]
          .join(forest_parts, on=col("ps_partkey") == col("fp_key"),
                how="left_semi")
          .join(half_qty, on=(col("ps_partkey") == col("l_partkey"))
                & (col("ps_suppkey") == col("l_suppkey")))
          .filter(col("ps_availqty") > col("half_qty")))
    canada = t["nation"].filter(col("n_name") == nation)
    return (t["supplier"]
            .join(ps, on=col("s_suppkey") == col("ps_suppkey"),
                  how="left_semi")
            .join(canada, on=col("s_nationkey") == col("n_nationkey"))
            .select(col("s_name"), col("s_address"))
            .order_by("s_name"))


# the lineitem-only queries take the lineitem DataFrame, the joins a dict
# of DataFrames by table name
QUERIES = {"q1": q1, "q6": q6, "q18_inner": q18_inner}
JOIN_QUERIES = {"q3": q3, "q4": q4, "q12": q12, "q13": q13, "q14": q14,
                "q17": q17, "q18": q18, "q22": q22, "q5": q5, "q10": q10,
                "q15": q15, "q19": q19, "q21": q21, "q2": q2, "q7": q7,
                "q8": q8, "q9": q9, "q11": q11, "q16": q16, "q20": q20}


# --------------------------------------------------------------------------
# date arithmetic and casts over lineitem
# --------------------------------------------------------------------------

def ship_delay(li):
    """A monthly shipping-delay report: per month of the ship date, the
    lines, their days in transit and past the commit date, the lines
    received more than 14 days after it, and the first Monday after a
    shipment."""
    ship, commit = col("l_shipdate"), col("l_commitdate")
    receipt = col("l_receiptdate")
    return (li.group_by(F.trunc(ship, "month").alias("month"))
            .agg(F.count(lit(1)).alias("lines"),
                 F.sum(F.datediff(receipt, ship)).alias("transit_days"),
                 F.sum(F.datediff(receipt, commit)).alias("days_late"),
                 F.sum(F.when(receipt > F.date_add(commit, 14), 1)
                       .otherwise(0)).alias("late_over_14"),
                 F.min(F.next_day(ship, "MO")).alias("first_monday"))
            .order_by("month"))


def q6_text(li):
    """q6 with the ship date carried as text (`yyyy-MM-dd`) and parsed
    back for its bounds."""
    shipped = F.to_date(col("l_shiptext"))
    return (li.with_column("l_shiptext", col("l_shipdate").cast("string"))
            .filter((shipped >= "1994-01-01") & (shipped < "1995-01-01")
                    & col("l_discount").between(0.05, 0.07)
                    & (col("l_quantity") < 24))
            .agg(F.sum(col("l_extendedprice") * col("l_discount"))
                 .alias("revenue")))


DATE_QUERIES = {"ship_delay": ship_delay, "q6_text": q6_text}


# --------------------------------------------------------------------------
# text casts: lineitem's numbers read as text, and keys and flags written
# as text and read back
# --------------------------------------------------------------------------

# the columns q1 reads, its four numbers as text
LINEITEM_TEXT = Schema([StructField("l_returnflag", StringType),
                        StructField("l_linestatus", StringType),
                        StructField("l_shipdate", DateType),
                        StructField("l_quantity", StringType),
                        StructField("l_extendedprice", StringType),
                        StructField("l_discount", StringType),
                        StructField("l_tax", StringType)])


def text_lineitem(li: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The columns of LINEITEM_TEXT from lineitem `li`, the quantity,
    price, discount and tax written as a CSV file holds them ("17",
    "24386.67", "0.04", "0.02"; 8 bytes at most): each from its cents as
    an integer, so the text parses back to the double the generator's
    np.round(x, 2) gave (one division of the cents by 100, rounded)."""
    out = {k: li[k] for k in ("l_returnflag", "l_linestatus", "l_shipdate")}
    out["l_quantity"] = _decimal_text(li["l_quantity"].astype(np.int64))
    for k in ("l_extendedprice", "l_discount", "l_tax"):
        out[k] = _decimal_text(np.rint(li[k] * 100).astype(np.int64), 2)
    return out


def q1_text(li):
    """q1 over LINEITEM_TEXT: the quantity cast back to int and the
    price, discount and tax to double (which needs castStringToFloat),
    then q1 unchanged; sum_qty is then a long."""
    return q1(li.select(
        col("l_returnflag"), col("l_linestatus"), col("l_shipdate"),
        col("l_quantity").cast("int").alias("l_quantity"),
        *[col(k).cast("double").alias(k)
          for k in ("l_extendedprice", "l_discount", "l_tax")]))


def text_roundtrip(li):
    """A job that reads back the keys and flags an earlier job wrote as
    text: the lines, those whose order key comes back from its text
    unchanged (all of them), those with a quantity over 24 (through the
    text of the comparison, "true" or "false"), and the return flags
    that read as a boolean (only "N", as false)."""
    key = col("l_orderkey")
    return li.agg(
        F.count(lit(1)).alias("lines"),
        F.sum((key.cast("string").cast("long") == key).cast("int"))
        .alias("keys_back"),
        F.sum((col("l_quantity") > 24).cast("string").cast("boolean")
              .cast("long")).alias("over_24"),
        F.count(col("l_returnflag").cast("boolean")).alias("flags_read"))


TEXT_QUERIES = {"q1_text": q1_text, "text_roundtrip": text_roundtrip}
# the table each reads: LINEITEM_TEXT's columns, or lineitem itself
TEXT_INPUTS = {"q1_text": "lineitem_text", "text_roundtrip": "lineitem"}


# --------------------------------------------------------------------------
# math, bitwise and hash expressions over lineitem.  Each takes `dsl`: the
# module whose col, lit, functions, ColumnExpr and SortOrder build it
# (this package's plan.logical by default; the JAX package's has the same
# names, so the tests build the same trees there)
# --------------------------------------------------------------------------

def price_dispersion(li, dsl=_L):
    """Per supplier: its lines, mean price, the sample standard deviation
    of the price (the square root of a variance that is null for one
    line) and their ratio rounded to 4 places (`cov`); the 100 suppliers
    of the widest spread, by the unrounded ratio, then the key.  TPC-DS
    q17's and q39's stdev / mean over TPC-H's lines."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    price, n, total = col("l_extendedprice"), col("lines"), col("total")
    mean = total / n
    stdev = F.sqrt(F.when(n > 1, (col("squares") - total * mean)
                          / (n - 1)))
    return (li.group_by(col("l_suppkey"))
            .agg(F.count(lit(1)).alias("lines"),
                 F.sum(price).alias("total"),
                 F.sum(price * price).alias("squares"))
            .select(col("l_suppkey"), n, mean.alias("mean"),
                    stdev.alias("stdev"),
                    F.round(stdev / mean, 4).alias("cov"))
            .order_by(dsl.SortOrder(col("stdev") / col("mean"),
                                    ascending=False), "l_suppkey")
            .limit(100))


def price_decades(li, dsl=_L):
    """A log-scale histogram of the line prices, ten bins a decade
    (floor(log10(price) * 10)), each with its lines, the mean discount in
    percent rounded to 2 places, and its lower edge 10^(bin / 10) rounded
    to cents, in bin order (TPC-DS q54's floor segments)."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    log10 = dsl.ColumnExpr("Log10", (col("l_extendedprice"),))
    return (li.select(F.floor(log10 * 10).alias("bin"), col("l_discount"))
            .group_by(col("bin"))
            .agg(F.count(lit(1)).alias("lines"),
                 F.round(F.avg(col("l_discount")) * 100, 2)
                 .alias("discount_pct"))
            .select(col("bin"),
                    F.round(F.pow(10, col("bin") / 10), 2)
                    .alias("lower_edge"),
                    col("lines"), col("discount_pct"))
            .order_by("bin"))


HASH_PARTITIONS = 200  # Spark's spark.sql.shuffle.partitions default


def hash_partitions(li, dsl=_L):
    """The partition Spark's HashPartitioning gives each line in a
    shuffle on l_orderkey, pmod(hash(l_orderkey), 200), with the lines
    and quantity each partition receives, in partition order."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    part = dsl.ColumnExpr("Pmod", (F.hash(col("l_orderkey")),
                                   lit(HASH_PARTITIONS)))
    return (li.group_by(part.alias("partition"))
            .agg(F.count(lit(1)).alias("lines"),
                 F.sum(col("l_quantity")).alias("quantity"))
            .order_by("partition"))


SAMPLE_COLUMNS = ("l_orderkey", "l_suppkey", "l_extendedprice", "l_shipdate",
                  "l_shipmode")


def hash_sample(li, dsl=_L):
    """A deterministic 1-in-64 sample of the lines: those whose hash over
    SAMPLE_COLUMNS (two longs, a double, a date and a string) has its low
    6 bits clear, counted with their quantity per top 3 bits of the hash
    (ShiftRightUnsigned by 29: 8 groups), in group order."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    h = col("h")
    return (li.select(F.hash(*[col(c) for c in SAMPLE_COLUMNS]).alias("h"),
                      col("l_quantity"))
            .filter(dsl.ColumnExpr("BitwiseAnd", (h, lit(63))) == 0)
            .group_by(dsl.ColumnExpr("ShiftRightUnsigned", (h, lit(29)))
                      .alias("group"))
            .agg(F.count(lit(1)).alias("lines"),
                 F.sum(col("l_quantity")).alias("quantity"))
            .order_by("group"))


MATH_QUERIES = {"price_dispersion": price_dispersion,
                "price_decades": price_decades,
                "hash_partitions": hash_partitions,
                "hash_sample": hash_sample}


# --------------------------------------------------------------------------
# First, Last, distinct aggregates and string Min/Max.  Each takes the
# dict of DataFrames by table name and `dsl`, as MATH_QUERIES do
# --------------------------------------------------------------------------

def q16_distinct(t, dsl=_L):
    """TPC-H q16 as its specification writes it: count(distinct
    ps_suppkey) by brand, type and size.  Its rows are q16's."""
    F, col = dsl.functions, dsl.col
    return (_q16_partsupp(t, dsl)
            .group_by(col("p_brand"), col("p_type"), col("p_size"))
            .agg(F.count_distinct(col("ps_suppkey")).alias("supplier_cnt"))
            .order_by(dsl.SortOrder(col("supplier_cnt"), ascending=False),
                      "p_brand", "p_type", "p_size"))


def q21_distinct(t, dsl=_L):
    """TPC-H q21 with its per-order counts of suppliers and of late
    suppliers as count(distinct l_suppkey).  Its rows are q21's."""
    F, col = dsl.functions, dsl.col
    li, late = _q21_lines(t, dsl)

    def suppliers(lines, key, name):
        return (lines.group_by(col("l_orderkey"))
                .agg(F.count_distinct(col("l_suppkey")).alias(name))
                .select(col("l_orderkey").alias(key), col(name)))
    return _q21_blamed(t, late, suppliers(li, "all_key", "nsupp"),
                       suppliers(late, "late_key", "nlate"), dsl)


def priority_migration(t, dsl=_L):
    """Each customer's first and last order priority, the date of the
    first order and the price of the last (the latest record per key:
    orders sorted by date and key, then first/last), then per (first,
    last) priority pair its customers, earliest first order and summed
    last prices: 25 rows."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    per_customer = (t["orders"].order_by("o_orderdate", "o_orderkey")
                    .group_by(col("o_custkey"))
                    .agg(F.first(col("o_orderpriority"))
                         .alias("first_priority"),
                         F.last(col("o_orderpriority"))
                         .alias("last_priority"),
                         F.first(col("o_orderdate")).alias("first_date"),
                         F.last(col("o_totalprice")).alias("last_price")))
    return (per_customer.group_by(col("first_priority"),
                                  col("last_priority"))
            .agg(F.count(lit(1)).alias("customers"),
                 F.min(col("first_date")).alias("earliest"),
                 F.sum(col("last_price")).alias("last_price_sum"))
            .order_by("first_priority", "last_priority"))


def segment_bounds(t, dsl=_L):
    """Per market segment: the least and greatest customer name, the
    least address, the greatest comment and the distinct nations."""
    F, col = dsl.functions, dsl.col
    return (t["customer"].group_by(col("c_mktsegment"))
            .agg(F.min(col("c_name")).alias("min_name"),
                 F.max(col("c_name")).alias("max_name"),
                 F.min(col("c_address")).alias("min_address"),
                 F.max(col("c_comment")).alias("max_comment"),
                 F.count_distinct(col("c_nationkey")).alias("nations"))
            .order_by("c_mktsegment"))


def urgent_summary(t, dsl=_L):
    """One row over the 1-URGENT orders: their distinct customers, least
    and greatest comment, first and last order key, and count."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    return (t["orders"].filter(col("o_orderpriority") == "1-URGENT")
            .agg(F.count_distinct(col("o_custkey")).alias("customers"),
                 F.min(col("o_comment")).alias("min_comment"),
                 F.max(col("o_comment")).alias("max_comment"),
                 F.first(col("o_orderkey")).alias("first_order"),
                 F.last(col("o_orderkey")).alias("last_order"),
                 F.count(lit(1)).alias("orders")))


AGG_QUERIES = {"q16_distinct": q16_distinct, "q21_distinct": q21_distinct,
               "priority_migration": priority_migration,
               "segment_bounds": segment_bounds,
               "urgent_summary": urgent_summary}


# --------------------------------------------------------------------------
# union, distinct, rollup and cube: TPC-DS's report shapes over TPC-H's
# tables.  Each takes the dict of DataFrames by table name and `dsl`.  A
# rollup's keys are made by a select (pruning stops at with_column)
# --------------------------------------------------------------------------

def q1_rollup(t, dsl=_L):
    """q1 with its subtotals per return flag and a grand total (TPC-DS
    q27's, q36's and q86's ROLLUP): 10 rows, keys ascending, nulls
    first."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    li = (t["lineitem"].filter(col("l_shipdate") <= "1998-09-02")
          .select(col("l_returnflag"), col("l_linestatus"),
                  col("l_quantity"), col("l_extendedprice"),
                  col("l_discount"), col("l_tax")))
    disc = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (li.rollup(col("l_returnflag"), col("l_linestatus"))
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.sum(col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(disc).alias("sum_disc_price"),
                 F.sum(disc * (lit(1.0) + col("l_tax"))).alias("sum_charge"),
                 F.avg(col("l_quantity")).alias("avg_qty"),
                 F.avg(col("l_extendedprice")).alias("avg_price"),
                 F.avg(col("l_discount")).alias("avg_disc"),
                 F.count(lit(1)).alias("count_order"))
            .order_by("l_returnflag", "l_linestatus"))


def cube_orders(t, dsl=_L):
    """The orders by every subset of (priority, status): count, total and
    mean price (a CUBE of two keys): 24 rows."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    return (t["orders"].select(col("o_orderpriority"), col("o_orderstatus"),
                               col("o_totalprice"))
            .cube(col("o_orderpriority"), col("o_orderstatus"))
            .agg(F.count(lit(1)).alias("orders"),
                 F.sum(col("o_totalprice")).alias("total"),
                 F.avg(col("o_totalprice")).alias("avg_price"))
            .order_by("o_orderpriority", "o_orderstatus"))


def rollup_nation_year(t, dsl=_L):
    """Order revenue by region, nation and year with every subtotal, over
    orders joined to customer, nation and region (TPC-DS q18's, q22's and
    q67's three-level ROLLUP over a join): 206 rows."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    joined = (t["orders"]
              .join(t["customer"], col("o_custkey") == col("c_custkey"))
              .join(t["nation"], col("c_nationkey") == col("n_nationkey"))
              .join(t["region"], col("n_regionkey") == col("r_regionkey")))
    return (joined.select(col("r_name"), col("n_name"),
                          F.year(col("o_orderdate")).alias("o_year"),
                          col("o_totalprice"))
            .rollup(col("r_name"), col("n_name"), col("o_year"))
            .agg(F.sum(col("o_totalprice")).alias("revenue"),
                 F.count(lit(1)).alias("orders"))
            .order_by("r_name", "n_name", "o_year"))


def _in_1995(dsl):
    col = dsl.col
    return (col("l_shipdate") >= "1995-01-01") \
        & (col("l_shipdate") < "1996-01-01")


def union_supply(t, dsl=_L):
    """Each supplier's 1995 revenue less the value of its stock, as one
    channel of lines unioned with one of partsupp rows, then summed per
    supplier (TPC-DS q5's, q77's and q80's union of channels): the 100
    of the largest net amount, then the key."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    lines = t["lineitem"].filter(_in_1995(dsl)).select(
        col("l_suppkey").alias("supp"),
        (col("l_extendedprice") * (lit(1.0) - col("l_discount")))
        .alias("amount"))
    stock = t["partsupp"].select(
        col("ps_suppkey").alias("supp"),
        (-(col("ps_supplycost") * col("ps_availqty"))).alias("amount"))
    return (lines.union(stock).group_by(col("supp"))
            .agg(F.sum(col("amount")).alias("net"),
                 F.count(lit(1)).alias("entries"))
            .order_by(dsl.SortOrder(col("net"), ascending=False), "supp")
            .limit(100))


def supplier_reach(t, dsl=_L):
    """How many suppliers shipped a line by AIR in 1995 or hold a part
    with fewer than 100 available (TPC-DS q14's and q49's UNION, then
    DISTINCT): one row."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    air = t["lineitem"].filter((col("l_shipmode") == "AIR")
                               & _in_1995(dsl)) \
        .select(col("l_suppkey").alias("supp"))
    low = t["partsupp"].filter(col("ps_availqty") < 100) \
        .select(col("ps_suppkey").alias("supp"))
    return air.union(low).distinct().agg(
        F.count(lit(1)).alias("suppliers"))


def customer_priorities(t, dsl=_L):
    """Per order priority, the customers who placed an order of it: a
    DISTINCT over a long and a string (TPC-DS q1's, q41's and q95's),
    then a count per priority: 5 rows."""
    col = dsl.col
    return (t["orders"].select(col("o_custkey"), col("o_orderpriority"))
            .distinct().group_by(col("o_orderpriority")).count()
            .order_by("o_orderpriority"))


SET_QUERIES = {"q1_rollup": q1_rollup, "cube_orders": cube_orders,
               "rollup_nation_year": rollup_nation_year,
               "union_supply": union_supply,
               "supplier_reach": supplier_reach,
               "customer_priorities": customer_priorities}
# how many rows the top-N set query keeps, and the column it orders by
SET_TOP_N = {"union_supply": (100, 1)}


# --------------------------------------------------------------------------
# window functions: TPC-DS's window report shapes over TPC-H's tables.
# Each takes the dict of DataFrames by table name and `dsl`.  Every order
# key of a `rows` frame, or of a function whose value depends on the
# order of ties, is total (o_orderkey is unique), so no row depends on
# how ties fall.
# --------------------------------------------------------------------------

def revenue_ratio(t, dsl=_L):
    """Each part's revenue in March 1995 and its share of its brand's
    (TPC-DS q12's, q20's and q98's revenue ratio): the first 100 by
    brand, type and part."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    lines = t["lineitem"].filter((col("l_shipdate") >= "1995-03-01")
                                 & (col("l_shipdate") < "1995-03-31"))
    grouped = (lines.join(t["part"], col("l_partkey") == col("p_partkey"))
               .group_by(col("p_partkey"), col("p_brand"), col("p_type"))
               .agg(F.sum(col("l_extendedprice")).alias("itemrevenue")))
    w = dsl.Window.partition_by(col("p_brand"))
    return (grouped.with_column(
                "revenueratio", col("itemrevenue") * lit(100.0)
                / F.sum(col("itemrevenue")).over(w))
            .order_by("p_brand", "p_type", "p_partkey").limit(100))


def margin_rank(t, dsl=_L):
    """1995's revenue and gross by manufacturer and brand with their
    ROLLUP subtotals, the margin (revenue / gross) and its rank within
    the manufacturer (TPC-DS q36's, q70's and q86's rank within a
    parent): 131 rows."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    lines = (t["lineitem"].filter(_in_1995(dsl))
             .join(t["part"], col("l_partkey") == col("p_partkey")))
    rolled = (lines.select(col("p_mfgr"), col("p_brand"),
                           (col("l_extendedprice")
                            * (lit(1.0) - col("l_discount"))).alias("rev"),
                           col("l_extendedprice"))
              .rollup(col("p_mfgr"), col("p_brand"))
              .agg(F.sum(col("rev")).alias("revenue"),
                   F.sum(col("l_extendedprice")).alias("gross"))
              .with_column("margin", col("revenue") / col("gross")))
    w = dsl.Window.partition_by(col("p_mfgr")).order_by(col("margin"))
    return (rolled.with_column("rank_within_parent", F.rank().over(w))
            .order_by("p_mfgr", "rank_within_parent", "p_brand"))


def monthly_deviation(t, dsl=_L):
    """Monthly revenue by brand and ship mode, the mean month of its
    year, and the months before and after (TPC-DS q47's and q57's
    lag/lead and partition average): 1997's months more than 10% off
    their year's mean, the first 100 by mean descending, revenue, brand,
    mode and month."""
    F, col = dsl.functions, dsl.col
    monthly = (t["lineitem"]
               .join(t["part"], col("l_partkey") == col("p_partkey"))
               .select(col("p_brand"), col("l_shipmode"),
                       F.year(col("l_shipdate")).alias("d_year"),
                       F.month(col("l_shipdate")).alias("d_moy"),
                       col("l_extendedprice"))
               .group_by(col("p_brand"), col("l_shipmode"), col("d_year"),
                         col("d_moy"))
               .agg(F.sum(col("l_extendedprice")).alias("sum_sales")))
    w_avg = dsl.Window.partition_by(col("p_brand"), col("l_shipmode"),
                                    col("d_year"))
    w_seq = dsl.Window.partition_by(col("p_brand"), col("l_shipmode")) \
        .order_by(col("d_year"), col("d_moy"))
    avg = col("avg_monthly_sales")
    flagged = (monthly
               .with_column("avg_monthly_sales",
                            F.avg(col("sum_sales")).over(w_avg))
               .with_column("psum", F.lag(col("sum_sales"), 1).over(w_seq))
               .with_column("nsum", F.lead(col("sum_sales"), 1)
                            .over(w_seq))
               .filter((avg > 0)
                       & (F.abs(col("sum_sales") - avg) / avg > 0.1)
                       & (col("d_year") == 1997)))
    return (flagged.order_by(dsl.SortOrder(avg, ascending=False),
                             "sum_sales", "p_brand", "l_shipmode", "d_moy")
            .limit(100))


def running_spend(t, dsl=_L):
    """Each customer's orders by date and key with the running spend and
    count, the first priority, the greatest priority so far (a string)
    and the customer's first order date (a second spec over the whole
    partition) (TPC-DS q51's running sum): every customer's 10th order,
    the 100 of the largest running spend, then the customer."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    w = dsl.Window.partition_by(col("o_custkey")) \
        .order_by(col("o_orderdate"), col("o_orderkey"))
    whole = dsl.Window.partition_by(col("o_custkey"))
    return (t["orders"].select(
                col("o_custkey"), col("o_orderkey"), col("o_orderdate"),
                F.sum(col("o_totalprice")).over(w).alias("running_spend"),
                F.count(lit(1)).over(w).alias("order_no"),
                F.first(col("o_orderpriority")).over(w)
                .alias("first_priority"),
                F.max(col("o_orderpriority")).over(w).alias("max_priority"),
                F.min(col("o_orderdate")).over(whole).alias("first_date"))
            .filter(col("order_no") == 10)
            .order_by(dsl.SortOrder(col("running_spend"), ascending=False),
                      "o_custkey")
            .limit(100))


def order_neighbors(t, dsl=_L):
    """Each order against the customer's two orders before and after it
    by key (ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING): the mean, least
    and greatest price, the previous order's date and the priority two
    orders on ("none" past the last): the orders whose key is 1 modulo
    1024, by key."""
    F, col = dsl.functions, dsl.col
    w = dsl.Window.partition_by(col("o_custkey")) \
        .order_by(col("o_orderkey")).rows_between(-2, 2)
    return (t["orders"].select(
                col("o_orderkey"), col("o_custkey"),
                F.avg(col("o_totalprice")).over(w).alias("avg_price"),
                F.min(col("o_totalprice")).over(w).alias("min_price"),
                F.max(col("o_totalprice")).over(w).alias("max_price"),
                F.lag(col("o_orderdate"), 1).over(w).alias("prev_date"),
                F.lead(col("o_orderpriority"), 2, "none").over(w)
                .alias("lead_priority"))
            .filter(col("o_orderkey") % 1024 == 1).order_by("o_orderkey"))


def top_lines(t, dsl=_L):
    """The top-N-per-group idiom (TPC-DS q44's and q67's): every line's
    row number and rank within its order by price descending, the lines
    numbered 1-3, then per number their count, summed price and greatest
    rank, which no order of ties changes: 3 rows."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    w = dsl.Window.partition_by(col("l_orderkey")).order_by(
        dsl.SortOrder(col("l_extendedprice"), ascending=False))
    return (t["lineitem"].select(col("l_orderkey"), col("l_extendedprice"),
                                 F.row_number().over(w).alias("rn"),
                                 F.rank().over(w).alias("rk"))
            .filter(col("rn") <= 3)
            .group_by(col("rn"))
            .agg(F.count(lit(1)).alias("lines"),
                 F.sum(col("l_extendedprice")).alias("price"),
                 F.max(col("rk")).alias("max_rank"))
            .order_by("rn"))


def spend_rank(t, dsl=_L):
    """Each customer's spend and order count, its rank by spend over all
    customers (no PARTITION BY: TPC-DS q44's and q49's global rank) and
    the dense rank of its order count within its market segment: the
    customers ranked 100 or better, by rank and key."""
    F, col, lit = dsl.functions, dsl.col, dsl.lit
    spend = (t["orders"].group_by(col("o_custkey"))
             .agg(F.sum(col("o_totalprice")).alias("spend"),
                  F.count(lit(1)).alias("order_count"))
             .join(t["customer"], col("o_custkey") == col("c_custkey")))
    by_spend = dsl.Window.order_by(dsl.SortOrder(col("spend"),
                                                 ascending=False))
    by_count = dsl.Window.partition_by(col("c_mktsegment")) \
        .order_by(col("order_count"))
    return (spend.select(col("o_custkey"), col("c_mktsegment"),
                         col("spend"), col("order_count"),
                         F.rank().over(by_spend).alias("spend_rank"),
                         F.dense_rank().over(by_count).alias("count_rank"))
            .filter(col("spend_rank") <= 100)
            .order_by("spend_rank", "o_custkey"))


WINDOW_QUERIES = {"revenue_ratio": revenue_ratio,
                  "margin_rank": margin_rank,
                  "monthly_deviation": monthly_deviation,
                  "running_spend": running_spend,
                  "order_neighbors": order_neighbors,
                  "top_lines": top_lines, "spend_rank": spend_rank}
# the top-N window queries: how many rows each keeps, and the column it
# orders by first
WINDOW_TOP_N = {"monthly_deviation": (100, 5), "running_spend": (100, 3)}


# --------------------------------------------------------------------------
# outer joins: 1992's orders and the BUILDING customers on o_custkey ==
# c_custkey, counted as count(*), count(o_orderkey) and count(c_custkey)
# --------------------------------------------------------------------------

def _outer_1992(t, how: str):
    orders = t["orders"].filter(col("o_orderdate") < "1993-01-01")
    cust = t["customer"].filter(col("c_mktsegment") == "BUILDING")
    return (orders.join(cust, on=col("o_custkey") == col("c_custkey"),
                        how=how)
            .agg(F.count(lit(1)).alias("rows"),
                 F.count(col("o_orderkey")).alias("with_order"),
                 F.count(col("c_custkey")).alias("with_customer")))


def _oracle_outer_1992(t, how: str) -> List[tuple]:
    o, c = t["orders"], t["customer"]
    okey = o["o_custkey"][o["o_orderdate"] < days("1993-01-01")]
    ckey = c["c_custkey"][_text(c["c_mktsegment"]) == "BUILDING"]
    order_hit = _in_keys(ckey, okey)     # the orders with a customer
    cust_hit = _in_keys(okey, ckey)      # the customers with an order
    pairs = int(order_hit.sum())         # c_custkey is unique
    lone_orders = len(okey) - pairs if how == "full" else 0
    lone_cust = int((~cust_hit).sum())
    return [(pairs + lone_orders + lone_cust, pairs + lone_orders,
             pairs + lone_cust)]


# name -> (query over the dict of DataFrames, numpy oracle over the tables)
OUTER_JOINS = {
    # planned as a left join of the customers building the orders side
    "right_outer_1992": (lambda t: _outer_1992(t, "right"),
                         lambda t: _oracle_outer_1992(t, "right")),
    # builds the customers; its tail is the customers without an order
    "full_outer_1992": (lambda t: _outer_1992(t, "full"),
                        lambda t: _oracle_outer_1992(t, "full")),
}


# --------------------------------------------------------------------------
# string filters over o_comment: count(*) of the orders that pass each
# --------------------------------------------------------------------------

def _like_special_requests(a: np.ndarray) -> np.ndarray:
    """LIKE '%special%requests%': "requests" after the first "special"."""
    i = np.char.find(a, b"special")
    return (i >= 0) & (np.char.find(a, b"requests", np.maximum(i, 0) + 7)
                       >= 0)


_COMMENT = col("o_comment")
# name -> (predicate, numpy oracle over the `S` array of o_comment)
STRING_FILTERS = {
    # q13's order filter
    "q13_not_special_requests": (
        ~(_COMMENT.contains("special") & _COMMENT.contains("requests")),
        lambda a: ~((np.char.find(a, b"special") >= 0)
                    & (np.char.find(a, b"requests") >= 0))),
    "like_special_requests": (_COMMENT.like("%special%requests%"),
                              _like_special_requests),
    "startswith_furiously": (_COMMENT.startswith("furiously"),
                             lambda a: np.char.startswith(a, b"furiously")),
    "endswith_requests": (_COMMENT.endswith("requests"),
                          lambda a: np.char.endswith(a, b"requests")),
    "substr_special": (_COMMENT.substr(1, 7) == "special",
                       lambda a: a.astype("S7") == b"special"),
}


def string_filter(orders, name: str):
    """count(*) of the orders whose o_comment passes STRING_FILTERS[name]."""
    return orders.filter(STRING_FILTERS[name][0]) \
        .agg(F.count(lit(1)).alias("n"))


def oracle_string_filter(orders: Dict[str, np.ndarray],
                         name: str) -> List[tuple]:
    return [(int(STRING_FILTERS[name][1](orders["o_comment"]).sum()),)]


# --------------------------------------------------------------------------
# numpy oracles
# --------------------------------------------------------------------------

def _text(a: np.ndarray) -> np.ndarray:
    return np.char.decode(a, "utf-8") if a.dtype.kind == "S" else a


def oracle_q1(t: Dict[str, np.ndarray]) -> List[tuple]:
    """q1's groups.  The flags are one byte each, so a group is keyed by
    the two bytes as one int (no string work over the 60 M lines)."""
    m = t["l_shipdate"] <= days("1998-09-02")
    rf = t["l_returnflag"][m].view(np.uint8).astype(np.int64)
    ls = t["l_linestatus"][m].view(np.uint8)
    keys, inv = np.unique(rf * 256 + ls, return_inverse=True)
    qty, price = t["l_quantity"][m], t["l_extendedprice"][m]
    dsc, tax = t["l_discount"][m], t["l_tax"][m]
    disc = price * (1.0 - dsc)
    sums = [np.bincount(inv, weights=w, minlength=len(keys))
            for w in (qty, price, disc, disc * (1.0 + tax), dsc)]
    cnt = np.bincount(inv, minlength=len(keys))
    return [(chr(k // 256), chr(k % 256), q, p, d, c, q / n, p / n,
             x / n, int(n))
            for k, q, p, d, c, x, n in zip(keys, *sums, cnt)]


def oracle_q1_text(t: Dict[str, np.ndarray]) -> List[tuple]:
    """q1's rows with sum_qty an integer: the text quantity is cast to
    int, and its sum is a long."""
    return [(r[0], r[1], int(r[2])) + r[3:] for r in oracle_q1(t)]


def oracle_text_roundtrip(t: Dict[str, np.ndarray]) -> List[tuple]:
    n = len(t["l_orderkey"])
    return [(n, n, int(np.count_nonzero(t["l_quantity"] > 24)),
             int(np.count_nonzero(t["l_returnflag"] == b"N")))]


def oracle_q6(t: Dict[str, np.ndarray]) -> List[tuple]:
    d = t["l_discount"]
    m = ((t["l_shipdate"] >= days("1994-01-01"))
         & (t["l_shipdate"] < days("1995-01-01"))
         & (d >= 0.05) & (d <= 0.07) & (t["l_quantity"] < 24))
    return [(float(np.sum(t["l_extendedprice"][m] * d[m])),)]


def oracle_ship_delay(t: Dict[str, np.ndarray]) -> List[tuple]:
    """ship_delay's rows, by month index (bincount, no sort)."""
    ship = t["l_shipdate"].astype(np.int64)
    commit = t["l_commitdate"].astype(np.int64)
    receipt = t["l_receiptdate"].astype(np.int64)
    months = ship.astype("datetime64[D]").astype("datetime64[M]") \
        .astype(np.int64)
    first = int(months.min())
    g = months - first
    lines = np.bincount(g)

    def total(v):
        return np.bincount(g, weights=v, minlength=len(lines))
    transit, late = total(receipt - ship), total(receipt - commit)
    over = np.bincount(g, weights=receipt > commit + 14,
                       minlength=len(lines))
    # next_day is monotone in the day: the group's first Monday is that
    # of its earliest ship date
    earliest = np.full(len(lines), np.iinfo(np.int64).max)
    np.minimum.at(earliest, g, ship)
    step = (0 - (earliest + 3) % 7 + 7) % 7
    monday = earliest + np.where(step == 0, 7, step)
    month_day = (np.arange(len(lines)) + first).astype("datetime64[M]") \
        .astype("datetime64[D]").astype(np.int64)
    return [(_date(month_day[i]), int(lines[i]), int(transit[i]),
             int(late[i]), int(over[i]), _date(monday[i]))
            for i in np.flatnonzero(lines)]


def _half_up(x: np.ndarray, places: int) -> np.ndarray:
    """Spark's round(x, places) of positive doubles, as the port's Round
    computes it (HALF_UP in float64)."""
    p = 10.0 ** places
    return np.trunc(x * p + 0.5) / p


def oracle_price_dispersion(t: Dict[str, np.ndarray]) -> List[tuple]:
    """Every supplier's row in the query's order (match_math_query takes
    the first 100, ties trading places)."""
    supp, price = t["l_suppkey"], t["l_extendedprice"]
    n = np.bincount(supp)
    keys = np.flatnonzero(n)
    n = n[keys]
    total = np.bincount(supp, weights=price)[keys]
    squares = np.bincount(supp, weights=price * price)[keys]
    mean = total / n
    with np.errstate(invalid="ignore", divide="ignore"):
        var = np.where(n > 1, (squares - total * mean) / (n - 1), np.nan)
    stdev = np.sqrt(var)
    ratio = stdev / mean
    cov = _half_up(ratio, 4)
    order = np.lexsort((keys, -np.where(np.isnan(ratio), -np.inf, ratio)))
    return [(int(keys[i]), int(n[i]), float(mean[i]),
             None if np.isnan(stdev[i]) else float(stdev[i]),
             None if np.isnan(cov[i]) else float(cov[i])) for i in order]


def oracle_price_decades(t: Dict[str, np.ndarray]) -> List[tuple]:
    bins = np.floor(np.log10(t["l_extendedprice"]) * 10).astype(np.int64)
    first = int(bins.min())
    lines = np.bincount(bins - first)
    disc = np.bincount(bins - first, weights=t["l_discount"])
    return [(int(b + first),
             float(_half_up(np.array(10 ** ((b + first) / 10)), 2)),
             int(lines[b]), float(_half_up(disc[b] / lines[b] * 100, 2)))
            for b in np.flatnonzero(lines)]


_U32 = np.uint32


def _rotl32_np(x: np.ndarray, r: int) -> np.ndarray:
    """x rotated left by r bits, in place."""
    low = x >> _U32(32 - r)
    x <<= _U32(r)
    x |= low
    return x


def _mix_h_np(h: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Murmur3's body step: block k mixed into hash h (new arrays; in
    place on its own temporaries, which the SF10 oracle needs)."""
    k = _rotl32_np(k * _U32(0xcc9e2d51), 15)
    k *= _U32(0x1b873593)
    k ^= h
    k = _rotl32_np(k, 13)
    k *= _U32(5)
    k += _U32(0xe6546b64)
    return k


def murmur3_np(values: np.ndarray, seed) -> np.ndarray:
    """Spark's Murmur3Hash of one column of non-null values seeded by
    `seed` (an int or the uint32 hash so far), in numpy uint32, written
    from Spark's hashInt, hashLong and hashUnsafeBytes apart from the
    port's torch code: int32 and dates as one block, int64 as its low
    and high words, float64 by its bits (-0.0 as 0.0, every NaN as
    one), byte strings by 4-byte little-endian blocks and then each
    remaining byte alone, sign-extended.  Returns uint32."""
    n = len(values)
    h = np.full(n, seed, _U32) if np.isscalar(seed) else seed.astype(_U32)
    if values.dtype == np.float64:
        v = np.where(values == 0, 0.0, values)
        bits = v.view(np.int64)
        values = np.where(np.isnan(v), np.int64(0x7FF8000000000000), bits)
    if values.dtype.kind == "S":
        width = values.dtype.itemsize
        lens = np.char.str_len(values)  # numpy drops trailing NUL bytes
        blocks = lens // 4
        # a word past the last, so each row's tail word exists
        padded = np.zeros((n, width // 4 * 4 + 4), np.uint8)
        padded[:, :width] = np.frombuffer(values.tobytes(),
                                          np.uint8).reshape(n, width)
        words = padded.view("<u4")
        for j in range(width // 4):
            h = np.where(j < blocks, _mix_h_np(h, words[:, j]), h)
        tail = np.take_along_axis(words, blocks[:, None], 1)[:, 0]
        for t in range(3):
            byte = ((tail >> _U32(8 * t)) & _U32(0xFF)).astype(np.int32)
            k = ((byte ^ 0x80) - 0x80).view(_U32)  # sign-extended
            h = np.where(blocks * 4 + t < lens, _mix_h_np(h, k), h)
        length = lens.astype(_U32)
    elif values.dtype.itemsize == 8:
        u = values.view(np.uint64)
        h = _mix_h_np(h, (u & np.uint64(0xFFFFFFFF)).astype(_U32))
        h = _mix_h_np(h, (u >> np.uint64(32)).astype(_U32))
        length = _U32(8)
    else:
        h = _mix_h_np(h, values.astype(np.int32).view(_U32))
        length = _U32(4)
    h = h ^ length
    h = h ^ (h >> _U32(16))
    h = h * _U32(0x85ebca6b)
    h = h ^ (h >> _U32(13))
    h = h * _U32(0xc2b2ae35)
    return h ^ (h >> _U32(16))


def oracle_hash_partitions(t: Dict[str, np.ndarray]) -> List[tuple]:
    h = murmur3_np(t["l_orderkey"], 42).view(np.int32).astype(np.int64)
    part = h % HASH_PARTITIONS  # numpy's % is a floor modulo: Spark's pmod
    lines = np.bincount(part, minlength=HASH_PARTITIONS)
    qty = np.bincount(part, weights=t["l_quantity"],
                      minlength=HASH_PARTITIONS)
    return [(int(p), int(lines[p]), float(qty[p]))
            for p in np.flatnonzero(lines)]


def oracle_priority_migration(t) -> List[tuple]:
    o = t["orders"]
    # each customer's orders, in date and key order
    rows, starts, _ = _segments([o["o_custkey"], o["o_orderdate"],
                                 o["o_orderkey"]])
    first, last = rows[starts], rows[np.r_[starts[1:], len(rows)] - 1]
    code, prios = _codes(o["o_orderpriority"],
                         np.array(PRIORITIES, dtype="S"))
    pair = code[first] * len(prios) + code[last]
    keys, inv = np.unique(pair, return_inverse=True)
    earliest = np.full(len(keys), np.iinfo(np.int64).max)
    np.minimum.at(earliest, inv, o["o_orderdate"][first])
    total = np.bincount(inv, weights=o["o_totalprice"][last])
    names = _text(prios)
    return [(str(names[k // len(prios)]), str(names[k % len(prios)]),
             int(n), _date(earliest[i]), float(total[i]))
            for i, (k, n) in enumerate(zip(keys, np.bincount(inv)))]


def oracle_segment_bounds(t) -> List[tuple]:
    c = t["customer"]
    out = []
    for seg in np.unique(c["c_mktsegment"]):
        m = c["c_mktsegment"] == seg
        name, addr, comment = (np.sort(c[k][m]) for k in
                               ("c_name", "c_address", "c_comment"))
        out.append(tuple(str(_text(v)) for v in (
            seg, name[0], name[-1], addr[0], comment[-1]))
            + (len(np.unique(c["c_nationkey"][m])),))
    return out


def oracle_urgent_summary(t) -> List[tuple]:
    o = t["orders"]
    rows = np.flatnonzero(o["o_orderpriority"] == b"1-URGENT")
    if not len(rows):
        return [(0, None, None, None, None, 0)]
    comment = np.sort(o["o_comment"][rows])
    return [(len(np.unique(o["o_custkey"][rows])), str(_text(comment[0])),
             str(_text(comment[-1])), int(o["o_orderkey"][rows[0]]),
             int(o["o_orderkey"][rows[-1]]), len(rows))]


def _prefix8(a: np.ndarray) -> np.ndarray:
    """The first 8 bytes of each fixed-width byte string, as a big-endian
    uint64 (so their order is the strings' byte order)."""
    w = a.dtype.itemsize
    out = np.zeros((len(a), 8), dtype=np.uint8)
    out[:, :min(w, 8)] = np.ascontiguousarray(a).view(np.uint8).reshape(
        len(a), w)[:, :8]
    return out.view(">u8").ravel()


def _codes(a: np.ndarray, labels) -> tuple:
    """(code per row, the label of each code) of a byte-string column over
    a known sorted vocabulary `labels` (the generator's, a few words)
    whose first 8 bytes tell its words apart: one uint64 compare a row and
    word, not a sort of the column."""
    labels = np.asarray(labels)
    keys = _prefix8(labels)
    assert len(np.unique(keys)) == len(keys), labels
    rows = _prefix8(a)
    codes = np.zeros(len(a), dtype=np.int64)
    for k in keys[1:]:
        codes += rows >= k
    return codes, labels


def _grouping_set_rows(keys: List[tuple], sets: List[tuple], weights,
                       finish) -> List[tuple]:
    """Rows of a GROUP BY GROUPING SETS whose aggregates come from sums:
    `keys` are (codes, labels) per key column, `sets` the kept key
    indices of each set, `weights` the per-row columns summed per group,
    `finish(sums, counts)` a set's output columns from its groups' sums
    (one array per weight) and row counts.  The rows are summed once per
    finest group (every key kept), then each set adds those up.  A
    rolled-up key is None; rows sorted by the keys, nulls first."""
    sizes = [len(labels) for _, labels in keys]
    combo = np.zeros(len(keys[0][0]), dtype=np.int64)
    for codes, labels in keys:
        combo = combo * len(labels) + codes
    counts = np.bincount(combo)
    leaf = np.flatnonzero(counts)
    leaf_sums = [np.bincount(combo, weights=w, minlength=len(counts))[leaf]
                 for w in weights]
    digits, rem = [], leaf
    for size in reversed(sizes):
        digits.append(rem % size)
        rem = rem // size
    digits.reverse()
    out = []
    for kept in sets:
        sub = np.zeros(len(leaf), dtype=np.int64)
        for i in kept:
            sub = sub * sizes[i] + digits[i]
        groups, inv = np.unique(sub, return_inverse=True)
        first = np.zeros(len(groups), dtype=np.int64)
        first[inv[::-1]] = np.arange(len(leaf))[::-1]
        cols = finish([np.bincount(inv, weights=w) for w in leaf_sums],
                      np.bincount(inv, weights=counts[leaf]).astype(
                          np.int64))
        for g in range(len(groups)):
            key = tuple(_label(keys[i][1][digits[i][first[g]]])
                        if i in kept else None for i in range(len(keys)))
            out.append(key + tuple(c[g] for c in cols))
    out.sort(key=lambda r: tuple((v is not None, v)
                                 for v in r[:len(keys)]))
    return out


def _label(v):
    if isinstance(v, bytes):
        return v.decode()
    return v.item() if isinstance(v, np.generic) else v


def _rollup_sets(n: int) -> List[tuple]:
    return [tuple(range(g)) for g in range(n, -1, -1)]


def oracle_q1_rollup(t) -> List[tuple]:
    li = t["lineitem"]
    m = li["l_shipdate"] <= days("1998-09-02")
    keys = [_codes(li["l_returnflag"][m], [b"A", b"N", b"R"]),
            _codes(li["l_linestatus"][m], [b"F", b"O"])]
    price, dsc = li["l_extendedprice"][m], li["l_discount"][m]
    disc = price * (1.0 - dsc)

    def finish(sums, n):
        q, p, d, c, x = sums
        return [q.tolist(), p.tolist(), d.tolist(), c.tolist(),
                (q / n).tolist(), (p / n).tolist(), (x / n).tolist(),
                n.tolist()]
    return _grouping_set_rows(
        keys, _rollup_sets(2), [li["l_quantity"][m], price, disc,
                                disc * (1.0 + li["l_tax"][m]), dsc], finish)


def oracle_cube_orders(t) -> List[tuple]:
    o = t["orders"]
    keys = [_codes(o["o_orderpriority"], np.array(PRIORITIES, dtype="S")),
            _codes(o["o_orderstatus"], [b"F", b"O", b"P"])]

    def finish(sums, n):
        return [n.tolist(), sums[0].tolist(), (sums[0] / n).tolist()]
    return _grouping_set_rows(keys, [(0, 1), (0,), (1,), ()],
                              [o["o_totalprice"]], finish)


def oracle_rollup_nation_year(t) -> List[tuple]:
    o, c, n, r = t["orders"], t["customer"], t["nation"], t["region"]
    nation = c["c_nationkey"][_row_of(c["c_custkey"], o["o_custkey"])]
    by_key = np.argsort(n["n_nationkey"])
    region_names = np.array(REGIONS, dtype="S")
    region_of = _codes(r["r_name"][_row_of(
        r["r_regionkey"], n["n_regionkey"][by_key])], region_names)[0]
    years = _year(o["o_orderdate"])
    first = int(years.min())
    keys = [(region_of[nation], region_names),
            (nation, n["n_name"][by_key]),
            (years - first, np.arange(first, int(years.max()) + 1))]

    def finish(sums, m):
        return [sums[0].tolist(), m.tolist()]
    return _grouping_set_rows(keys, _rollup_sets(3), [o["o_totalprice"]],
                              finish)


def _lines_1995(li) -> np.ndarray:
    return (li["l_shipdate"] >= days("1995-01-01")) \
        & (li["l_shipdate"] < days("1996-01-01"))


def oracle_union_supply(t) -> List[tuple]:
    """Every supplier's (supp, net, entries) in union_supply's order; it
    keeps the first 100 (compare with match_set_query)."""
    li, ps = t["lineitem"], t["partsupp"]
    m = _lines_1995(li)
    supp = np.concatenate([li["l_suppkey"][m], ps["ps_suppkey"]])
    amount = np.concatenate([
        li["l_extendedprice"][m] * (1.0 - li["l_discount"][m]),
        -(ps["ps_supplycost"] * ps["ps_availqty"])])
    keys, inv = np.unique(supp, return_inverse=True)
    net = np.bincount(inv, weights=amount)
    entries = np.bincount(inv)
    order = np.lexsort((keys, -net))
    return [(int(keys[i]), float(net[i]), int(entries[i])) for i in order]


def oracle_supplier_reach(t) -> List[tuple]:
    li, ps = t["lineitem"], t["partsupp"]
    air = li["l_suppkey"][_lines_1995(li) & (li["l_shipmode"] == b"AIR")]
    low = ps["ps_suppkey"][ps["ps_availqty"] < 100]
    return [(len(np.unique(np.concatenate([air, low]))),)]


def oracle_customer_priorities(t) -> List[tuple]:
    o = t["orders"]
    prio, labels = _codes(o["o_orderpriority"],
                          np.array(PRIORITIES, dtype="S"))
    # a (customer, priority) pair is a bit of a dense bitmap
    seen = np.zeros((int(o["o_custkey"].max()) + 1) * len(labels), bool)
    seen[o["o_custkey"] * len(labels) + prio] = True
    count = seen.reshape(-1, len(labels)).sum(axis=0)
    return [(_label(labels[i]), int(count[i]))
            for i in np.flatnonzero(count)]


def match_set_query(name: str, want: List[tuple],
                    got: List[tuple]) -> bool:
    """`got` against the oracle's rows: union_supply's first 100 under
    top_rows_match (net amounts within 1e-9 may trade places), the rest
    under rows_match."""
    if name in SET_TOP_N:
        return top_rows_match(want, got, *SET_TOP_N[name])
    return rows_match(want, got)


def _by_key(keys: np.ndarray, probe: np.ndarray) -> np.ndarray:
    """_row_of for a table whose keys are 1..n in order (the generator's
    every key column): the probe less one, checked."""
    if len(keys) and keys[0] == 1 and keys[-1] == len(keys) \
            and np.all(np.diff(keys) == 1):
        return probe - 1
    return _row_of(keys, probe)


def _segments(order_keys: List[np.ndarray]):
    """(order, starts, segment of each sorted row) of rows sorted by the
    non-negative integer keys, most significant first, a segment per run
    of the first key.  The keys are packed into one int64 where their
    bits fit (one argsort, not a lexsort per key)."""
    bits = [max(1, int(k.max()).bit_length()) for k in order_keys]
    if sum(bits) <= 63:
        packed = np.zeros(len(order_keys[0]), dtype=np.int64)
        for k, b in zip(order_keys, bits):
            packed = (packed << b) | k.astype(np.int64)
        order = np.argsort(packed, kind="stable")
    else:
        order = np.lexsort(order_keys[::-1])
    first = order_keys[0][order]
    starts = np.flatnonzero(np.r_[True, first[1:] != first[:-1]])
    seg = np.repeat(np.arange(len(starts)), np.diff(np.r_[starts,
                                                          len(first)]))
    return order, starts, seg


def oracle_revenue_ratio(t) -> List[tuple]:
    li, p = t["lineitem"], t["part"]
    m = (li["l_shipdate"] >= days("1995-03-01")) \
        & (li["l_shipdate"] < days("1995-03-31"))
    parts, inv = np.unique(_by_key(p["p_partkey"], li["l_partkey"][m]),
                           return_inverse=True)
    revenue = np.bincount(inv, weights=li["l_extendedprice"][m])
    brand, typ = p["p_brand"][parts], p["p_type"][parts]
    _, b_inv = np.unique(brand, return_inverse=True)
    ratio = revenue * 100.0 / np.bincount(b_inv, weights=revenue)[b_inv]
    key = p["p_partkey"][parts]
    order = np.lexsort((key, typ, brand))[:100]
    return [(int(key[i]), _label(brand[i]), _label(typ[i]),
             float(revenue[i]), float(ratio[i])) for i in order]


def oracle_margin_rank(t) -> List[tuple]:
    li, p = t["lineitem"], t["part"]
    m = _lines_1995(li)
    row = _by_key(p["p_partkey"], li["l_partkey"][m])
    mfgrs, p_mfgr = np.unique(p["p_mfgr"], return_inverse=True)
    brands, p_brand = np.unique(p["p_brand"], return_inverse=True)
    nb = len(brands)
    code = p_mfgr[row] * nb + p_brand[row]
    price = li["l_extendedprice"][m]
    rev = price * (1.0 - li["l_discount"][m])
    size = len(mfgrs) * nb
    leaf_rev = np.bincount(code, weights=rev, minlength=size)
    leaf_gross = np.bincount(code, weights=price, minlength=size)
    leaf = np.flatnonzero(np.bincount(code, minlength=size))
    out = [[_label(mfgrs[c // nb]), _label(brands[c % nb]),
            float(leaf_rev[c]), float(leaf_gross[c])] for c in leaf]
    by_mfgr = np.unique(leaf // nb)
    out += [[_label(mfgrs[i]), None,
             float(leaf_rev[i * nb:(i + 1) * nb].sum()),
             float(leaf_gross[i * nb:(i + 1) * nb].sum())] for i in by_mfgr]
    out.append([None, None, float(rev.sum()), float(price.sum())])
    for r in out:
        r.append(r[2] / r[3])
    for r in out:
        r.append(1 + sum(o[4] < r[4] for o in out if o[0] == r[0]))
    out.sort(key=lambda r: ((r[0] is not None, r[0] or ""), r[5],
                            (r[1] is not None, r[1] or "")))
    return [tuple(r) for r in out]


def oracle_monthly_deviation(t) -> List[tuple]:
    """Every row of monthly_deviation's filter in its order; the query
    keeps the first 100 (compare with match_window_query)."""
    li, p = t["lineitem"], t["part"]
    brands, p_brand = np.unique(p["p_brand"], return_inverse=True)
    brand = p_brand[_by_key(p["p_partkey"], li["l_partkey"])]
    modes = np.array(sorted(SHIPMODES), dtype="S")
    mode = _codes(li["l_shipmode"], modes)[0]
    month = li["l_shipdate"].astype("datetime64[D]") \
        .astype("datetime64[M]").astype(np.int64)
    m0 = int(month.min())
    n_months = int(month.max()) - m0 + 1
    code = (brand * len(modes) + mode) * n_months + (month - m0)
    sums = np.bincount(code, weights=li["l_extendedprice"])
    groups = np.flatnonzero(np.bincount(code))
    sales = sums[groups]
    series, mon = groups // n_months, groups % n_months + m0
    year = mon // 12 + 1970
    # the groups ascend by (brand, mode, month): a year's months and a
    # series' neighbours are adjacent
    year_key = series * 10_000 + year
    _, y_inv = np.unique(year_key, return_inverse=True)
    avg = (np.bincount(y_inv, weights=sales)
           / np.bincount(y_inv))[y_inv]
    same_prev = np.r_[False, series[1:] == series[:-1]]
    same_next = np.r_[series[1:] == series[:-1], False]
    keep = np.flatnonzero((avg > 0) & (np.abs(sales - avg) / avg > 0.1)
                          & (year == 1997))
    b, md = series // len(modes), series % len(modes)
    order = keep[np.lexsort((mon[keep], md[keep], b[keep], sales[keep],
                             -avg[keep]))]
    return [(_label(brands[b[i]]), _label(modes[md[i]]), int(year[i]),
             int(mon[i] % 12 + 1), float(sales[i]), float(avg[i]),
             float(sales[i - 1]) if same_prev[i] else None,
             float(sales[i + 1]) if same_next[i] else None)
            for i in order]


def oracle_running_spend(t) -> List[tuple]:
    """Customers' 10th orders in running_spend's order: the first 100
    and those tying the 100th within 1e-8 (compare with
    match_window_query)."""
    o = t["orders"]
    order, starts, seg = _segments([o["o_custkey"], o["o_orderdate"],
                                    o["o_orderkey"]])
    pos = np.arange(len(order)) - starts[seg]
    tenth = np.flatnonzero(pos == 9)
    price = o["o_totalprice"][order]
    spend = np.zeros(len(tenth))
    for k in range(10):
        spend += price[tenth - 9 + k]
    labels = np.array(PRIORITIES, dtype="S")
    prio = _codes(o["o_orderpriority"], labels)[0][order]
    top = np.max(np.stack([prio[tenth - k] for k in range(10)]), axis=0)
    first = starts[seg[tenth]]
    cust = o["o_custkey"][order]
    keep = np.lexsort((cust[tenth], -spend))
    # the first 100 and every row within 1e-8 of the 100th: all that
    # match_window_query can pair with the query's rows
    if len(keep) > 100:
        cut = spend[keep[99]] * (1 - 1e-8)
        keep = keep[:100 + int(np.sum(spend[keep[100:]] >= cut))]
    key, date = o["o_orderkey"][order], o["o_orderdate"][order]
    return [(int(cust[tenth[i]]), int(key[tenth[i]]),
             _date(date[tenth[i]]), float(spend[i]), 10,
             _label(labels[prio[first[i]]]), _label(labels[top[i]]),
             _date(date[first[i]])) for i in keep]


def oracle_order_neighbors(t) -> List[tuple]:
    o = t["orders"]
    order, starts, seg = _segments([o["o_custkey"], o["o_orderkey"]])
    key = o["o_orderkey"][order]
    rows = np.flatnonzero(key % 1024 == 1)
    rows = rows[np.argsort(key[rows])]
    lo = starts[seg[rows]]
    hi = np.r_[starts[1:], len(order)][seg[rows]] - 1
    price = o["o_totalprice"][order]
    # the frame's five rows, each where it lies in the customer's orders
    at = rows[:, None] + np.arange(-2, 3)[None, :]
    inside = (at >= lo[:, None]) & (at <= hi[:, None])
    vals = price[np.clip(at, 0, len(order) - 1)]
    mean = np.where(inside, vals, 0.0).sum(axis=1) / inside.sum(axis=1)
    least = np.where(inside, vals, np.inf).min(axis=1)
    most = np.where(inside, vals, -np.inf).max(axis=1)
    cust = o["o_custkey"][order][rows]
    date = o["o_orderdate"][order][np.maximum(rows - 1, 0)]
    prio = o["o_orderpriority"][order][np.minimum(rows + 2, len(order) - 1)]
    return [(int(key[j]), int(cust[i]), float(mean[i]), float(least[i]),
             float(most[i]), _date(date[i]) if j - 1 >= lo[i] else None,
             _label(prio[i]) if j + 2 <= hi[i] else "none")
            for i, j in enumerate(rows)]


def oracle_top_lines(t) -> List[tuple]:
    """Each order's prices sorted descending in a row of a 7-wide matrix
    (an order has 1-7 lines): the n-th column is row number n's price,
    and its rank is one more than the prices above it."""
    li = t["lineitem"]
    okey = li["l_orderkey"]
    order = np.arange(len(okey)) if np.all(okey[1:] >= okey[:-1]) \
        else np.argsort(okey, kind="stable")
    okey = okey[order]
    starts = np.flatnonzero(np.r_[True, okey[1:] != okey[:-1]])
    seg = np.repeat(np.arange(len(starts)),
                    np.diff(np.r_[starts, len(okey)]))
    width = int(np.diff(np.r_[starts, len(okey)]).max())
    mat = np.full((len(starts), width), -np.inf)
    mat[seg, np.arange(len(okey)) - starts[seg]] = \
        li["l_extendedprice"][order]
    mat = -np.sort(-mat, axis=1)
    out = []
    for rn in range(1, min(3, width) + 1):
        col = mat[:, rn - 1]
        has = col > -np.inf
        # only the prices before it in its row can be greater
        rank = np.ones(len(col), dtype=np.int64)
        for j in range(rn - 1):
            rank += mat[:, j] > col
        out.append((rn, int(has.sum()), float(col[has].sum()),
                    int(np.max(rank[has]))))
    return out


def oracle_spend_rank(t) -> List[tuple]:
    o, c = t["orders"], t["customer"]
    custs, inv = np.unique(o["o_custkey"], return_inverse=True)
    spend = np.bincount(inv, weights=o["o_totalprice"])
    count = np.bincount(inv)
    ranked = np.sort(spend)
    rank = 1 + len(spend) - np.searchsorted(ranked, spend, side="right")
    seg = c["c_mktsegment"][_by_key(c["c_custkey"], custs)]
    dense = np.zeros(len(custs), dtype=np.int64)
    for s in np.unique(seg):
        m = seg == s
        levels = np.unique(count[m])
        dense[m] = np.searchsorted(levels, count[m]) + 1
    keep = np.flatnonzero(rank <= 100)
    keep = keep[np.lexsort((custs[keep], rank[keep]))]
    return [(int(custs[i]), _label(seg[i]), float(spend[i]), int(count[i]),
             int(rank[i]), int(dense[i])) for i in keep]


def match_window_query(name: str, want: List[tuple],
                       got: List[tuple]) -> bool:
    """`got` against the oracle's rows: monthly_deviation's and
    running_spend's first 100 under top_rows_match (float sums within
    1e-9 may trade places), the rest under rows_match."""
    if name in WINDOW_TOP_N:
        return top_rows_match(want, got, *WINDOW_TOP_N[name])
    return rows_match(want, got)


def match_agg_query(name: str, want: List[tuple],
                    got: List[tuple]) -> bool:
    """`got` against the oracle's rows (q16_distinct's and q21_distinct's
    are q16's and q21's) under rows_match: the float sum of
    priority_migration within its relative 1e-9, the rest exact."""
    return rows_match(want, got)


def oracle_hash_sample(t: Dict[str, np.ndarray]) -> List[tuple]:
    """hash_sample's groups, hashed 2^20 lines at a time (each hash's
    temporaries then stay small; the quantities are whole numbers, so
    the summed chunks are exact)."""
    lines, qty = np.zeros(8, np.int64), np.zeros(8)
    for lo in range(0, len(t["l_orderkey"]), 1 << 20):
        part = slice(lo, lo + (1 << 20))
        h = 42
        for c in SAMPLE_COLUMNS:
            h = murmur3_np(t[c][part], h)
        keep = (h & _U32(63)) == 0
        group = (h[keep] >> _U32(29)).astype(np.int64)
        lines += np.bincount(group, minlength=8)
        qty += np.bincount(group, weights=t["l_quantity"][part][keep],
                           minlength=8)
    return [(int(g), int(lines[g]), float(qty[g]))
            for g in np.flatnonzero(lines)]


def match_math_query(name: str, want: List[tuple],
                     got: List[tuple]) -> bool:
    """`got` against the oracle's rows: price_dispersion's first 100 by
    the ratio stdev / mean (rows that tie within rel 1e-9 may trade
    places) with `cov` within 1e-4 of the oracle's (a sum taken in
    another order can move a half-way value), price_decades' rounded
    mean discount within 0.01 likewise, the rest as rows_match."""
    if name == "price_dispersion":
        def ratio(rows):
            return [r[:4] + (-math.inf if r[3] is None else r[3] / r[2],)
                    for r in rows]
        cov = {r[0]: r[4] for r in want}
        return (top_rows_match(ratio(want), ratio(got), 100, 4)
                and all((r[4] is None) == (cov[r[0]] is None)
                        and (r[4] is None or abs(r[4] - cov[r[0]]) <= 1e-4)
                        for r in got))
    if name == "price_decades":
        return (rows_match([r[:3] for r in want], [r[:3] for r in got])
                and all(abs(w[3] - g[3]) <= 0.01 + 1e-9
                        for w, g in zip(want, got)))
    return rows_match(want, got)


def oracle_q18_inner(t: Dict[str, np.ndarray],
                     min_qty: float = 300) -> List[tuple]:
    sums = np.bincount(t["l_orderkey"], weights=t["l_quantity"])
    keys = np.flatnonzero(sums > min_qty)
    return [(int(k), float(sums[k])) for k in keys]


def _date(d) -> datetime.date:
    return _EPOCH + datetime.timedelta(days=int(d))


def _in_keys(keys: np.ndarray, probe: np.ndarray) -> np.ndarray:
    """Per probe value, whether it is among `keys` (a join by
    np.searchsorted)."""
    u = np.unique(keys)
    pos = np.clip(np.searchsorted(u, probe), 0, max(len(u) - 1, 0))
    return (u[pos] == probe) if len(u) else np.zeros(len(probe), bool)


def _row_of(keys: np.ndarray, probe: np.ndarray) -> np.ndarray:
    """Per probe value, the index of the one row of unique `keys` that
    holds it (the caller has checked it is there)."""
    order = np.argsort(keys, kind="stable")
    return order[np.searchsorted(keys[order], probe)]


def oracle_q3(t) -> List[tuple]:
    """Every (orderkey, orderdate, shippriority, revenue) group in q3's
    order; q3 keeps the first 10 (compare with top_rows_match)."""
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    cust = c["c_custkey"][_text(c["c_mktsegment"]) == "BUILDING"]
    om = (o["o_orderdate"] < days("1995-03-15")) & _in_keys(cust,
                                                            o["o_custkey"])
    lm = (li["l_shipdate"] > days("1995-03-15")) \
        & _in_keys(o["o_orderkey"][om], li["l_orderkey"])
    keys, inv = np.unique(li["l_orderkey"][lm], return_inverse=True)
    rev = np.bincount(inv, weights=li["l_extendedprice"][lm]
                      * (1.0 - li["l_discount"][lm]), minlength=len(keys))
    orow = _row_of(o["o_orderkey"], keys)
    odate, ship = o["o_orderdate"][orow], o["o_shippriority"][orow]
    order = np.lexsort((odate, -rev))
    return [(int(keys[i]), _date(odate[i]), int(ship[i]), float(rev[i]))
            for i in order]


def oracle_q4(t) -> List[tuple]:
    o, li = t["orders"], t["lineitem"]
    om = ((o["o_orderdate"] >= days("1993-07-01"))
          & (o["o_orderdate"] < days("1993-10-01")))
    late = li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]
    om &= _in_keys(late, o["o_orderkey"])
    prio, cnt = np.unique(_text(o["o_orderpriority"][om]),
                          return_counts=True)
    return [(str(p), int(n)) for p, n in zip(prio, cnt)]


def oracle_q18(t, min_qty: float = 300) -> List[tuple]:
    """Every row of q18's join in q18's order; q18 keeps the first 100
    (compare with top_rows_match)."""
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    keys, inv = np.unique(li["l_orderkey"], return_inverse=True)
    sums = np.bincount(inv, weights=li["l_quantity"])
    big, sums = keys[sums > min_qty], sums[sums > min_qty]
    om = _in_keys(big, o["o_orderkey"]) & _in_keys(c["c_custkey"],
                                                   o["o_custkey"])
    okey = o["o_orderkey"][om]
    ocust, odate = o["o_custkey"][om], o["o_orderdate"][om]
    price = o["o_totalprice"][om]
    qty = sums[np.searchsorted(big, okey)]
    name = _text(c["c_name"])[_row_of(c["c_custkey"], ocust)]
    order = np.lexsort((odate, -price))
    return [(str(name[i]), int(ocust[i]), int(okey[i]), _date(odate[i]),
             float(price[i]), float(qty[i])) for i in order]


def oracle_q12(t) -> List[tuple]:
    o, li = t["orders"], t["lineitem"]
    ship, commit = li["l_shipdate"], li["l_commitdate"]
    receipt = li["l_receiptdate"]
    m = np.flatnonzero((commit < receipt) & (ship < commit)
                       & (receipt >= days("1994-01-01"))
                       & (receipt < days("1995-01-01")))
    mode = _text(li["l_shipmode"][m])
    keep = np.isin(mode, ["MAIL", "SHIP"]) \
        & _in_keys(o["o_orderkey"], li["l_orderkey"][m])
    mode, key = mode[keep], li["l_orderkey"][m][keep]
    prio = _text(o["o_orderpriority"])[_row_of(o["o_orderkey"], key)]
    high = np.isin(prio, ["1-URGENT", "2-HIGH"])
    modes, inv = np.unique(mode, return_inverse=True)
    n_high = np.bincount(inv, weights=high, minlength=len(modes))
    n_all = np.bincount(inv, minlength=len(modes))
    return [(str(k), int(h), int(n - h))
            for k, h, n in zip(modes, n_high, n_all)]


def oracle_q13(t) -> List[tuple]:
    c, o = t["customer"], t["orders"]
    keep = STRING_FILTERS["q13_not_special_requests"][1](o["o_comment"])
    okey = o["o_custkey"][keep]
    okey = okey[_in_keys(c["c_custkey"], okey)]
    per_cust = np.bincount(_row_of(c["c_custkey"], okey),
                           minlength=len(c["c_custkey"]))
    c_count, custdist = np.unique(per_cust, return_counts=True)
    order = np.lexsort((-c_count, -custdist))
    return [(int(c_count[i]), int(custdist[i])) for i in order]


def oracle_q22(t) -> List[tuple]:
    c, o = t["customer"], t["orders"]
    code = c["c_phone"].astype("S2")
    bal = c["c_acctbal"]
    keep = np.isin(code, np.array(Q22_CODES, dtype="S2"))
    pos = keep & (bal > 0.0)
    avg = float(bal[pos].mean()) if pos.any() else 0.0
    rich = keep & (bal > avg) \
        & ~_in_keys(o["o_custkey"], c["c_custkey"])
    codes, inv = np.unique(code[rich], return_inverse=True)
    total = np.bincount(inv, weights=bal[rich], minlength=len(codes))
    count = np.bincount(inv, minlength=len(codes))
    return [(k.decode(), int(n), float(v))
            for k, n, v in zip(codes, count, total)]


def oracle_q14(t) -> List[tuple]:
    li, p = t["lineitem"], t["part"]
    sd = li["l_shipdate"]
    m = np.flatnonzero((sd >= days("1995-09-01")) & (sd < days("1995-10-01")))
    m = m[_in_keys(p["p_partkey"], li["l_partkey"][m])]
    if not len(m):
        return [(None,)]
    disc = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])
    ptype = p["p_type"][_row_of(p["p_partkey"], li["l_partkey"][m])]
    promo = np.where(np.char.startswith(ptype, b"PROMO"), disc, 0.0)
    return [(float(promo.sum() * 100.0 / disc.sum()),)]


def oracle_q17(t) -> List[tuple]:
    """q17's one value.  Every quantity is a whole number, so each part's
    quantity sum is exact in any order, and its average (sum / count, as
    the aggregate finalizes it) and limit are the same doubles on every
    path: the comparison keeps the same lines."""
    li, p = t["lineitem"], t["part"]
    keys = p["p_partkey"][(p["p_brand"] == b"Brand#23")
                          & (p["p_container"] == b"MED BOX")]
    m = np.flatnonzero(_in_keys(keys, li["l_partkey"]))
    if not len(m):
        return [(None,)]
    qty = li["l_quantity"][m]
    parts, inv = np.unique(li["l_partkey"][m], return_inverse=True)
    avg = np.bincount(inv, weights=qty) / np.bincount(inv)
    keep = qty < (avg * 0.2)[inv]
    if not keep.any():
        return [(None,)]
    return [(float(li["l_extendedprice"][m][keep].sum() / 7.0),)]


def _revenue(li: Dict[str, np.ndarray], m) -> np.ndarray:
    return li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])


def oracle_q5(t) -> List[tuple]:
    r, n, s = t["region"], t["nation"], t["supplier"]
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    asia = r["r_regionkey"][r["r_name"] == b"ASIA"]
    nations = n["n_nationkey"][_in_keys(asia, n["n_regionkey"])]
    supp = s["s_suppkey"][_in_keys(nations, s["s_nationkey"])]
    od = o["o_orderdate"]
    okey = o["o_orderkey"][(od >= days("1994-01-01"))
                           & (od < days("1995-01-01"))]
    m = np.flatnonzero(_in_keys(supp, li["l_suppkey"])
                       & _in_keys(okey, li["l_orderkey"]))
    s_nat = s["s_nationkey"][_row_of(s["s_suppkey"], li["l_suppkey"][m])]
    cust = o["o_custkey"][_row_of(o["o_orderkey"], li["l_orderkey"][m])]
    has_cust = _in_keys(c["c_custkey"], cust)
    m, s_nat, cust = m[has_cust], s_nat[has_cust], cust[has_cust]
    keep = c["c_nationkey"][_row_of(c["c_custkey"], cust)] == s_nat
    nat, inv = np.unique(s_nat[keep], return_inverse=True)
    rev = np.bincount(inv, weights=_revenue(li, m[keep]),
                      minlength=len(nat))
    name = _text(n["n_name"])[_row_of(n["n_nationkey"], nat)]
    return [(str(name[i]), float(rev[i])) for i in np.argsort(-rev,
                                                               kind="stable")]


def oracle_q10(t) -> List[tuple]:
    """Every customer group of q10 in q10's order; q10 keeps the first 20
    (compare with top_rows_match)."""
    n, c, o, li = t["nation"], t["customer"], t["orders"], t["lineitem"]
    od = o["o_orderdate"]
    om = (od >= days("1993-10-01")) & (od < days("1994-01-01")) \
        & _in_keys(c["c_custkey"], o["o_custkey"])
    m = np.flatnonzero((li["l_returnflag"] == b"R")
                       & _in_keys(o["o_orderkey"][om], li["l_orderkey"]))
    cust = o["o_custkey"][_row_of(o["o_orderkey"], li["l_orderkey"][m])]
    keys, inv = np.unique(cust, return_inverse=True)
    rev = np.bincount(inv, weights=_revenue(li, m), minlength=len(keys))
    row = _row_of(c["c_custkey"], keys)
    nat = c["c_nationkey"][row]
    has_nation = _in_keys(n["n_nationkey"], nat)
    keys, rev, row, nat = (a[has_nation] for a in (keys, rev, row, nat))
    nname = _text(n["n_name"])[_row_of(n["n_nationkey"], nat)]
    cols = [_text(c[k][row]) for k in ("c_name", "c_phone", "c_address",
                                       "c_comment")]
    bal = c["c_acctbal"][row]
    return [(int(keys[i]), str(cols[0][i]), float(bal[i]), str(cols[1][i]),
             str(nname[i]), str(cols[2][i]), str(cols[3][i]), float(rev[i]))
            for i in np.argsort(-rev, kind="stable")]


def oracle_q15(t) -> List[tuple]:
    """q15's rows.  The top revenue is the maximum of the oracle's own
    sums, as the query's is the maximum of its own."""
    s, li = t["supplier"], t["lineitem"]
    sd = li["l_shipdate"]
    m = np.flatnonzero((sd >= days("1996-01-01")) & (sd < days("1996-04-01")))
    keys, inv = np.unique(li["l_suppkey"][m], return_inverse=True)
    rev = np.bincount(inv, weights=_revenue(li, m), minlength=len(keys))
    top = float(rev.max()) if len(rev) else 0.0
    keep = (rev >= top - 1e-6) & _in_keys(s["s_suppkey"], keys)
    keys, rev = keys[keep], rev[keep]
    row = _row_of(s["s_suppkey"], keys)
    name, addr, phone = (_text(s[k][row])
                         for k in ("s_name", "s_address", "s_phone"))
    return [(int(keys[i]), str(name[i]), str(addr[i]), str(phone[i]),
             float(rev[i])) for i in np.argsort(keys)]


def oracle_q19(t) -> List[tuple]:
    li, p = t["lineitem"], t["part"]
    m = np.flatnonzero(np.isin(li["l_shipmode"], [b"AIR", b"REG AIR"])
                       & (li["l_shipinstruct"] == b"DELIVER IN PERSON"))
    m = m[_in_keys(p["p_partkey"], li["l_partkey"][m])]
    row = _row_of(p["p_partkey"], li["l_partkey"][m])
    qty = li["l_quantity"][m]
    keep = np.zeros(len(m), bool)
    for brand, containers, (lo, hi), size in Q19_BRANCHES:
        keep |= ((p["p_brand"][row] == brand.encode())
                 & np.isin(p["p_container"][row],
                           [x.encode() for x in containers])
                 & (qty >= lo) & (qty <= hi)
                 & (p["p_size"][row] >= 1) & (p["p_size"][row] <= size))
    if not keep.any():
        return [(None,)]
    return [(float(_revenue(li, m[keep]).sum()),)]


def oracle_q21(t) -> List[tuple]:
    n, s, o, li = t["nation"], t["supplier"], t["orders"], t["lineitem"]
    m = np.flatnonzero(_in_keys(o["o_orderkey"][o["o_orderstatus"] == b"F"],
                               li["l_orderkey"]))
    okey, skey = li["l_orderkey"][m], li["l_suppkey"][m]
    late = li["l_receiptdate"][m] > li["l_commitdate"][m]
    width = int(skey.max()) + 1 if len(skey) else 1

    def suppliers_per_order(rows):
        """(orders, their count of distinct suppliers) over `rows`."""
        pairs = np.unique(okey[rows] * width + skey[rows])
        return np.unique(pairs // width, return_counts=True)
    all_o, nsupp = suppliers_per_order(slice(None))
    late_o, nlate = suppliers_per_order(late)
    lo, ls = okey[late], skey[late]
    blamed = ls[(nsupp[np.searchsorted(all_o, lo)] > 1)
                & (nlate[np.searchsorted(late_o, lo)] == 1)]
    blamed = blamed[_in_keys(s["s_suppkey"], blamed)]
    row = _row_of(s["s_suppkey"], blamed)
    saudi = n["n_nationkey"][n["n_name"] == b"SAUDI ARABIA"]
    row = row[_in_keys(saudi, s["s_nationkey"][row])]
    row, count = np.unique(row, return_counts=True)
    names = _text(s["s_name"][row])
    order = np.lexsort((names, -count))[:100]
    return [(str(names[i]), int(count[i])) for i in order]


def _year(d: np.ndarray) -> np.ndarray:
    """The year of each day since 1970-01-01."""
    return d.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def _nation_of(t, keys: np.ndarray) -> np.ndarray:
    """The n_name text of each nation key."""
    n = t["nation"]
    return _text(n["n_name"])[_row_of(n["n_nationkey"], keys)]


def _keys_of(t, table: str, key: str, name_col: str, name: str
             ) -> np.ndarray:
    """The `key` values of the rows of `table` whose `name_col` is
    `name`."""
    r = t[table]
    return r[key][r[name_col] == name.encode()]


def oracle_q2(t) -> List[tuple]:
    """Every row of q2's join in q2's order; q2 keeps the first 100
    (compare with top_rows_match)."""
    p, s, ps = t["part"], t["supplier"], t["partsupp"]
    parts = p["p_partkey"][(p["p_size"] == 15)
                           & np.char.endswith(p["p_type"], b"BRASS")]
    europe = _keys_of(t, "region", "r_regionkey", "r_name", "EUROPE")
    n = t["nation"]
    nations = n["n_nationkey"][_in_keys(europe, n["n_regionkey"])]
    supp = s["s_suppkey"][_in_keys(nations, s["s_nationkey"])]
    m = np.flatnonzero(_in_keys(parts, ps["ps_partkey"])
                       & _in_keys(supp, ps["ps_suppkey"]))
    cost = ps["ps_supplycost"][m]
    keys, inv = np.unique(ps["ps_partkey"][m], return_inverse=True)
    low = np.full(len(keys), np.inf)
    np.minimum.at(low, inv, cost)
    m = m[cost == low[inv]]
    srow = _row_of(s["s_suppkey"], ps["ps_suppkey"][m])
    prow = _row_of(p["p_partkey"], ps["ps_partkey"][m])
    acct, pkey = s["s_acctbal"][srow], ps["ps_partkey"][m]
    nname = _nation_of(t, s["s_nationkey"][srow])
    sname, addr, phone, comment = (_text(s[k][srow]) for k in (
        "s_name", "s_address", "s_phone", "s_comment"))
    mfgr = _text(p["p_mfgr"][prow])
    return [(float(acct[i]), str(sname[i]), str(nname[i]), int(pkey[i]),
             str(mfgr[i]), str(addr[i]), str(phone[i]), str(comment[i]))
            for i in np.lexsort((pkey, sname, nname, -acct))]


def oracle_q7(t) -> List[tuple]:
    s, o, c, li = t["supplier"], t["orders"], t["customer"], t["lineitem"]
    sd = li["l_shipdate"]
    m = np.flatnonzero((sd >= days("1995-01-01")) & (sd <= days("1996-12-31")))
    m = m[_in_keys(s["s_suppkey"], li["l_suppkey"][m])
          & _in_keys(o["o_orderkey"], li["l_orderkey"][m])]
    cust = o["o_custkey"][_row_of(o["o_orderkey"], li["l_orderkey"][m])]
    has_cust = _in_keys(c["c_custkey"], cust)
    m, cust = m[has_cust], cust[has_cust]
    supp_nation = s["s_nationkey"][_row_of(s["s_suppkey"],
                                           li["l_suppkey"][m])]
    cust_nation = c["c_nationkey"][_row_of(c["c_custkey"], cust)]
    fr, de = (_keys_of(t, "nation", "n_nationkey", "n_name", x)
              for x in ("FRANCE", "GERMANY"))
    keep = ((np.isin(supp_nation, fr) & np.isin(cust_nation, de))
            | (np.isin(supp_nation, de) & np.isin(cust_nation, fr)))
    m, supp_nation, cust_nation = (a[keep] for a in (m, supp_nation,
                                                     cust_nation))
    year = _year(sd[m])
    groups, inv = np.unique(np.stack([supp_nation, cust_nation, year]),
                            axis=1, return_inverse=True)
    rev = np.bincount(inv.reshape(-1), weights=_revenue(li, m),
                      minlength=groups.shape[1])
    sn, cn = _nation_of(t, groups[0]), _nation_of(t, groups[1])
    return [(str(sn[i]), str(cn[i]), int(groups[2, i]), float(rev[i]))
            for i in np.lexsort((groups[2], cn, sn))]


def oracle_q8(t) -> List[tuple]:
    p, s, o, c, li = (t[k] for k in ("part", "supplier", "orders",
                                     "customer", "lineitem"))
    parts = p["p_partkey"][p["p_type"] == b"ECONOMY ANODIZED STEEL"]
    od = o["o_orderdate"]
    okey = o["o_orderkey"][(od >= days("1995-01-01"))
                           & (od <= days("1996-12-31"))]
    m = np.flatnonzero(_in_keys(parts, li["l_partkey"]))
    m = m[_in_keys(s["s_suppkey"], li["l_suppkey"][m])
          & _in_keys(okey, li["l_orderkey"][m])]
    orow = _row_of(o["o_orderkey"], li["l_orderkey"][m])
    m, orow = (a[_in_keys(c["c_custkey"], o["o_custkey"][orow])]
               for a in (m, orow))
    cust_nation = c["c_nationkey"][_row_of(c["c_custkey"],
                                           o["o_custkey"][orow])]
    n = t["nation"]
    america = _keys_of(t, "region", "r_regionkey", "r_name", "AMERICA")
    keep = _in_keys(n["n_nationkey"][_in_keys(america, n["n_regionkey"])],
                    cust_nation)
    m, orow = m[keep], orow[keep]
    supp_nation = _nation_of(t, s["s_nationkey"][_row_of(
        s["s_suppkey"], li["l_suppkey"][m])])
    vol = _revenue(li, m)
    years, inv = np.unique(_year(od[orow]), return_inverse=True)
    brazil = np.bincount(inv, weights=np.where(supp_nation == "BRAZIL", vol,
                                               0.0), minlength=len(years))
    total = np.bincount(inv, weights=vol, minlength=len(years))
    return [(int(y), float(b / v)) for y, b, v in zip(years, brazil, total)]


def oracle_q9(t) -> List[tuple]:
    p, s, ps, o, li = (t[k] for k in ("part", "supplier", "partsupp",
                                      "orders", "lineitem"))
    parts = p["p_partkey"][np.char.find(p["p_name"], b"green") >= 0]
    m = np.flatnonzero(_in_keys(parts, li["l_partkey"]))
    m = m[_in_keys(s["s_suppkey"], li["l_suppkey"][m])
          & _in_keys(o["o_orderkey"], li["l_orderkey"][m])]
    # the partsupp rows of each line's (part, supplier), as many as there
    # are: a part may list one supplier twice
    width = int(max(ps["ps_suppkey"].max(initial=0),
                    li["l_suppkey"].max(initial=0))) + 1
    order = np.argsort(ps["ps_partkey"] * width + ps["ps_suppkey"],
                       kind="stable")
    pairs = (ps["ps_partkey"] * width + ps["ps_suppkey"])[order]
    want = li["l_partkey"][m] * width + li["l_suppkey"][m]
    lo = np.searchsorted(pairs, want, "left")
    hits = np.searchsorted(pairs, want, "right") - lo
    m = np.repeat(m, hits)
    psrow = order[np.repeat(lo, hits) + (np.arange(hits.sum())
                                         - np.repeat(np.cumsum(hits) - hits,
                                                     hits))]
    nation = s["s_nationkey"][_row_of(s["s_suppkey"], li["l_suppkey"][m])]
    has_nation = _in_keys(t["nation"]["n_nationkey"], nation)
    m, psrow, nation = m[has_nation], psrow[has_nation], nation[has_nation]
    year = _year(o["o_orderdate"][_row_of(o["o_orderkey"],
                                          li["l_orderkey"][m])])
    amount = (_revenue(li, m)
              - ps["ps_supplycost"][psrow] * li["l_quantity"][m])
    groups, inv = np.unique(np.stack([nation, year]), axis=1,
                            return_inverse=True)
    total = np.bincount(inv.reshape(-1), weights=amount,
                        minlength=groups.shape[1])
    gname = _nation_of(t, groups[0])
    return [(str(gname[i]), int(groups[1, i]), float(total[i]))
            for i in np.lexsort((-groups[1], gname))]


def oracle_q11(t, fraction: float = Q11_FRACTION) -> List[tuple]:
    """q11's rows.  The threshold is `fraction` of the oracle's own
    total, as the query's is of its own."""
    s, ps = t["supplier"], t["partsupp"]
    germany = _keys_of(t, "nation", "n_nationkey", "n_name", "GERMANY")
    supp = s["s_suppkey"][_in_keys(germany, s["s_nationkey"])]
    m = np.flatnonzero(_in_keys(supp, ps["ps_suppkey"]))
    value = ps["ps_supplycost"][m] * ps["ps_availqty"][m]
    total = float(value.sum())
    keys, inv = np.unique(ps["ps_partkey"][m], return_inverse=True)
    sums = np.bincount(inv, weights=value, minlength=len(keys))
    keep = np.flatnonzero(sums > total * fraction)
    return [(int(keys[i]), float(sums[i]))
            for i in keep[np.argsort(-sums[keep], kind="stable")]]


def oracle_q16(t) -> List[tuple]:
    p, s, ps = t["part"], t["supplier"], t["partsupp"]
    pm = ((p["p_brand"] != b"Brand#45")
          & ~np.char.startswith(p["p_type"], b"MEDIUM POLISHED")
          & np.isin(p["p_size"], Q16_SIZES))
    sc = s["s_comment"]
    bad = s["s_suppkey"][(np.char.find(sc, b"Customer") >= 0)
                         & (np.char.find(sc, b"Complaints") >= 0)]
    m = np.flatnonzero(~_in_keys(bad, ps["ps_suppkey"])
                       & _in_keys(p["p_partkey"][pm], ps["ps_partkey"]))
    prow = _row_of(p["p_partkey"], ps["ps_partkey"][m])
    # (brand, type, size) as one code that sorts as the three keys do
    brands, bcode = np.unique(p["p_brand"], return_inverse=True)
    types, tcode = np.unique(p["p_type"], return_inverse=True)
    sizes = int(p["p_size"].max(initial=0)) + 1
    code = (bcode[prow] * len(types) + tcode[prow]) * sizes \
        + p["p_size"][prow]
    width = int(ps["ps_suppkey"].max(initial=0)) + 1
    pairs = np.unique(code * width + ps["ps_suppkey"][m])
    groups, count = np.unique(pairs // width, return_counts=True)
    size, bt = groups % sizes, groups // sizes
    b, ty = _text(brands[bt // len(types)]), _text(types[bt % len(types)])
    return [(str(b[i]), str(ty[i]), int(size[i]), int(count[i]))
            for i in np.lexsort((size, ty, b, -count))]


def oracle_q20(t, prefix: str = "forest",
               nation: str = "CANADA") -> List[tuple]:
    p, s, ps, li = t["part"], t["supplier"], t["partsupp"], t["lineitem"]
    parts = p["p_partkey"][np.char.startswith(p["p_name"], prefix.encode())]
    sd = li["l_shipdate"]
    m = np.flatnonzero((sd >= days("1994-01-01")) & (sd < days("1995-01-01")))
    width = int(max(ps["ps_suppkey"].max(initial=0),
                    li["l_suppkey"].max(initial=0))) + 1
    pairs, inv = np.unique(li["l_partkey"][m] * width + li["l_suppkey"][m],
                           return_inverse=True)
    half = np.bincount(inv, weights=li["l_quantity"][m],
                       minlength=len(pairs)) * 0.5
    psm = np.flatnonzero(_in_keys(parts, ps["ps_partkey"]))
    want = ps["ps_partkey"][psm] * width + ps["ps_suppkey"][psm]
    hit = _in_keys(pairs, want)
    psm, want = psm[hit], want[hit]
    psm = psm[ps["ps_availqty"][psm] > half[np.searchsorted(pairs, want)]]
    keys = _keys_of(t, "nation", "n_nationkey", "n_name", nation)
    keep = np.flatnonzero(_in_keys(ps["ps_suppkey"][psm], s["s_suppkey"])
                          & _in_keys(keys, s["s_nationkey"]))
    name, addr = _text(s["s_name"][keep]), _text(s["s_address"][keep])
    return [(str(name[i]), str(addr[i])) for i in np.argsort(name,
                                                             kind="stable")]


ORACLES = {"q1": oracle_q1, "q6": oracle_q6, "q18_inner": oracle_q18_inner,
           "q3": oracle_q3, "q4": oracle_q4, "q5": oracle_q5,
           "q10": oracle_q10, "q12": oracle_q12, "q13": oracle_q13,
           "q14": oracle_q14, "q15": oracle_q15, "q17": oracle_q17,
           "q18": oracle_q18, "q19": oracle_q19, "q21": oracle_q21,
           "q22": oracle_q22, "q2": oracle_q2, "q7": oracle_q7,
           "q8": oracle_q8, "q9": oracle_q9, "q11": oracle_q11,
           "q16": oracle_q16, "q20": oracle_q20,
           "ship_delay": oracle_ship_delay, "q6_text": oracle_q6,
           "q1_text": oracle_q1_text,
           "text_roundtrip": oracle_text_roundtrip,
           "price_dispersion": oracle_price_dispersion,
           "price_decades": oracle_price_decades,
           "hash_partitions": oracle_hash_partitions,
           "hash_sample": oracle_hash_sample,
           "q16_distinct": oracle_q16, "q21_distinct": oracle_q21,
           "priority_migration": oracle_priority_migration,
           "segment_bounds": oracle_segment_bounds,
           "urgent_summary": oracle_urgent_summary,
           "q1_rollup": oracle_q1_rollup, "cube_orders": oracle_cube_orders,
           "rollup_nation_year": oracle_rollup_nation_year,
           "union_supply": oracle_union_supply,
           "supplier_reach": oracle_supplier_reach,
           "customer_priorities": oracle_customer_priorities,
           "revenue_ratio": oracle_revenue_ratio,
           "margin_rank": oracle_margin_rank,
           "monthly_deviation": oracle_monthly_deviation,
           "running_spend": oracle_running_spend,
           "order_neighbors": oracle_order_neighbors,
           "top_lines": oracle_top_lines, "spend_rank": oracle_spend_rank}
# how many of the oracle's rows each top-N query keeps, and the column it
# orders by first
TOP_N = {"q3": (10, 3), "q10": (20, 7), "q18": (100, 4), "q2": (100, 0)}


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


def top_rows_match(want_all: List[tuple], got: List[tuple], n: int,
                   order_col: int, rel: float = 1e-9) -> bool:
    """`got` is the first `n` rows of `want_all` (the oracle's rows in the
    query's order), where rows whose `order_col` values tie within `rel`
    may trade places, across the cut too: a float sum taken in another
    order can move a near-tie.  Each got row must equal a distinct oracle
    row under rows_match's rule, and the got order values must equal the
    oracle's first n within `rel`, position by position."""
    cut = min(n, len(want_all))
    if len(got) != cut:
        return False
    if not cut:
        return True

    def ties(a, b):
        return math.isclose(a[order_col], b[order_col], rel_tol=rel,
                            abs_tol=rel)
    # the candidates: the first n rows and those past the cut tying with
    # the n-th
    m = cut
    while m < len(want_all) and ties(want_all[m], want_all[cut - 1]):
        m += 1
    used = set()
    for i, g in enumerate(got):
        if not ties(g, want_all[i]):
            return False
        j = next((j for j in range(m) if j not in used
                  and rows_match([want_all[j]], [g], rel)), None)
        if j is None or not ties(want_all[j], want_all[i]):
            return False
        used.add(j)
    return True
