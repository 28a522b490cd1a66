#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing a line:
  1. device: the card's name and power limit (nvidia-smi), then the
     kernels' build from csrc/ (one nvcc per source, in parallel);
  2. kernels: K1 (segmented scan), K2 (prefix sum) and K3 (word sort),
     each on the card at the shapes the query phase gives it (the 2^26
     batch capacity; K3 at each bit range of q18's grouping, at all 64
     bits, and at 1024, the order-by's capacity; K2 also at int32 and at
     a length that is not a multiple of its tile; K1 at each request set
     the aggregates send it, several columns in one launch, at about
     four rows a group and at 4 groups, a set of several columns also
     timed as one-column launches), on K3's hard inputs too (one digit
     bucket, the top bit set), held against its plain
     PyTorch version on the same inputs and timed beside it, beside one
     PyTorch library call where one computes the same function, and
     beside its bound;
  3. queries: TPC-H lineitem (60 M rows, one 2^26-row batch), orders
     (15 M), customer (1.5 M), part (2 M), supplier (100 k), partsupp
     (8 M), nation and region at SF10, generated on the host from seed
     42; q1, q6 and q18's inner lineitem aggregate, then q3, q4, q12,
     q13, q14, q17, q18, q22, q5, q10, q15, q19, q21, q2, q7, q8, q9,
     q11, q16 and q20 whole (inner, semi, anti and left outer
     equi-joins, limits; q12's In and CaseWhen over string columns; q13's
     Contains filter over o_comment, a left outer join building the 15 M
     orders it keeps, o_comment included, and an aggregate over 1.5 M
     customers; q14's join of one month's lines to the 2 M parts and a
     global sum divided by another; q17's grouped average times 0.2 over
     the lines of ~2,000 parts, joined back to them; q22's Substring of
     c_phone, a collected average and a left_anti join building all 15 M
     orders; q5's chain of six tables ending in a join on two keys;
     q10's aggregate by seven keys, five of them strings, and its top
     20; q15's per-supplier aggregate and the maximum collected from
     it; q19's OR of three conjunctions of In, between and string
     equality over a join to part; q21's semi join of all the lines,
     four aggregates in two levels and the joins back; q2's per-part
     minimum joined back on two keys and its top 100; Year in q7, q8
     and q9; q9's join to partsupp on two keys; q11 at TPC-H's fraction
     0.0001 / SF, which keeps some parts, where the JAX package's 0.0001
     keeps none at SF10; q16's left_anti join and distinct count by
     string keys; q20 at its "forest" prefix, which may keep no supplier
     at SF10 (its oracle must be empty too), and at "" as
     `q20_any_part`, which keeps some), through
     TpuSession(device="cuda"), each compared with a numpy oracle.  The
     session sets spark.rapids.sql.tpu.join.partitioned.enabled=false: at
     SF10 the JAX package's rules partition every one of these joins
     (their build sides are estimated above 64 MB), and the port has no
     exchange yet, so each join builds its whole right side as one batch.
     For each query: the plan's join execs (type, build side, broadcast
     or not, swapped or not), the update path of each aggregate, the
     kernel launches of its first run, in all and per kernel shape
     (`shape_launches`), the warm median of 3, the device
     busy share and the costliest kernels of one more warm run under
     torch.profiler, and the device bytes held before its first run (the
     tables) and at its peak; for q13 also its rows (about 30 (c_count,
     custdist) pairs), whose c_count 0 group counts the customers that
     reach the left outer join's unmatched path.  The launch counts of
     the first runs show the queries went through all three kernels (K3
     in every hash-join build, counted around the build itself, and K1,
     K2 and K3 in the sort-path aggregates of q10, q13, q15, q17, q18,
     q21, q2, q11, q16 and q20), and every shape a kernel was launched at
     there, or in phases 4 and 5, that phase 2 did not cover is held
     against the plain version too, after phase 6.  A `sparsity` line
     counts, with numpy, the rows q9's and q20's joins to partsupp keep;
  4. string filters: count(*) of the orders whose o_comment (2^24 rows of
     up to 64 bytes) passes each of tpch.STRING_FILTERS (Contains, Like,
     StartsWith, EndsWith, Substring), each against its numpy oracle,
     with the kernel launches of its first run (counts set to 0 before
     it; in all and per shape), the warm median of 3, the busy share
     and the peak device bytes;
  5. outer joins: each of tpch.OUTER_JOINS (1992's orders and the
     BUILDING customers: a right outer join, planned as a left outer
     join building the orders, and a full outer join building the
     customers, whose tail is the customers without a 1992 order),
     counted and held to its numpy oracle, with the same numbers as the
     filters and its join execs; each must launch K3 in its build;
  6. date parts: each of the eleven classes (Year to WeekDay) over a
     seeded 2^24-row date column of 1600-2400 and a timestamp column of
     the same years, pre-epoch rows among them, with 10% nulls, on the
     card against the same class on the CPU (values and null masks
     exact), with its time on the card;
  7. date arithmetic and casts: (a) each date-arithmetic class (DateAdd
     to NextDay) and each cast route to or from a date or a timestamp,
     on the card against the CPU over seeded 2^22-row columns like phase
     6's (day counts beyond int32 in a long column, month counts of
     +-1200, seconds, and text written by the port's own date and
     timestamp formats with about 10% of rows made malformed), values,
     null masks and, for text, bytes and lengths exact, each with its
     time on the card (`date_arith` lines); (b) tpch.DATE_QUERIES over
     the resident lineitem through TpuSession(device="cuda"): the
     monthly `ship_delay` report (trunc, datediff, date_add, next_day;
     integers and dates, exact) and `q6_text` (q6 over l_shipdate
     formatted as text and parsed back), each held to its numpy oracle
     (q6_text to q6's) with the numbers of a phase 3 `query` line
     (`date_query` lines); every kernel shape they launch joins the
     shapes checked against the plain versions;
  8. text casts: (a) each cast between text and integers, floats and
     booleans and between numbers and booleans, on the card against the
     CPU over seeded 2^20-row columns (`text_cast_batch`: integers of
     each width at their extremes, doubles written by numpy's shortest
     round trip with subnormals, +-0 and exponents to +-400, boolean
     words in mixed case, about 10% of the text made malformed), values,
     null masks and, for text, bytes and lengths exact, each with its
     time on the card (`text_cast` lines); (b) tpch.TEXT_QUERIES through
     TpuSession(device="cuda"): `q1_text` over the 60 M lines with their
     quantity, price, discount and tax as text (made on the host from
     the resident tables' numbers, untimed, and dropped from the card
     once it has run), cast back (castStringToFloat set) and held to q1's oracle
     with sum_qty an integer; `text_roundtrip` over the resident
     lineitem (order keys, a comparison and return flags through text
     and back; integers, exact); each with the numbers of a phase 3
     `query` line (`text_query` lines); q1_text must launch K3 (its
     order-by), and every shape they launch joins the shapes checked
     against the plain versions;
  9. math, bitwise and hash: (a) each class of the bitwise family,
     ops/math.py and murmur3 (every type alone, and all columns folded)
     on the card against the CPU over seeded 2^20-row columns
     (`math_batch`: integers of each width at their extremes, doubles
     pairing every special value with every other, +-1e19, subnormals,
     values a hair off +-1 and on the x.5 boundaries of the round
     scales, shift counts of -70..70 and beyond, text of 0-64 random
     bytes, 10% nulls): bitwise, shifts, Floor, Ceil, Rint, Round,
     BRound, Signum, Sqrt, ToDegrees, ToRadians and murmur3 bit for bit
     (any NaN equal to any NaN), the other classes within MATH_REL with
     NaN and infinite positions exact, null masks exact, each with its
     time on the card (`math_expr` lines); (b) tpch.MATH_QUERIES over the
     resident lineitem through TpuSession(device="cuda"):
     `price_dispersion` (per-supplier stdev / mean, the top 100; must
     launch K1, K2 and K3), `price_decades` (a log-scale price
     histogram), `hash_partitions` (pmod(hash(l_orderkey), 200)) and
     `hash_sample` (a 1-in-64 sample by a five-column hash), each held to
     its numpy oracle (`tpch.match_math_query`) with the numbers of a
     phase 3 `query` line (`math_query` lines); every shape they launch
     joins the shapes checked against the plain versions;
 10. First, Last, distinct aggregates and string Min/Max: (a) each case
     of `agg_cases` (First and Last of int, long, date, double and text;
     count, sum and average distinct; string min and max; grouped by
     ~1000 and ~2^18 int keys, and global) through a TpuSession on the
     card and one on the CPU over `agg_table`'s seeded 2^20 rows in
     batches of 2^18 (10% nulls, NaN and +-0.0, text of 0-64 bytes with
     shared prefixes), rows equal (exact, float sums within
     SUM_REL_TOL), each with its time on the card (`agg_fn` lines);
     (b) tpch.AGG_QUERIES over the resident tables: `q16_distinct` and
     `q21_distinct` (q16 and q21 with count(distinct)) held to the rows
     phase 3 gave q16 and q21, `priority_migration` (each customer's
     first and last order priority over the orders sorted by date),
     `segment_bounds` (string min/max per market segment) and
     `urgent_summary` (a global distinct count, string bounds, first and
     last) to their numpy oracles, with the numbers of a phase 3 `query`
     line (`agg_query` lines); q21_distinct must launch K1, K2 and K3,
     and every shape phase 10 launches joins the shapes checked against
     the plain versions;
 11. union, distinct, rollup and cube: (a) each of `set_cases` (a union
     of children with text 64 and 8 bytes wide, then grouped; a union
     then distinct; a distinct over an int, a long, a double with NaN
     and +-0.0, a date, a boolean and text; a rollup of an int and a
     text key with data nulls beside the rolled-up nulls; a cube of
     three keys, eight projections of 2^20 rows; a rollup with a
     compound aggregate and an aggregate over a key; a rollup with
     First/Last and a distinct count, whose coalesce sits above the
     Expand) through a card session and a CPU session over `set_table`'s
     seeded 2^20 rows in batches of 2^18, rows equal (float sums within
     SUM_REL_TOL), each with its time on the card (`set_op` lines); (b)
     tpch.SET_QUERIES over the resident tables (`q1_rollup`,
     `cube_orders`, `rollup_nation_year`, `union_supply`,
     `supplier_reach`, `customer_priorities`) held to their numpy
     oracles, with the numbers of a phase 3 `query` line (`set_query`
     lines); union_supply must launch K1, K2 and K3, customer_priorities
     K3, and every shape phase 11 launches joins the shapes checked
     against the plain versions;
 12. window functions: (a) for each frame kind (the whole partition;
     the default frame ordered by a key with ties; ROWS from the start
     to the current row, from the current row to the end, 2 before to 1
     after, 3 before to 1 before) one query of every function it takes
     (count, sum and average, min and max, text min/max where the frame
     starts at the partition's start, first and last, and with an ORDER
     BY row_number, rank, dense_rank, lag and lead with and without a
     default) over ints, longs, doubles and floats with NaN, +-0.0 and
     +-inf, dates, text and booleans, through a card session and a CPU
     session over `window_table`'s seeded 2^20 rows in batches of 2^18
     behind a filter, every column equal (float sums within SUM_REL_TOL
     plus 1e-12 of the partition's |v|), each with its time on the card
     (`window_fn` lines); (b) tpch.WINDOW_QUERIES over the resident
     tables (`revenue_ratio`, `margin_rank`, `monthly_deviation`,
     `running_spend`, `order_neighbors`, `top_lines` over all 2^26
     lines, `spend_rank`) held to their numpy oracles, with the numbers
     of a phase 3 `query` line and the plan's window execs
     (`window_query` lines); top_lines and running_spend must launch K1,
     K2 and K3, and every shape phase 12 launches joins the shapes
     checked against the plain versions.
Every phase's numpy oracles are computed first, by ORACLE_WORKERS
forked processes that share the host tables (an `oracles` line), so no
query is timed beside them.  A `phase_seconds` line gives each phase's
wall seconds.  The
second-last line is the card as nvidia-smi names it; the last is
{"ok": true, "device": {...}}.  Any failure raises: nothing is caught,
and the script prints no result line without a CUDA device.
"""
import functools
import itertools
import json
import math
import multiprocessing
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from spark_rapids_tpu_torch import TpuSession, Window, col, tpch
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.config import CAST_STRING_TO_FLOAT
from spark_rapids_tpu_torch.columnar import (Column, ColumnarBatch,
                                             bucket_rows, bucket_strlen)
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.exec.broadcast import TpuBroadcastHashJoinExec
from spark_rapids_tpu_torch.exec.join import (TpuHashJoinExec,
                                              TpuReorderColumnsExec)
from spark_rapids_tpu_torch.ops import datetime_exprs as D
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import math as M
from spark_rapids_tpu_torch.ops.cast import Cast, cast_column
from spark_rapids_tpu_torch.ops.expressions import BoundReference, Literal
from spark_rapids_tpu_torch.types import (
    BooleanType, ByteType, DateType, DoubleType, FloatType, IntegerType,
    LongType, Schema, ShortType, StringType, StructField, TimestampType)

SF = 10.0                  # TPC-H scale factor of the query phase
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
# float sums: same terms, another order
SUM_REL_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
REPS = 3                   # warm runs of each query
CONF = {"spark.rapids.sql.variableFloatAgg.enabled": "true",
        # the JAX package would partition the SF10 joins; the port builds
        # each one's whole side (see the docstring)
        "spark.rapids.sql.tpu.join.partitioned.enabled": "false"}
ORDER_BY_CAP = 1024        # capacity of q1's bucket state and q18's result
_F64, _I64, _I32 = torch.float64, torch.int64, torch.int32
# K1's request sets, ((dtype, op), ...) per call: q18's two (the float
# sum, and _first_rows' int64 min over the row index) first, then float
# and int64 min/max alone, then _minmax's pairs for a float Min and Max
K1_REQUEST_SETS = [((_F64, "sum"),), ((_I64, "min"),), ((_F64, "min"),),
                   ((_F64, "max"),), ((_I64, "max"),),
                   ((_I32, "max"), (_F64, "min")),
                   ((_I32, "max"), (_F64, "max"))]
# query runs at arguments other than their defaults: name -> (query,
# arguments).  q11 at TPC-H's FRACTION = 0.0001 / SF; q20 at the prefix
# "" (every part) as well as at its default "forest"
VARIANTS = {"q11": ("q11", (tpch.Q11_FRACTION / SF,)),
            "q20_any_part": ("q20", ("",))}
# may come back empty at SF10, when its oracle does too (tpch.q20)
MAY_BE_EMPTY = {"q20"}
# their aggregates take the sort path: each launches K1, K2 and K3
SORT_PATH = ("q10", "q13", "q15", "q17", "q18", "q21", "q2", "q11", "q16",
             "q20", "q20_any_part")
DATE_PART_ROWS = 1 << 24
# phases 9, 8 and 7 (a) were cut from 2^22, 2^22 and 2^24 rows to keep
# the whole run inside its time limit
DATE_ARITH_ROWS = 1 << 22
TEXT_CAST_ROWS = 1 << 20
MATH_ROWS = 1 << 20
AGG_ROWS = 1 << 20         # phase 10 (a): rows, in batches of AGG_BATCH_ROWS
AGG_BATCH_ROWS = 1 << 18
SET_ROWS = 1 << 20         # phase 11 (a): rows, in batches of SET_BATCH_ROWS
SET_BATCH_ROWS = 1 << 18
# the numpy oracles, computed by this many processes before the card
# phases (434 s one after another on the card's host at SF10), the
# slowest queued first
ORACLE_WORKERS = 6
SLOW_ORACLES = ("q21", "q9", "q7", "hash_sample", "q13", "q20_any_part",
                "q12", "rollup_nation_year", "q5", "q8", "q10", "q18")
ORACLE_ROWS: dict = {}     # key -> (rows, seconds), see oracle_rows
WINDOW_ROWS = 1 << 20      # phase 12 (a): rows, in batches of
WINDOW_BATCH_ROWS = 1 << 18  # WINDOW_BATCH_ROWS
# phase 12 (a): frame kind -> (order keys, ROWS bounds or None for the
# default frame); "range" orders by a key with ties
WINDOW_FRAMES = {"whole": ((), None), "range": (("g",), None),
                 "running": (("o",), (-(1 << 62), 0)),
                 "suffix": (("o",), (0, 1 << 62)),
                 "bounded": (("o",), (-2, 1)),
                 "before": (("o",), (-3, -1))}
# phase 12 (b): the kernels each query must launch
WINDOW_LAUNCHES = {"top_lines": ("seg_scan", "cumsum", "sort_words"),
                   "running_spend": ("seg_scan", "cumsum", "sort_words")}
# phase 11 (b): the kernels each query must launch
SET_LAUNCHES = {"union_supply": ("seg_scan", "cumsum", "sort_words"),
                "customer_priorities": ("sort_words",)}
# text the JAX package's parses read apart from Spark: digit sums that
# wrap in int64, a mantissa of more than 19 digits, 10^23, scales past
# 10^308
TEXT_EDGES = [b"9999999999999999999", b"9223372036854775808",
              b"-9223372036854775809", b"3.14159265358979323846", b"1e23",
              b"4.9e-324", b"1e-400", b"1e400", b"-0",
              b"123456789012345678901234"]
# every case spelling of the boolean words
BOOL_FORMS = [bytes(c) for w in (b"true", b"t", b"yes", b"y", b"1",
                                 b"false", b"f", b"no", b"n", b"0")
              for c in itertools.product(*[sorted({ch, ch & ~0x20})
                                           if 0x61 <= ch <= 0x7A else [ch]
                                           for ch in w])]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of one call, from CUDA events over `reps` calls
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def grouping_bits(cap: int, key_bits: int = 128) -> list:
    """The bit ranges the packed argsort hands K3 when it groups `cap`
    rows by `key_bits` of hash (q18's two 64-bit hashes): the row id
    fills the low r = log2(cap) bits, each pass sorts up to 64 - r key
    bits above it."""
    r = cap.bit_length() - 1
    widths = [min(64 - r, key_bits - start)
              for start in range(0, key_bits, 64 - r)]
    return sorted({(r, r + w) for w in widths}, key=lambda b: -b[1])


def phase2_shapes(cap: int) -> list:
    """The (kernel, shape) pairs phase 2 checks: K3 at the batch capacity
    for each bit range of q18's grouping and for all 64 bits (the radix
    route), and at the capacity the order-bys sort (the tile route); K2
    at int64 and int32, at the capacity and at a length that is not a
    multiple of its tile; K1 at the request sets the aggregates give
    it.  A shape is what the wrapper notes in its `shapes` set."""
    r_ob = ORDER_BY_CAP.bit_length() - 1
    return ([("sort_words", (cap, torch.int64) + b)
             for b in grouping_bits(cap) + [(0, 64)]]
            + [("sort_words", (ORDER_BY_CAP, torch.int64, r_ob, 64))]
            + [("cumsum", (n, dt)) for n in (cap, cap + 7)
               for dt in (torch.int64, torch.int32)]
            + [("seg_scan", (cap, cols)) for cols in K1_REQUEST_SETS])


def check_kernels(gen: torch.Generator, dev: torch.device, shapes: list,
                  report: dict) -> None:
    """Every (kernel, shape) in `shapes` against its plain version on the
    card.  `report` keeps, per kernel, the numbers of the first shape
    checked (the batch capacity) and the largest error of all."""

    def compare(got, want, exact):
        """(max abs error, max rel error, agrees) of one output."""
        if exact:
            ok = torch.equal(got, want) if not got.is_floating_point() else \
                bool(torch.all((got == want)
                               | (torch.isnan(got) & torch.isnan(want))))
            err = 0.0 if ok else float("inf")
            return err, err, ok
        nan_ok = torch.equal(torch.isnan(got), torch.isnan(want))
        m = ~torch.isnan(want)
        diff = (got[m] - want[m]).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        rel = float((diff / want[m].abs().clamp_min(1e-300)).max()) \
            if diff.numel() else 0.0
        return err, rel, nan_ok and rel <= SUM_REL_TOL[got.dtype]

    def record(kernel, config, outputs, kernel_fn, plain_fn, library_fn,
               nbytes, **extra):
        """`outputs`: (kernel's, plain version's, exact) per output."""
        errs = [compare(*o) for o in outputs]
        err = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        ok = all(e[2] for e in errs)
        row = {"kernel": kernel, "config": config,
               "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn, 2),
               "library_ms": time_ms(library_fn) if library_fn else None,
               "bound_ms": bound_ms(nbytes), "max_abs_err": err,
               "max_rel_err": rel, "ok": ok, **extra}
        print("kernel " + json.dumps(row), flush=True)
        if not ok:
            raise AssertionError(f"{kernel} {config} disagrees with its "
                                 f"plain version: {row}")
        report.setdefault(kernel, row)
        report[kernel]["max_abs_err"] = max(report[kernel]["max_abs_err"],
                                            err)

    def sort_words(n, dtype, lo, hi):
        # (0, 64): arbitrary words, the top bit set on about half.  Else
        # the packed sort's words, key bits [lo, hi) above the row id in
        # the low lo = log2(n) bits: random keys; one key for every word
        # (every digit of a pass in one bucket); and random keys under
        # high bits that every word shares and that set the top bit
        r = n.bit_length() - 1
        if (lo, hi) != (0, 64) and lo != r:
            raise ValueError(f"no packed words for n={n} bits={lo, hi}")
        iota = torch.arange(n, dtype=dtype, device=dev)
        inputs = []
        rand = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), dtype=dtype,
                             device=dev, generator=gen)
        if (lo, hi) == (0, 64):
            inputs.append(("arbitrary words", rand))
        else:
            mask = (1 << (hi - lo)) - 1 if hi - lo < 64 else -1
            inputs.append(("random keys" + (", top bit set on half"
                                            if hi == 64 else ""),
                           ((rand & mask) << lo) | iota))
            inputs.append(("one key", (torch.full_like(rand, mask & 0x5A5)
                                       << lo) | iota))
            if hi < 64:
                inputs.append(("random keys under shared top bits",
                               (-(1 << hi)) | ((rand & mask) << lo)
                               | iota))
        del rand, iota
        for what, w in inputs:
            record("sort_words", f"n={n} {dtype} bits=({lo}, {hi}) {what}",
                   [(K.sort_words(w, (lo, hi)), K.sort_words_plain(w),
                     True)],
                   lambda: K.sort_words(w, (lo, hi)),
                   lambda: K.sort_words_plain(w), lambda: torch.sort(w),
                   16 * n)
        del inputs, w

    def cumsum(n, dtype):
        # counts and sums whose running total wraps
        top = torch.iinfo(dtype).max
        v = torch.randint(top // 8, top // 2, (n,), dtype=dtype, device=dev,
                          generator=gen)
        record("cumsum", f"n={n} {dtype}, wraps",
               [(K.cumsum(v), K.cumsum_plain(v), True)],
               lambda: K.cumsum(v), lambda: K.cumsum_plain(v),
               lambda: torch.cumsum(v, 0, dtype=dtype),
               2 * n * v.element_size())

    def column(n, dtype):
        if dtype.is_floating_point:
            # positive values like the prices the queries sum, so a
            # relative tolerance holds for every running value
            v = (torch.rand(n, dtype=torch.float64, device=dev,
                            generator=gen) * 1e5 + 1.0).to(dtype)
            v[torch.rand(n, device=dev, generator=gen)
              < max(1e-6, 4 / n)] = float("nan")
            return v
        info = torch.iinfo(dtype)
        return torch.randint(info.min // 2, info.max // 2, (n,), dtype=dtype,
                             device=dev, generator=gen)

    def seg_scan(n, cols):
        # one request set in one launch, at about four rows a group
        # (q18's orders) and at 4 groups (q1's); a set of several columns
        # is also timed as one-column launches.  Floats hold NaN at
        # p = max(1e-6, 4 / n)
        ops = [op for _, op in cols]
        for groups in (max(1, n // 4), 4):
            gid = torch.sort(torch.randint(0, groups, (n,), device=dev,
                                           generator=gen)).values
            gid = gid.to(torch.int32)
            vals = [column(n, dtype) for dtype, _ in cols]
            extra = {}
            if len(cols) > 1:
                extra["separate_ms"] = time_ms(lambda: [
                    K.seg_scan(gid, [v], [op]) for v, op in zip(vals, ops)])
            record("seg_scan", f"n={n} {groups} groups "
                   + ", ".join(f"{dt} {op}" for dt, op in cols),
                   [(got, want, not (op == "sum" and v.is_floating_point()))
                    for got, want, v, op in zip(
                        K.seg_scan(gid, vals, ops),
                        K.seg_scan_plain(gid, vals, ops), vals, ops)],
                   lambda: K.seg_scan(gid, vals, ops),
                   lambda: K.seg_scan_plain(gid, vals, ops), None,
                   n * (4 + sum(2 * v.element_size() for v in vals)),
                   **extra)
            del gid, vals

    checks = {"sort_words": sort_words, "cumsum": cumsum,
              "seg_scan": seg_scan}
    for kernel, shape in shapes:
        checks[kernel](*shape)


def _queries(dfs: dict) -> dict:
    """name -> a function running that query's DataFrame."""
    li = dfs["lineitem"]
    out = {name: (lambda q=q: q(li)) for name, q in tpch.QUERIES.items()}
    out.update({name: (lambda q=q: q(dfs))
                for name, q in tpch.JOIN_QUERIES.items()})
    out.update({name: (lambda q=q, a=a: tpch.JOIN_QUERIES[q](dfs, *a))
                for name, (q, a) in VARIANTS.items()})
    return out


def _oracle(name: str, tables: dict) -> list:
    query, args = VARIANTS.get(name, (name, ()))
    if query in tpch.QUERIES:
        return tpch.ORACLES[query](tables["lineitem"])
    return tpch.ORACLES[query](tables, *args)


def _lineitem_oracle(name: str, tables: dict) -> list:
    return tpch.ORACLES[name](tables["lineitem"])


def _tables_oracle(name: str, tables: dict) -> list:
    return tpch.ORACLES[name](tables)


def _filter_oracle(name: str, tables: dict) -> int:
    return tpch.oracle_string_filter(tables["orders"], name)


def _outer_oracle(name: str, tables: dict) -> list:
    return tpch.OUTER_JOINS[name][1](tables)


def oracle_jobs() -> dict:
    """Every numpy oracle the phases hold their queries to, by the key
    oracle_rows takes: a function of the generated tables each."""
    jobs = {n: functools.partial(_oracle, n) for n in
            list(tpch.QUERIES) + list(tpch.JOIN_QUERIES) + list(VARIANTS)}
    for group in (tpch.DATE_QUERIES, tpch.TEXT_QUERIES, tpch.MATH_QUERIES):
        jobs.update({n: functools.partial(_lineitem_oracle, n)
                     for n in group})
    for group in (tpch.AGG_QUERIES, tpch.SET_QUERIES, tpch.WINDOW_QUERIES):
        # q16_distinct and q21_distinct are held to phase 3's rows
        jobs.update({n: functools.partial(_tables_oracle, n)
                     for n in group if not n.endswith("_distinct")})
    jobs.update({f"filter {n}": functools.partial(_filter_oracle, n)
                 for n in tpch.STRING_FILTERS})
    jobs.update({f"outer_join {n}": functools.partial(_outer_oracle, n)
                 for n in tpch.OUTER_JOINS})
    return jobs


# what the forked oracle processes read (set just before they start)
_POOL_TABLES: dict = {}
_POOL_JOBS: dict = {}


def _pool_oracle(key: str) -> tuple:
    t0 = time.perf_counter()
    rows = _POOL_JOBS[key](_POOL_TABLES)
    return key, rows, time.perf_counter() - t0


def precompute_oracles(tables: dict, workers: int = ORACLE_WORKERS) -> dict:
    """key -> (rows, seconds) of every oracle_jobs() entry, computed in
    `workers` forked processes that share the host tables (they only
    read them), all before the card phases, so that no query is timed
    beside them.  The pool is closed, its processes ended, on return."""
    _POOL_TABLES.update(tables)
    _POOL_JOBS.update(oracle_jobs())
    keys = sorted(_POOL_JOBS, key=lambda k: k not in SLOW_ORACLES)
    try:
        with multiprocessing.get_context("fork").Pool(workers) as pool:
            return {key: (rows, secs) for key, rows, secs in
                    pool.imap_unordered(_pool_oracle, keys)}
    finally:
        _POOL_TABLES.clear()
        _POOL_JOBS.clear()


def oracle_rows(key: str, compute) -> tuple:
    """(rows, seconds) of the oracle `key`: taken from ORACLE_ROWS, which
    precompute_oracles fills in a whole run, or computed now by
    `compute()` when a phase runs alone."""
    if key in ORACLE_ROWS:
        return ORACLE_ROWS.pop(key)
    t0 = time.perf_counter()
    rows = compute()
    return rows, time.perf_counter() - t0


def _matches(name: str, want: list, got: list) -> bool:
    query = VARIANTS.get(name, (name,))[0]
    if query in tpch.TOP_N:
        return tpch.top_rows_match(want, got, *tpch.TOP_N[query])
    return tpch.rows_match(want, got)


def run_queries(tables: dict, device: str = "cuda") -> tuple:
    """The queries on the card against the numpy oracles; returns the
    kernel launch counts of the queries' first runs, the shapes each
    kernel was launched at there, the session's DataFrames, and each
    query's rows."""
    t0 = time.perf_counter()
    s = TpuSession(dict(CONF), device=device)
    dfs = {n: s.from_numpy(t, tpch.SCHEMAS[n]) for n, t in tables.items()}
    torch.cuda.synchronize()
    print("queries: " + ", ".join(
        f"{n} rows={df.plan.num_rows} capacity={df.plan.table.capacity}"
        for n, df in dfs.items())
        + f"; copied to the card in {time.perf_counter() - t0:.3f} s",
        flush=True)
    queries = _queries(dfs)

    K.reset_launches()
    first = {}
    for name, q in queries.items():
        before = K.launch_counts()
        before_shapes = shape_launches()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = q().collect()
        ms = (time.perf_counter() - t0) * 1e3
        own = {k: c - before[k] for k, c in K.launch_counts().items()}
        first[name] = (ms, got, _update_paths(s.last_plan),
                       (own, shape_launches(before_shapes)),
                       join_nodes(s.last_plan),
                       (resident, torch.cuda.max_memory_allocated()))
    launches = K.launch_counts()
    shapes = launched_shapes()
    for name, (ms, got, paths, (own, own_shapes), joins, mem) in \
            first.items():
        want, oracle_s = oracle_rows(name, lambda: _oracle(name, tables))
        match = _matches(name, want, got)
        warm = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            queries[name]().collect()
            warm.append((time.perf_counter() - t0) * 1e3)
        print("query " + json.dumps({
            "query": name, "rows": len(got),
            "matches_oracle": match, "oracle_s": oracle_s,
            "joins": joins, "first_ms": ms, "warm_ms": warm,
            "warm_median_ms": statistics.median(warm),
            "agg_update_paths": paths, "launches": own,
            "shape_launches": own_shapes,
            "resident_device_bytes": mem[0], "peak_device_bytes": mem[1],
            "profile": profile_query(queries[name]),
            **({"result": [[int(v) for v in r] for r in got]}
               if name == "q13" else {})}),
            flush=True)
        if not match or not (got or name in MAY_BE_EMPTY):
            raise AssertionError(f"{name} disagrees with the numpy oracle "
                                 f"or is empty: {got[:3]} vs {want[:3]}")
        unsorted = [j for j in joins if not j["build_k3_launches"]]
        if name not in tpch.QUERIES and not joins:
            raise AssertionError(f"{name} planned no hash join: {joins}")
        if unsorted:
            raise AssertionError(f"{name}: hash-join builds that launched "
                                 f"no K3: {unsorted}")
    for name in SORT_PATH:
        if not all(first[name][3][0].values()):
            raise AssertionError(f"{name} did not launch every kernel: "
                                 f"{first[name][3][0]}")
    print("launches in the query phase " + json.dumps(launches), flush=True)
    print("shapes launched in the query phase "
          + json.dumps([[k, [str(x) for x in s]] for k, s in shapes]),
          flush=True)
    missing = [k for k, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the queries: "
                             f"{missing}")
    return launches, shapes, dfs, {name: f[1] for name, f in first.items()}


def partsupp_sparsity(tables: dict) -> dict:
    """With numpy: how many of q9's "green" lines, and of q20's (part,
    supplier) pairs of 1994, meet a partsupp row of the same part and
    supplier (the JAX datagen draws a line's supplier apart from them)."""
    ps, li, p = tables["partsupp"], tables["lineitem"], tables["part"]
    width = int(ps["ps_suppkey"].max()) + 1
    ps_pairs = np.unique(ps["ps_partkey"] * width + ps["ps_suppkey"])

    def met(part, supp):
        return int(np.isin(part * width + supp, ps_pairs).sum())
    green = np.isin(li["l_partkey"], p["p_partkey"][
        np.char.find(p["p_name"], b"green") >= 0])
    sd = li["l_shipdate"]
    y94 = (sd >= tpch.days("1994-01-01")) & (sd < tpch.days("1995-01-01"))
    pairs = np.unique(li["l_partkey"][y94] * width + li["l_suppkey"][y94])
    forest = np.isin(pairs // width, p["p_partkey"][
        np.char.startswith(p["p_name"], b"forest")])
    return {"q9_green_lines": int(green.sum()),
            "q9_green_lines_meeting_partsupp": met(li["l_partkey"][green],
                                                   li["l_suppkey"][green]),
            "q20_pairs_1994": len(pairs),
            "q20_pairs_meeting_partsupp": met(pairs // width, pairs % width),
            "q20_forest_pairs_meeting_partsupp": met(
                pairs[forest] // width, pairs[forest] % width)}


def check_date_parts(dev: torch.device, seed: int = 42) -> None:
    """Each of the eleven date parts over a seeded date and timestamp
    column (1600-2400, pre-epoch rows among them, 10% nulls) on the card
    against the same class on the CPU: values and null masks exact."""
    rng = np.random.default_rng(seed)
    n = DATE_PART_ROWS
    lo, hi = tpch.days("1600-01-01"), tpch.days("2400-12-31")
    day_us = 86_400_000_000
    cols = {"d": rng.integers(lo, hi + 1, n, dtype=np.int32),
            "t": rng.integers(lo * day_us, (hi + 1) * day_us, n)}
    valid = rng.random(n) >= 0.1
    data = {k: np.ma.masked_array(v, mask=~valid) for k, v in cols.items()}
    schema = Schema([StructField("d", DateType),
                     StructField("t", TimestampType)])
    batches = {str(d): TpuSession(device=d).from_numpy(data, schema)
               .plan.table for d in ("cpu", dev)}
    classes = [getattr(D, c) for c in (
        "Year", "Month", "DayOfMonth", "DayOfWeek", "DayOfYear", "Quarter",
        "LastDay", "Hour", "Minute", "Second", "WeekDay")]
    for i, dtype in enumerate((DateType, TimestampType)):
        for cls in classes:
            expr = cls(BoundReference(i, dtype))
            want, got = (expr.eval(batches[k]) for k in ("cpu", str(dev)))
            ok = (torch.equal(got.data.cpu(), want.data)
                  and torch.equal(got.valid.cpu(), want.valid))
            print("date_part " + json.dumps({
                "class": cls.__name__, "child": dtype.name, "rows": n,
                "matches_cpu": ok, "ms": time_ms(
                    lambda: expr.eval(batches[str(dev)]))}), flush=True)
            if not ok:
                raise AssertionError(f"{cls.__name__} of a {dtype.name} "
                                     "column on the card differs from the "
                                     "CPU")


def _malformed(text: list, ts: bool) -> list:
    """Each text (bytes) made malformed one of nine ways in turn: Feb 30,
    month 13, single-digit date parts, bytes <= 0x20 around it, a
    letter, three dashes, a time with other separators (valid for a
    timestamp, as in the JAX package), a trailing no-break space, a
    full-width first digit; a timestamp's hour 24 and a 5-byte time
    too."""
    def single(x):
        y, m, d = x[:10].split(b"-")
        return b"%s-%d-%d" % (y, int(m), int(d)) + x[10:]
    kinds = [lambda x: x[:5] + b"02-30" + x[10:],
             lambda x: x[:5] + b"13" + x[7:],
             single,
             lambda x: b" \t" + x + b"\n\x0b",
             lambda x: x[:8] + b"x" + x[9:],
             lambda x: x[:7] + b"--" + x[8:],
             lambda x: x[:10] + b" 12x34y56",
             lambda x: x + b"\xc2\xa0",
             lambda x: b"\xef\xbc\x91" + x[1:]]
    if ts:
        kinds += [lambda x: x[:11] + b"24" + x[13:], lambda x: x[:16]]
    return [kinds[i % len(kinds)](x) for i, x in enumerate(text)]


def _text_column(c: Column, rng: np.random.Generator, share: float,
                 ts: bool) -> Column:
    """A copy of string column `c` (on the CPU) with about `share` of its
    rows made malformed (`_malformed`), widened to a power of two that
    holds them."""
    src, lens = c.data.numpy(), c.lengths.numpy().copy()
    rows = np.flatnonzero(rng.random(len(lens)) < share)
    blob, w = src[rows].tobytes(), c.max_len
    bad = _malformed([blob[i * w:i * w + n]
                      for i, n in enumerate(lens[rows].tolist())], ts)
    width = bucket_strlen(max([c.max_len] + [len(x) for x in bad]))
    data = np.zeros((c.capacity, width), np.uint8)
    data[:, :c.max_len] = src
    packed = np.frombuffer(b"".join(x.ljust(width, b"\0") for x in bad),
                           np.uint8).reshape(len(bad), width)
    data[rows] = packed
    lens[rows] = [len(x) for x in bad]
    valid = c.valid.numpy()
    data[~valid], lens[~valid] = 0, 0
    return Column(torch.from_numpy(data), c.valid,
                  StringType, torch.from_numpy(lens))


def date_arith_batch(n: int, seed: int = 42) -> ColumnarBatch:
    """The CPU batch of phase 7 (a): dates and timestamps of 1600-2400
    (two of each), int and long day counts (the long's beyond int32),
    month counts of +-1200, seconds as long, double and float, short,
    byte and boolean columns, and the dates' and first timestamps' text
    by the port's formats, about 10% malformed; 10% nulls in every
    column."""
    rng = np.random.default_rng(seed)
    lo, hi = tpch.days("1600-01-01"), tpch.days("2400-12-31")
    day_us = 86_400_000_000
    secs = rng.integers(lo * 86_400, (hi + 1) * 86_400, n)
    cols = {
        "d": (rng.integers(lo, hi + 1, n, dtype=np.int32), DateType),
        "d2": (rng.integers(lo, hi + 1, n, dtype=np.int32), DateType),
        "t": (rng.integers(lo * day_us, (hi + 1) * day_us, n),
              TimestampType),
        "t2": (rng.integers(lo * day_us, (hi + 1) * day_us, n),
               TimestampType),
        "k": (rng.integers(-200_000, 200_000, n, dtype=np.int32),
              IntegerType),
        "kl": (rng.integers(-2 ** 40, 2 ** 40, n), LongType),
        "mo": (rng.integers(-1200, 1201, n, dtype=np.int32), IntegerType),
        "sec": (secs, LongType),
        "x": (secs + rng.random(n), DoubleType),
        "f": ((secs + rng.random(n)).astype(np.float32), FloatType),
        "i16": (rng.integers(-2 ** 15, 2 ** 15, n, dtype=np.int16),
                ShortType),
        "i8": (rng.integers(-128, 128, n, dtype=np.int8), ByteType),
        "b": (rng.random(n) < 0.5, BooleanType)}
    data = {k: np.ma.masked_array(v, mask=rng.random(n) < 0.1)
            for k, (v, _) in cols.items()}
    schema = Schema([StructField(k, t) for k, (_, t) in cols.items()])
    batch = TpuSession(device="cpu").from_numpy(data, schema).plan.table
    texts = [_text_column(cast_column(batch.column(k), StringType), rng,
                          0.1, k == "t") for k in ("d", "t")]
    return ColumnarBatch(
        list(batch.columns) + texts, batch.sel,
        Schema(list(schema) + [StructField("ds", StringType),
                               StructField("ts", StringType)]))


def date_arith_cases(schema: Schema) -> list:
    """(name, expression) of each date-arithmetic class and cast route
    phase 7 (a) checks, over `date_arith_batch`'s columns."""
    def c(name):
        i = schema.index_of(name)
        return BoundReference(i, schema[i].dtype, name)
    casts = [("d", TimestampType), ("t", DateType), ("t", LongType),
             ("sec", TimestampType), ("k", TimestampType),
             ("i16", TimestampType), ("i8", TimestampType),
             ("t", DoubleType), ("t", FloatType), ("x", TimestampType),
             ("f", TimestampType), ("b", TimestampType), ("k", DateType),
             ("i16", DateType), ("d", IntegerType), ("d", LongType),
             ("ds", DateType), ("ts", TimestampType), ("d", StringType),
             ("t", StringType)]
    cases = [(f"cast {src}:{schema[schema.index_of(src)].dtype.name} -> "
              f"{to.name}", Cast(c(src), to)) for src, to in casts]
    cases += [
        ("DateAdd(d, k)", D.DateAdd(c("d"), c("k"))),
        ("DateAdd(d, kl) (long days, wrapped to int32)",
         D.DateAdd(c("d"), c("kl"))),
        ("DateSub(d, k)", D.DateSub(c("d"), c("k"))),
        ("DateDiff(d, d2)", D.DateDiff(c("d"), c("d2"))),
        ("DateDiff(t, d)", D.DateDiff(c("t"), c("d"))),
        ("UnixTimestamp(t)", D.UnixTimestamp(c("t"))),
        ("UnixTimestamp(d)", D.UnixTimestamp(c("d"))),
        ("UnixTimestamp(ts)", D.UnixTimestamp(c("ts"))),
        ("ToUnixTimestamp(t)", D.ToUnixTimestamp(c("t"))),
        ("FromUnixTime(sec)", D.FromUnixTime(c("sec"))),
        ("TimeAdd(t, kl)", D.TimeAdd(c("t"), c("kl"))),
        ("TimeSub(t, kl)", D.TimeSub(c("t"), c("kl"))),
        ("AddMonths(d, mo)", D.AddMonths(c("d"), c("mo"))),
        ("MonthsBetween(d, d2)", D.MonthsBetween(c("d"), c("d2"))),
        ("MonthsBetween(t, t2, false)",
         D.MonthsBetween(c("t"), c("t2"), Literal(False)))]
    cases += [(f"TruncDate(d, {f})", D.TruncDate(c("d"), Literal(f)))
              for f in ("year", "quarter", "month", "week")]
    cases += [(f"NextDay(d, {day})", D.NextDay(c("d"), Literal(day)))
              for day in ("MO", "sunday")]
    return cases


def _same_bits(got: torch.Tensor, want: torch.Tensor,
               any_nan: bool = False) -> bool:
    """Equal dtype and bits (a float by its bits, NaN too, unless
    `any_nan`: then any NaN equals any NaN, as the card's arithmetic
    gives its own NaN where the CPU passes an operand's on)."""
    if got.dtype != want.dtype:
        return False
    got = got.cpu()
    if got.is_floating_point():
        nan = torch.isnan(got) & torch.isnan(want) if any_nan \
            else torch.zeros_like(got, dtype=torch.bool)
        ints = {torch.float64: torch.int64, torch.float32: torch.int32}
        return bool(torch.all(nan | (got.view(ints[got.dtype])
                                     == want.view(ints[want.dtype]))))
    return torch.equal(got, want)


def check_on_card(kind: str, cpu: ColumnarBatch, cases: list,
                  dev: torch.device, approx: set = None) -> None:
    """Each (name, expression) of `cases` over batch `cpu` and its copy
    on the card: values (floats by their bits), null masks and, for
    text, bytes and lengths exact; one `kind` line each, with its time
    on the card.  With `approx` (phase 9) any NaN equals any NaN, and a
    case named in it is held by `_close` instead of bits."""
    card = ColumnarBatch(
        [Column(c.data.to(dev), c.valid.to(dev), c.dtype,
                None if c.lengths is None else c.lengths.to(dev))
         for c in cpu.columns], cpu.sel.to(dev), cpu.schema)
    for name, expr in cases:
        want, got = expr.eval(cpu), expr.eval(card)
        parts = [(got.data, want.data), (got.valid, want.valid)]
        if want.dtype is StringType:
            parts.append((got.lengths, want.lengths))
        if approx is not None and name in approx:
            ok = (got.dtype is want.dtype and _close(got.data, want.data)
                  and _same_bits(got.valid, want.valid))
        else:
            ok = got.dtype is want.dtype and all(
                _same_bits(g, w, approx is not None) for g, w in parts)
        print(f"{kind} " + json.dumps({
            "case": name, "type": want.dtype.name, "rows": cpu.capacity,
            "valid_rows": int(want.valid.sum()), "matches_cpu": ok,
            "ms": time_ms(lambda: expr.eval(card))}), flush=True)
        if not ok:
            g, w = got.data.cpu(), want.data
            same = g == w
            if w.is_floating_point():
                same |= g.isnan() & w.isnan()
                if approx is not None and name in approx:
                    same |= ((g - w).abs() <= MATH_REL * w.abs()) \
                        & g.isfinite() & w.isfinite()
            bad = torch.nonzero(~same | (got.valid.cpu() != want.valid))
            refs, stack = [], [expr]
            while stack:
                e = stack.pop()
                refs += [e.index] if isinstance(e, BoundReference) else []
                stack.extend(e.children)
            rows = [(int(i), [cpu.columns[k].data[i].tolist() for k in refs],
                     w[i].tolist(), g[i].tolist()) for i in bad[:4, 0]]
            raise AssertionError(f"{name} on the card differs from the CPU;"
                                 f" (row, inputs, cpu, card): {rows}")


def check_date_arith(dev: torch.device) -> None:
    """Phase 7 (a): each case of `date_arith_cases` on the card against
    the CPU: values, null masks and, for text, bytes and lengths
    exact."""
    cpu = date_arith_batch(DATE_ARITH_ROWS)
    check_on_card("date_arith", cpu, date_arith_cases(cpu.schema), dev)


def run_date_queries(li_df, lineitem: dict) -> list:
    """Phase 7 (b): each of tpch.DATE_QUERIES over the resident lineitem
    against its numpy oracle (`measure`), with the numbers of a phase 3
    `query` line; ship_delay must launch K3 (its order-by).  Returns the
    (kernel, shape) pairs they launched."""
    shapes = []
    for name, query in tpch.DATE_QUERIES.items():
        resident = torch.cuda.memory_allocated()
        got, df, numbers, launched = measure(lambda query=query:
                                             query(li_df))
        shapes += launched
        want, oracle_s = oracle_rows(
            name, lambda: tpch.ORACLES[name](lineitem))
        match = tpch.rows_match(want, got)
        plan = df.session.last_plan
        print("date_query " + json.dumps({
            "query": name, "rows": len(got), "matches_oracle": match,
            "oracle_s": oracle_s, "joins": join_nodes(plan),
            "agg_update_paths": _update_paths(plan),
            "resident_device_bytes": resident, **numbers,
            **({"result": [[str(v) for v in r] for r in got]}
               if name == "ship_delay" else {})}, default=str),
            flush=True)
        if not match or not got:
            raise AssertionError(f"{name} disagrees with the numpy oracle "
                                 f"or is empty: {got[:3]} vs {want[:3]}")
        if name == "ship_delay" and not numbers["launches"]["sort_words"]:
            raise AssertionError(f"ship_delay launched no K3: {numbers}")
    return shapes


def _malformed_text(text: np.ndarray, rng: np.random.Generator,
                    share: float) -> np.ndarray:
    """A copy of byte-string array `text` with about `share` of its rows
    made malformed, each of these forms in turn: a sign alone, two dots,
    `e5e` after it, `e5`, `0x10`, `1_000`, full-width digits, a trailing
    no-break space, bytes <= 0x20 around it (which the trim takes off),
    one of TEXT_EDGES."""
    out = text.astype(f"S{text.itemsize + 8}")
    rows = np.flatnonzero(rng.random(len(text)) < share)
    forms = [lambda t: np.full(len(t), b"+"),
             lambda t: np.full(len(t), b"-"),
             lambda t: np.char.add(t, b".5.5"),
             lambda t: np.char.add(t, b"e5e"),
             lambda t: np.full(len(t), b"e5"),
             lambda t: np.full(len(t), b"0x10"),
             lambda t: np.full(len(t), b"1_000"),
             lambda t: np.full(len(t), "\uff11\uff12".encode()),
             lambda t: np.char.add(t, b"\xc2\xa0"),
             lambda t: np.char.add(np.char.add(b" \t", t), b"\n\x0b"),
             lambda t: rng.choice(np.array(TEXT_EDGES), len(t))]
    for k, form in enumerate(forms):
        at = rows[k::len(forms)]
        out[at] = form(out[at])
    return out


def text_cast_batch(n: int, seed: int = 42) -> ColumnarBatch:
    """The CPU batch of phase 8 (a): byte, short, int and long columns
    over their whole ranges, extremes first; doubles of magnitudes
    10^-320 to 10^300 (subnormals among them) with NaN, +-inf and +-0,
    and their floats; booleans; and text: integers of every width, other
    doubles written by numpy's shortest round trip (17-digit mantissas)
    with a tenth given exponents of +-400, and every case spelling of
    the boolean words, each about 10% malformed (`_malformed_text`); 10%
    nulls in every column."""
    rng = np.random.default_rng(seed)
    cols = {}
    for name, dt, t in (("i8", np.int8, ByteType), ("i16", np.int16,
                                                     ShortType),
                        ("i32", np.int32, IntegerType),
                        ("i64", np.int64, LongType)):
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        v[:4] = [info.min, info.max, 0, -1]
        cols[name] = (v, t)

    def doubles():
        x = rng.normal(0, 1, n) * 10.0 ** rng.integers(-320, 300, n)
        pick = rng.random(n)
        return np.where(pick < 0.01, np.nan, np.where(
            pick < 0.02, np.inf * np.sign(pick - 0.015), np.where(
                pick < 0.03, np.copysign(0.0, pick - 0.025), x)))
    x = doubles()
    with np.errstate(over="ignore"):
        cols["x"] = (x, DoubleType)
        cols["f"] = (x.astype(np.float32), FloatType)
    cols["b"] = (rng.random(n) < 0.5, BooleanType)
    width = rng.integers(0, 4, n)
    ints = np.choose(width, [cols[c][0].astype(np.int64)
                             for c in ("i8", "i16", "i32", "i64")])
    text = doubles().astype("S24")
    far = np.flatnonzero(rng.random(n) < 0.1)
    text[far] = np.char.add(np.char.add(rng.random(len(far)).astype("S12"),
                                        b"e"),
                            rng.integers(-400, 401, len(far)).astype("S4"))
    texts = {"it": ints.astype("S20"), "ft": text,
             "bt": rng.choice(np.array(BOOL_FORMS), n)}
    for k, v in texts.items():
        cols[k] = (_malformed_text(v, rng, 0.1), StringType)
    data = {k: np.ma.masked_array(v, mask=rng.random(n) < 0.1)
            for k, (v, _) in cols.items()}
    schema = Schema([StructField(k, t) for k, (_, t) in cols.items()])
    return TpuSession(device="cpu").from_numpy(data, schema).plan.table


def text_cast_cases(schema: Schema) -> list:
    """(name, Cast) of each route phase 8 (a) checks, over
    `text_cast_batch`'s columns."""
    numbers = ("i8", "i16", "i32", "i64", "f", "x")
    routes = ([("it", t) for t in (ByteType, ShortType, IntegerType,
                                   LongType, DoubleType)]
              + [("ft", t) for t in (FloatType, DoubleType, LongType)]
              + [("bt", BooleanType)]
              + [(c, StringType) for c in ("i8", "i16", "i32", "i64", "b")]
              + [(c, BooleanType) for c in numbers]
              + [("b", schema[schema.index_of(c)].dtype) for c in numbers])
    out = []
    for src, to in routes:
        i = schema.index_of(src)
        out.append((f"cast {src}:{schema[i].dtype.name} -> {to.name}",
                    Cast(BoundReference(i, schema[i].dtype, src), to)))
    return out


def check_text_casts(dev: torch.device) -> None:
    """Phase 8 (a): each route of `text_cast_cases` on the card against
    the CPU."""
    cpu = text_cast_batch(TEXT_CAST_ROWS)
    check_on_card("text_cast", cpu, text_cast_cases(cpu.schema), dev)


def _text_query(name: str, df_in, lineitem: dict) -> list:
    """One of tpch.TEXT_QUERIES over DataFrame `df_in` against its numpy
    oracle (`measure`), printed as a `text_query` line; q1_text must
    launch K3 (its order-by).  Returns the (kernel, shape) pairs it
    launched."""
    resident = torch.cuda.memory_allocated()
    got, df, numbers, launched = measure(
        lambda: tpch.TEXT_QUERIES[name](df_in))
    want, oracle_s = oracle_rows(name,
                                 lambda: tpch.ORACLES[name](lineitem))
    match = tpch.rows_match(want, got)
    plan = df.session.last_plan
    print("text_query " + json.dumps({
        "query": name, "rows": len(got), "matches_oracle": match,
        "oracle_s": oracle_s, "joins": join_nodes(plan),
        "agg_update_paths": _update_paths(plan),
        "resident_device_bytes": resident, **numbers, "result": got}),
        flush=True)
    if not match or not got:
        raise AssertionError(f"{name} disagrees with the numpy oracle or "
                             f"is empty: {got[:3]} vs {want[:3]}")
    if name == "q1_text" and not numbers["launches"]["sort_words"]:
        raise AssertionError(f"q1_text launched no K3: {numbers}")
    return launched


def run_text_queries(li_df, lineitem: dict, device: str = "cuda") -> list:
    """Phase 8 (b): each of tpch.TEXT_QUERIES on the card (`_text_query`):
    text_roundtrip over the resident `li_df`; q1_text over
    LINEITEM_TEXT's columns, made from `lineitem` on the host and copied
    to the card in a session of its own (castStringToFloat set) just
    before it runs, and dropped right after.  Returns the (kernel,
    shape) pairs they launched."""
    shapes = []
    for name in tpch.TEXT_QUERIES:
        if tpch.TEXT_INPUTS[name] == "lineitem":
            shapes += _text_query(name, li_df, lineitem)
            continue
        t0 = time.perf_counter()
        text_df = TpuSession(
            dict(CONF, **{CAST_STRING_TO_FLOAT.key: "true"}),
            device=device).from_numpy(tpch.text_lineitem(lineitem),
                                      tpch.LINEITEM_TEXT)
        torch.cuda.synchronize()
        print(f"text_queries: lineitem_text made and copied to the card "
              f"in {time.perf_counter() - t0:.3f} s", flush=True)
        shapes += _text_query(name, text_df, lineitem)
        del text_df  # its columns leave the card before the next query
        torch.cuda.empty_cache()
    return shapes


# phase 9 (a): the classes held bit for bit (the rest within MATH_REL)
MATH_EXACT = {"BitwiseAnd", "BitwiseOr", "BitwiseXor", "BitwiseNot",
              "ShiftLeft", "ShiftRight", "ShiftRightUnsigned", "Floor",
              "Ceil", "Rint", "Round", "BRound", "Signum", "Sqrt",
              "ToDegrees", "ToRadians", "Murmur3Hash"}
MATH_REL = 1e-13  # relative, where both sides are finite
# every special double against every other (x against x2), then edges:
# +-1e19, subnormals, a hair off +-1, x.5 boundaries of the round scales,
# where exp, cosh and sinh overflow
MATH_SPECIAL = [np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 0.5, -2.5,
                2.0, 5e-324]
MATH_EDGES = [1e19, -1e19, -2.5e-310, 1e-310, 2.2250738585072014e-308,
              np.nextafter(1.0, 2.0), np.nextafter(1.0, 0.0),
              -np.nextafter(1.0, 2.0), 2.5, -0.5, 0.125, 1.005, 2.675, 0.15,
              12345.5, 4503599627370495.5, 709.9, 710.0, -745.5, 1e308,
              1.7976931348623157e308, 8.0, -27.0, 1e-306, 1e-40]


def math_batch(n: int, seed: int = 42) -> ColumnarBatch:
    """The CPU batch of phase 9 (a): byte, short, int and long columns
    over their whole ranges, extremes first; two doubles pairing every
    special value with every other, then MATH_EDGES, then values on the
    x.5 boundaries of the round scales, uniform in +-50, a hair off +-1,
    subnormals and magnitudes 10^-30 to 10^30; their float; booleans; a
    date and a timestamp; shift counts of -70..70 (int), beyond the int
    range (long), a byte and a double with fractions, NaN and
    infinities; and text of 0 to 64 random bytes (>= 0x80 among them,
    so not UTF-8); 10% nulls in every column past the edge rows."""
    rng = np.random.default_rng(seed)
    cols = {}
    for name, dt, t in (("i8", np.int8, ByteType), ("i16", np.int16,
                                                     ShortType),
                        ("i32", np.int32, IntegerType),
                        ("i64", np.int64, LongType)):
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        v[:6] = [info.min, info.max, 0, -1, 1, info.min + 1]
        cols[name] = (v, t)
    k = len(MATH_SPECIAL) ** 2
    edge = k + len(MATH_EDGES)

    def doubles():
        pick = rng.random(n)
        half = ((rng.integers(-10 ** 6, 10 ** 6, n) + 0.5)
                / 10.0 ** rng.integers(0, 5, n))
        near_one = np.sign(pick - 0.5) * (1.0 + rng.integers(-8, 9, n)
                                          * 2.0 ** -52)
        return np.select(
            [pick < 0.25, pick < 0.5, pick < 0.55, pick < 0.6],
            [half, rng.uniform(-50, 50, n), near_one,
             rng.random(n) * 2.0 ** -1022],
            rng.normal(0, 1, n) * 10.0 ** rng.integers(-30, 30, n))
    x, x2 = doubles(), doubles()
    x[:k] = np.repeat(MATH_SPECIAL, len(MATH_SPECIAL))
    x2[:k] = np.tile(MATH_SPECIAL, len(MATH_SPECIAL))
    x[k:edge] = MATH_EDGES
    x2[k:edge] = MATH_EDGES[::-1]
    cols["x"], cols["x2"] = (x, DoubleType), (x2, DoubleType)
    with np.errstate(over="ignore"):
        cols["f"] = (x.astype(np.float32), FloatType)
    cols["b"] = (rng.random(n) < 0.5, BooleanType)
    cols["b2"] = (rng.random(n) < 0.5, BooleanType)
    cols["d"] = (rng.integers(-150_000, 150_000, n, dtype=np.int32),
                 DateType)
    cols["t"] = (rng.integers(-2 ** 62, 2 ** 62, n), TimestampType)
    cols["n"] = (rng.integers(-70, 71, n, dtype=np.int32), IntegerType)
    cols["nl"] = (rng.integers(-2 ** 63, 2 ** 63 - 1, n), LongType)
    cols["n8"] = (rng.integers(-128, 128, n, dtype=np.int8), ByteType)
    xc = rng.uniform(-70, 70, n)
    xc[:8] = [np.nan, np.inf, -np.inf, -1e-20, 32.0, 63.5, 1e19, -0.0]
    cols["xc"] = (xc, DoubleType)
    valid = {k: rng.random(n) >= 0.1 for k in list(cols) + ["s"]}
    for ok in valid.values():
        ok[:edge] = True
    data = {k: np.ma.masked_array(v, mask=~valid[k])
            for k, (v, _) in cols.items()}
    schema = Schema([StructField(k, t) for k, (_, t) in cols.items()])
    batch = TpuSession(device="cpu").from_numpy(data, schema).plan.table
    # text: random bytes, zero past each length and in null rows
    lens = rng.integers(0, 65, n).astype(np.int32)
    raw = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    raw[np.arange(64)[None, :] >= lens[:, None]] = 0
    raw[~valid["s"]], lens[~valid["s"]] = 0, 0
    text = Column(torch.from_numpy(raw), torch.from_numpy(valid["s"]),
                  StringType, torch.from_numpy(lens))
    return ColumnarBatch(list(batch.columns) + [text], batch.sel,
                         Schema(list(schema)
                                + [StructField("s", StringType)]))


def math_cases(schema: Schema) -> list:
    """(name, expression) of each case phase 9 (a) checks, over
    `math_batch`'s columns: every class of the bitwise, math and
    murmur3 families, murmur3 over each type alone and over all."""
    def c(name):
        i = schema.index_of(name)
        return BoundReference(i, schema[i].dtype, name)

    def lit(v):
        return Literal(v)
    cases = []
    for cls in (E.BitwiseAnd, E.BitwiseOr, E.BitwiseXor):
        cases += [(f"{cls.__name__}({a}, {b})", cls(c(a), c(b)))
                  for a, b in (("i32", "n"), ("i64", "nl"), ("i8", "i16"),
                               ("b", "b2"))]
    cases += [(f"BitwiseNot({a})", E.BitwiseNot(c(a)))
              for a in ("i8", "i16", "i32", "i64", "b")]
    for cls in (E.ShiftLeft, E.ShiftRight, E.ShiftRightUnsigned):
        cases += [(f"{cls.__name__}({a}, {b})", cls(c(a), c(b)))
                  for a, b in (("i8", "n"), ("i16", "n"), ("i32", "n"),
                               ("i64", "n"), ("i32", "nl"), ("i64", "xc"),
                               ("b", "n"))]
    for name, cls in M.MATH_EXPRESSIONS.items():
        if name in ("Round", "BRound"):
            cases += [(f"{name}({a}, {s})", cls(c(a), lit(s)))
                      for a, s in (("x", 0), ("x", 2), ("x", -2),
                                   ("x", 300), ("f", 1), ("i64", -3),
                                   ("i64", -19), ("i8", -2), ("t", -3))]
        elif issubclass(cls, E.BinaryExpression):
            cases += [(f"{name}({a}, {b})", cls(c(a), c(b)))
                      for a, b in (("x", "x2"), ("f", "i32"))]
        else:
            cases += [(f"{name}({a})", cls(c(a)))
                      for a in (("x", "f", "i64") if name in (
                          "Sqrt", "Floor", "Ceil") else ("x",))]
    cases += [(f"Murmur3Hash({a})", H.Murmur3Hash(c(a)))
              for a in ("i8", "i16", "i32", "i64", "d", "t", "b", "f", "x",
                        "s")]
    cases.append(("Murmur3Hash(all)", H.Murmur3Hash(
        *[c(f.name) for f in schema])))
    return cases


def _close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal NaN and infinite positions, and where both are finite,
    within MATH_REL of each other."""
    got = got.cpu()
    nan, fin = torch.isnan(want), torch.isfinite(want)
    if not (torch.equal(torch.isnan(got), nan)
            and torch.equal(torch.isfinite(got), fin)
            and torch.equal(got[~nan & ~fin], want[~nan & ~fin])):
        return False
    g, w = got[fin], want[fin]
    rel = (g - w).abs() / w.abs().clamp_min(torch.finfo(w.dtype).tiny)
    return not rel.numel() or float(rel.max()) <= MATH_REL


def check_math(dev: torch.device) -> None:
    """Phase 9 (a): each case of `math_cases` on the card against the
    CPU (`check_on_card`): MATH_EXACT's classes by their bits, the
    others within MATH_REL; null masks exact."""
    cpu = math_batch(MATH_ROWS)
    cases = math_cases(cpu.schema)
    check_on_card("math_expr", cpu, cases, dev, approx={
        name for name, e in cases if type(e).__name__ not in MATH_EXACT})


def run_math_queries(li_df, lineitem: dict) -> list:
    """Phase 9 (b): each of tpch.MATH_QUERIES over the resident lineitem
    against its numpy oracle (`measure`, `tpch.match_math_query`), with
    the numbers of a phase 3 `query` line; price_dispersion must launch
    K1, K2 and K3 (its 100,000 suppliers take the sort path).  Returns
    the (kernel, shape) pairs they launched."""
    shapes = []
    for name, query in tpch.MATH_QUERIES.items():
        resident = torch.cuda.memory_allocated()
        got, df, numbers, launched = measure(lambda query=query:
                                             query(li_df))
        shapes += launched
        want, oracle_s = oracle_rows(
            name, lambda: tpch.ORACLES[name](lineitem))
        match = tpch.match_math_query(name, want, got)
        plan = df.session.last_plan
        print("math_query " + json.dumps({
            "query": name, "rows": len(got), "matches_oracle": match,
            "oracle_s": oracle_s, "joins": join_nodes(plan),
            "agg_update_paths": _update_paths(plan),
            "resident_device_bytes": resident, **numbers,
            "result": got[:8]}), flush=True)
        if not match or not got:
            raise AssertionError(f"{name} disagrees with the numpy oracle "
                                 f"or is empty: {got[:3]} vs {want[:3]}")
        if name == "price_dispersion" \
                and not all(numbers["launches"].values()):
            raise AssertionError(f"price_dispersion did not launch every "
                                 f"kernel: {numbers['launches']}")
    return shapes


def agg_table(n: int, seed: int = 42) -> tuple:
    """Phase 10 (a)'s columns (numpy, nulls masked) and schema: int keys
    of ~1000 (`k1k`) and ~2^18 (`k256k`) groups, never null; int, long
    and date values; doubles with NaN and +-0.0; text of 0-64 bytes over
    a, b and c, a third of it after a shared prefix of 8, 24 or 40 a's.
    About 10% of every value is null."""
    rng = np.random.default_rng([seed, 10])
    text = rng.choice(np.frombuffer(b"abc", np.uint8), (n, 64))
    prefix = rng.choice([0, 0, 0, 8, 24, 40], n)
    text[np.arange(64)[None, :] < prefix[:, None]] = ord("a")
    length = rng.integers(0, 65, n)
    text[np.arange(64)[None, :] >= length[:, None]] = 0
    cols = {"k1k": rng.integers(0, 1000, n, dtype=np.int32),
            "k256k": rng.integers(0, 1 << 18, n, dtype=np.int32),
            "i": rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32),
            "l": rng.integers(-(1 << 62), 1 << 62, n),
            "d": rng.integers(-200_000, 200_000, n, dtype=np.int32),
            "x": rng.choice([np.nan, 0.0, -0.0, 1.5, -2.25], n)
            * np.where(rng.random(n) < 0.5, 1.0, rng.random(n) * 100),
            "s": tpch._as_bytes(text)}
    for c in ("i", "l", "d", "x", "s"):
        cols[c] = np.ma.masked_array(cols[c], mask=rng.random(n) < 0.1)
    types = {"k1k": IntegerType, "k256k": IntegerType, "i": IntegerType,
             "l": LongType, "d": DateType, "x": DoubleType, "s": StringType}
    return cols, Schema([StructField(c, types[c]) for c in cols])


def agg_cases() -> list:
    """(name, query over phase 10 (a)'s DataFrame, the output columns held
    within SUM_REL_TOL): First and Last of every value type, count, sum
    and average distinct, and string Min/Max, grouped by either key and
    global."""
    keys = {"k1k": "k1k", "k256k": "k256k", "global": None}

    def by(key, aggs):
        def q(df):
            if key is None:
                return df.agg(*aggs())
            return df.group_by(col(key)).agg(*aggs()).order_by(key)
        return q

    def first_last():
        return [f(col(c)).alias(f"{f.__name__}_{c}")
                for c in ("i", "l", "d", "x", "s")
                for f in (F.first, F.last)]

    def distinct(v):
        def aggs():
            out = [F.count_distinct(col(v)).alias("count_distinct"),
                   F.count(col(v)).alias("count")]
            if v in ("i", "l", "x"):
                out += [F._agg("Sum", col(v), True).alias("sum_distinct"),
                        F._agg("Average", col(v), True)
                        .alias("avg_distinct")]
            return out
        return aggs

    def bounds():
        return [F.min(col("s")).alias("min_s"),
                F.max(col("s")).alias("max_s"),
                F.count(col("s")).alias("count_s")]
    cases = [(f"first_last/{k}", by(key, first_last), ())
             for k, key in keys.items()]
    cases += [(f"distinct_{v}/k1k", by("k1k", distinct(v)),
               ("sum_distinct", "avg_distinct") if v == "x"
               else ("avg_distinct",)) for v in ("i", "l", "x", "d", "s")]
    cases += [("distinct_i/k256k", by("k256k", distinct("i")),
               ("avg_distinct",)),
              ("distinct_i/global", by(None, distinct("i")),
               ("avg_distinct",)),
              ("distinct_x/global", by(None, distinct("x")),
               ("sum_distinct", "avg_distinct"))]
    cases += [(f"string_bounds/{k}", by(key, bounds), ())
              for k, key in keys.items()]
    return cases


def _rows_agree(want: list, got: list, names: list, approx) -> bool:
    """Rows equal in order: exact (any NaN equal to any NaN), the columns
    named in `approx` within SUM_REL_TOL of float64."""
    if len(want) != len(got):
        return False
    tol = SUM_REL_TOL[torch.float64]
    for w, g in zip(want, got):
        for name, a, b in zip(names, w, g):
            if isinstance(a, float) and isinstance(b, float):
                if math.isnan(a) and math.isnan(b):
                    continue
                if name in approx and math.isclose(a, b, rel_tol=tol,
                                                   abs_tol=tol):
                    continue
            if a != b:
                return False
    return True


def check_agg_functions(device: str = "cuda") -> list:
    """Phase 10 (a): each of `agg_cases` through a TpuSession on the card
    and one on the CPU over agg_table(AGG_ROWS), read in batches of
    AGG_BATCH_ROWS (the merge runs; a distinct aggregate's input is
    coalesced into one batch); one `agg_fn` line each, with its time on
    the card.  Returns the (kernel, shape) pairs the card launched."""
    cols, schema = agg_table(AGG_ROWS)
    conf = dict(CONF, **{"spark.rapids.sql.reader.batchSizeRows":
                         str(AGG_BATCH_ROWS)})
    card = TpuSession(dict(conf), device=device).from_numpy(cols, schema)
    cpu = TpuSession(dict(conf), device="cpu").from_numpy(cols, schema)
    shapes = []
    for name, q, approx in agg_cases():
        K.reset_launches()
        got = q(card).collect()
        launches = K.launch_counts()
        shapes += launched_shapes()
        paths = _update_paths(card.session.last_plan)
        want = q(cpu).collect()
        ok = _rows_agree(want, got, q(cpu).schema.names, approx)
        print("agg_fn " + json.dumps({
            "case": name, "rows": len(got), "matches_cpu": ok,
            # to numpy columns: Python rows of 2^18 groups take seconds
            "ms": time_ms(lambda: q(card).to_pydict(), 3),
            "launches": launches, "agg_update_paths": paths}), flush=True)
        if not ok or not got:
            raise AssertionError(f"{name} on the card differs from the CPU "
                                 f"or is empty: {got[:2]} vs {want[:2]}")
    return shapes


def run_agg_queries(dfs: dict, tables: dict, rows: dict) -> list:
    """Phase 10 (b): each of tpch.AGG_QUERIES over the resident tables
    (`measure`), with the numbers of a phase 3 `query` line and the
    update paths: q16_distinct and q21_distinct held to the rows phase 3
    gave q16 and q21 (checked there against their oracles), the others
    to their numpy oracles; q21_distinct must launch K1, K2 and K3.
    Returns the (kernel, shape) pairs they launched."""
    shapes = []
    for name, query in tpch.AGG_QUERIES.items():
        resident = torch.cuda.memory_allocated()
        got, df, numbers, launched = measure(lambda query=query:
                                             query(dfs))
        shapes += launched
        base = name.split("_")[0] if name.endswith("_distinct") else None
        want, oracle_s = (rows[base], 0.0) if base else oracle_rows(
            name, lambda: tpch.ORACLES[name](tables))
        match = tpch.match_agg_query(name, want, got)
        plan = df.session.last_plan
        print("agg_query " + json.dumps({
            "query": name, "rows": len(got), "matches_oracle": match,
            "held_to": base or "oracle", "oracle_s": oracle_s,
            "joins": join_nodes(plan),
            "agg_update_paths": _update_paths(plan),
            "resident_device_bytes": resident, **numbers,
            "result": [[str(v) for v in r] for r in got[:4]]}), flush=True)
        if not match or not got:
            raise AssertionError(f"{name} disagrees with "
                                 f"{base or 'its numpy oracle'} or is "
                                 f"empty: {got[:3]} vs {want[:3]}")
        if name == "q21_distinct" and not all(numbers["launches"].values()):
            raise AssertionError(f"q21_distinct did not launch every "
                                 f"kernel: {numbers['launches']}")
    return shapes


def set_table(n: int, seed: int = 42) -> tuple:
    """Phase 11 (a)'s columns (numpy, nulls masked) and schema:
    `agg_table`'s, then keys of few values, each about 10% null: `g` an
    int of 16, `b` a boolean, `t` text of 0-4 bytes over 6 words, `ls` a
    long of 3, `xs` a double of NaN, +-0.0, 1.5, -2.25 and inf, `ds` a
    date of 5 days."""
    cols, schema = agg_table(n, seed)
    rng = np.random.default_rng([seed, 11])
    words = np.array([b"", b"a", b"b", b"ab", b"AIR", b"\xe2\x82\xacu"])
    extra = {"g": (rng.integers(0, 16, n, dtype=np.int32), IntegerType),
             "b": (rng.random(n) < 0.5, BooleanType),
             "t": (words[rng.integers(0, len(words), n)], StringType),
             "ls": (rng.integers(-1, 2, n) * (1 << 40), LongType),
             "xs": (rng.choice([np.nan, 0.0, -0.0, 1.5, -2.25, np.inf], n),
                    DoubleType),
             "ds": (rng.integers(10_000, 10_005, n, dtype=np.int32),
                    DateType)}
    fields = list(schema.fields)
    for name, (v, dtype) in extra.items():
        cols[name] = np.ma.masked_array(v, mask=rng.random(n) < 0.1)
        fields.append(StructField(name, dtype))
    return cols, Schema(fields)


def narrow_table(cols: dict, n: int) -> dict:
    """The first n rows of set_table's columns, `s` cut to 8 bytes: a
    union child whose text column is 8 bytes wide against 64."""
    out = {c: v[:n] for c, v in cols.items()}
    out["s"] = np.ma.masked_array(out["s"].data.astype("S8"),
                                  mask=np.ma.getmaskarray(out["s"]))
    return out


def set_cases() -> list:
    """(name, query over phase 11 (a)'s DataFrame and its narrow twin,
    the output columns held within SUM_REL_TOL).  Each orders its rows
    by its keys and a count (and a sum where a data null and a rolled-up
    null could still tie), so both sessions' rows come in one order."""
    lit = F.lit

    def union_grouped(df, nw):
        u = df.select(col("k1k"), col("s"), col("i")).union(
            nw.select(col("k1k"), col("s"), col("i")))
        return u.group_by(col("k1k")).agg(
            F.count(lit(1)).alias("n"), F.count(col("s")).alias("ns"),
            F.first(col("s")).alias("first_s"),
            F.last(col("s")).alias("last_s"),
            F.sum(col("i")).alias("si")).order_by("k1k")

    def union_distinct(df, nw):
        keys = ("g", "t", "b")
        return df.select(*keys).union(nw.select(*keys)).distinct() \
            .order_by(*keys)

    def distinct_types(df, nw):
        keys = ("g", "ls", "xs", "ds", "b", "t")
        return df.select(*keys).distinct().order_by(*keys)

    def rollup_null_key(df, nw):
        return df.rollup(col("g"), col("t")).agg(
            F.count(lit(1)).alias("n"), F.sum(col("i")).alias("si"),
            F.sum(col("l")).alias("sl"), F.max(col("d")).alias("max_d")) \
            .order_by("g", "t", "n", "si")

    def cube3(df, nw):
        return df.cube(col("g"), col("b"), col("t")).agg(
            F.count(lit(1)).alias("n"), F.sum(col("i")).alias("si"),
            F.min(col("xs")).alias("min_xs")) \
            .order_by("g", "b", "t", "n", "si")

    def rollup_compound(df, nw):
        return df.rollup(col("g"), col("b")).agg(
            (F.sum(col("i")) / F.count(col("i"))).alias("mean_i"),
            F.sum(col("g")).alias("sg"), F.count(lit(1)).alias("n")) \
            .order_by("g", "b", "n", "sg")

    def rollup_first_last(df, nw):
        return df.rollup(col("g"), col("b")).agg(
            F.first(col("i")).alias("first_i"),
            F.last(col("s")).alias("last_s"),
            F.count_distinct(col("t")).alias("texts"),
            F.count(lit(1)).alias("n")).order_by("g", "b", "n")
    return [("union_grouped", union_grouped, ()),
            ("union_distinct", union_distinct, ()),
            ("distinct_types", distinct_types, ()),
            ("rollup_null_key", rollup_null_key, ()),
            ("cube3", cube3, ()),
            ("rollup_compound", rollup_compound, ("mean_i",)),
            ("rollup_first_last", rollup_first_last, ())]


def check_set_ops(device: str = "cuda") -> list:
    """Phase 11 (a): each of `set_cases` through a TpuSession on the card
    and one on the CPU over set_table(SET_ROWS) and its narrow twin of a
    quarter of the rows, read in batches of SET_BATCH_ROWS; one `set_op`
    line each, with its time on the card.  Returns the (kernel, shape)
    pairs the card launched."""
    cols, schema = set_table(SET_ROWS)
    nw = narrow_table(cols, SET_ROWS // 4)
    conf = dict(CONF, **{"spark.rapids.sql.reader.batchSizeRows":
                         str(SET_BATCH_ROWS)})
    frames = {}
    for dev in (device, "cpu"):
        s = TpuSession(dict(conf), device=dev)
        frames[dev] = (s.from_numpy(cols, schema), s.from_numpy(nw, schema))
    shapes = []
    for name, q, approx in set_cases():
        K.reset_launches()
        got = q(*frames[device]).collect()
        launches = K.launch_counts()
        shapes += launched_shapes()
        plan = frames[device][0].session.last_plan
        want = q(*frames["cpu"]).collect()
        ok = _rows_agree(want, got, q(*frames["cpu"]).schema.names, approx)
        print("set_op " + json.dumps({
            "case": name, "rows": len(got), "matches_cpu": ok,
            "ms": time_ms(lambda: q(*frames[device]).to_pydict(), 3),
            "launches": launches, "agg_update_paths": _update_paths(plan),
            "expand_projections": _expand_projections(plan)}), flush=True)
        if not ok or not got:
            raise AssertionError(f"{name} on the card differs from the CPU "
                                 f"or is empty: {got[:2]} vs {want[:2]}")
    return shapes


def run_set_queries(dfs: dict, tables: dict) -> list:
    """Phase 11 (b): each of tpch.SET_QUERIES over the resident tables
    (`measure`), held to its numpy oracle, with the numbers of a phase 3
    `query` line, the update paths and the Expand's projections; each
    query of SET_LAUNCHES must launch its kernels.  Returns the (kernel,
    shape) pairs they launched."""
    shapes = []
    for name, query in tpch.SET_QUERIES.items():
        resident = torch.cuda.memory_allocated()
        got, df, numbers, launched = measure(lambda query=query:
                                             query(dfs))
        shapes += launched
        want, oracle_s = oracle_rows(name,
                                     lambda: tpch.ORACLES[name](tables))
        match = tpch.match_set_query(name, want, got)
        plan = df.session.last_plan
        print("set_query " + json.dumps({
            "query": name, "rows": len(got), "matches_oracle": match,
            "oracle_s": oracle_s, "joins": join_nodes(plan),
            "agg_update_paths": _update_paths(plan),
            "expand_projections": _expand_projections(plan),
            "resident_device_bytes": resident, **numbers,
            "result": [[str(v) for v in r] for r in got[:4]]}), flush=True)
        if not match or not got:
            raise AssertionError(f"{name} disagrees with its numpy oracle "
                                 f"or is empty: {got[:3]} vs {want[:3]}")
        idle = [k for k in SET_LAUNCHES.get(name, ())
                if not numbers["launches"][k]]
        if idle:
            raise AssertionError(f"{name} did not launch {idle}: "
                                 f"{numbers['launches']}")
    return shapes


def window_table(n: int, seed: int = 42) -> tuple:
    """Phase 12 (a)'s columns (numpy, nulls masked) and schema: `k` a
    partition key of 4096 values (~256 rows each), `o` a unique order
    key, `g` an order key of 8 values (ties), values of every type with
    their edges (`i` int and `l` long extremes; `x` double and `f` float
    with NaN, +-0.0 and +-inf; `d` dates; `s` text of 0-16 bytes, empty
    and multi-byte among it; `b` booleans), `keep` a filter.  About 5%
    of k, g and every value is null."""
    rng = np.random.default_rng([seed, 12])

    def edged(values, edges):
        pick = rng.random(n) < 0.05
        values[pick] = rng.choice(np.asarray(edges, values.dtype),
                                  int(pick.sum()))
        return values
    special = [np.nan, 0.0, -0.0, np.inf, -np.inf]
    words = np.array([b"", b"a", b"ab", b"abcdefghi", b"\xc3\xa9",
                      b"\xe2\x82\xac", b"zz", b"b" * 16,
                      b"\xe4\xb8\xad\xe6\x96\x87"])
    cols = {"k": rng.integers(0, 4096, n, dtype=np.int32),
            "o": rng.permutation(n).astype(np.int64),
            "g": rng.integers(0, 8, n, dtype=np.int32),
            "i": edged(rng.integers(-1000, 1000, n, dtype=np.int32),
                       [0, -1, (1 << 31) - 1, -(1 << 31)]),
            "l": edged(rng.integers(-10**6, 10**6, n),
                       [0, -1, (1 << 63) - 1, -(1 << 63)]),
            "x": edged(np.round(rng.uniform(-1e3, 1e3, n), 3), special),
            "f": edged(np.round(rng.uniform(-1e3, 1e3, n), 2)
                       .astype(np.float32), special),
            "d": rng.integers(10_000, 10_400, n, dtype=np.int32),
            "s": words[rng.integers(0, len(words), n)],
            "b": rng.random(n) < 0.5,
            "keep": rng.random(n) < 0.9}
    types = {"k": IntegerType, "o": LongType, "g": IntegerType,
             "i": IntegerType, "l": LongType, "x": DoubleType,
             "f": FloatType, "d": DateType, "s": StringType,
             "b": BooleanType, "keep": BooleanType}
    for c in cols:
        if c not in ("o", "keep"):
            cols[c] = np.ma.masked_array(cols[c], mask=rng.random(n) < 0.05)
    return cols, Schema([StructField(c, types[c]) for c in cols])


def window_columns(frame: str) -> list:
    """(name, window expression) of every function a frame kind takes,
    over every type that function takes: count, sum and average, min and
    max (text only where the frame starts at the partition's start),
    first and last, and with an ORDER BY the ranks, lag and lead."""
    order, rows = WINDOW_FRAMES[frame]
    w = Window.partition_by(col("k"))
    if order:
        w = w.order_by(*[col(c) for c in order])
    if rows:
        w = w.rows_between(*rows)
    out = [("n", F.count(F.lit(1)).over(w)),
           ("nx", F.count(col("x")).over(w)),
           ("ns", F.count(col("s")).over(w))]
    out += [(f"sum_{c}", F.sum(col(c)).over(w)) for c in "ilxf"]
    out += [(f"avg_{c}", F.avg(col(c)).over(w)) for c in "ixf"]
    minmax = "ilxfdb" + ("s" if rows is None or rows[0] < -(1 << 61)
                         else "")
    out += [(f"{fn.__name__}_{c}", fn(col(c)).over(w))
            for c in minmax for fn in (F.min, F.max)]
    out += [(f"{fn.__name__}_{c}", fn(col(c)).over(w))
            for c in "xsdb" for fn in (F.first, F.last)]
    if order:
        out += [("rn", F.row_number().over(w)), ("rk", F.rank().over(w)),
                ("drk", F.dense_rank().over(w)),
                ("lag_i", F.lag(col("i"), 1).over(w)),
                ("lag_x", F.lag(col("x"), 2, -1.5).over(w)),
                ("lead_s", F.lead(col("s"), 1, "past the last row")
                 .over(w)),
                ("lead_d", F.lead(col("d"), 3).over(w)),
                ("lag_b", F.lag(col("b"), 1, True).over(w))]
    return out


def window_query(frame: str):
    """Phase 12 (a)'s query of one frame kind over the kept rows: the
    keys, every function, and per partition the sum of the finite |x|
    and |f| (`floor_x`, `floor_f`), which bound a float sum's rounding
    (check_windows)."""
    def finite_abs(c):
        return F.when(F.abs(col(c)) < 1e308, F.abs(col(c))).otherwise(0.0)
    part = Window.partition_by(col("k"))

    def q(df):
        return df.filter(col("keep")).select(
            col("k"), col("o"),
            *[e.alias(n) for n, e in window_columns(frame)],
            F.sum(finite_abs("x")).over(part).alias("floor_x"),
            F.sum(finite_abs("f")).over(part).alias("floor_f"))
    return q


def window_result(df) -> dict:
    """The live rows of a DataFrame's device result, column name ->
    (data, valid, lengths or None) on the host, read from the batch the
    plan leaves on its device (no text decode: a 2^20-row result carries
    five text columns)."""
    ctx = ExecContext(df.session.conf, df.session.device)
    (batch,) = list(df.physical_plan().execute(ctx))
    rows = batch.live_rows()
    return {f.name: (c.data[rows].cpu(), c.valid[rows].cpu(),
                     None if c.lengths is None else c.lengths[rows].cpu())
            for f, c in zip(batch.schema, batch.columns)}


def windows_disagree(want: dict, got: dict) -> list:
    """The columns of two window_result dicts that differ: valid flags
    equal, and on the valid rows the values exactly equal (NaN equal to
    NaN; text by its length and the bytes within it), a float within
    SUM_REL_TOL of float64 of its value plus 1e-12 times the partition's
    sum of finite |x| or |f|, whichever is larger: a frame's sum is a
    difference of two running sums, so it carries its whole segment's
    rounding."""
    floor = 1e-12 * torch.maximum(want["floor_x"][0], want["floor_f"][0])
    bad = []
    for name, (wd, wv, wl) in want.items():
        gd, gv, gl = got[name]
        if not torch.equal(wv, gv) or wd.shape[1:] != gd.shape[1:]:
            bad.append(name)
            continue
        if wl is not None:
            inside = torch.arange(wd.shape[1])[None, :] < wl[:, None]
            ok = (wl == gl) & torch.all((wd == gd) | ~inside, dim=1)
        elif wd.is_floating_point():
            wd, gd = wd.double(), gd.double()
            ok = (torch.isnan(wd) & torch.isnan(gd)) | (wd == gd) | (
                (wd - gd).abs() <= SUM_REL_TOL[torch.float64] * wd.abs()
                + floor)
        else:
            ok = wd == gd
        if not bool(torch.all(ok | ~wv)):
            bad.append(name)
    return bad


def check_windows(device: str = "cuda") -> list:
    """Phase 12 (a): each frame kind's `window_query` through a TpuSession
    on the card and one on the CPU over window_table(WINDOW_ROWS), read
    in batches of WINDOW_BATCH_ROWS (the window's coalesce concatenates
    them), every column held by windows_disagree; one `window_fn` line
    each, with the card's time from the scan to the result's device
    batch.  Returns the (kernel, shape) pairs the card launched."""
    cols, schema = window_table(WINDOW_ROWS)
    conf = dict(CONF, **{"spark.rapids.sql.reader.batchSizeRows":
                         str(WINDOW_BATCH_ROWS)})
    frames = {dev: TpuSession(dict(conf), device=dev)
              .from_numpy(cols, schema) for dev in (device, "cpu")}
    shapes = []
    for frame in WINDOW_FRAMES:
        q = window_query(frame)
        K.reset_launches()
        got = window_result(q(frames[device]))
        launches = K.launch_counts()
        shapes += launched_shapes()
        want = window_result(q(frames["cpu"]))
        bad = windows_disagree(want, got)
        print("window_fn " + json.dumps({
            "frame": frame, "rows": len(got["k"][0]), "columns": len(got),
            "matches_cpu": not bad, "disagree": bad,
            "ms": time_ms(lambda: list(q(frames[device]).physical_plan()
                                       .execute(ExecContext(
                                           frames[device].session.conf,
                                           frames[device].session.device))),
                          3),
            "launches": launches}), flush=True)
        if bad or not len(got["k"][0]):
            raise AssertionError(f"window frame {frame}: columns {bad} on "
                                 "the card differ from the CPU")
    return shapes


def _window_nodes(node) -> list:
    """Each window exec of the plan, depth first: its functions, and its
    partition and order key counts."""
    out = []
    if type(node).__name__ == "TpuWindowExec":
        out.append({"funcs": [f.kind for f in node.funcs],
                    "partition_by": len(node.part_exprs),
                    "order_by": len(node.order_exprs)})
    for c in node.children:
        out += _window_nodes(c)
    return out


def run_window_queries(dfs: dict, tables: dict) -> list:
    """Phase 12 (b): each of tpch.WINDOW_QUERIES over the resident tables
    (`measure`), held to its numpy oracle, with the numbers of a phase 3
    `query` line and the plan's window execs; each query of
    WINDOW_LAUNCHES must launch its kernels.  Returns the (kernel, shape)
    pairs they launched."""
    shapes = []
    for name, query in tpch.WINDOW_QUERIES.items():
        resident = torch.cuda.memory_allocated()
        got, df, numbers, launched = measure(lambda query=query:
                                             query(dfs))
        shapes += launched
        want, oracle_s = oracle_rows(name,
                                     lambda: tpch.ORACLES[name](tables))
        match = tpch.match_window_query(name, want, got)
        plan = df.session.last_plan
        print("window_query " + json.dumps({
            "query": name, "rows": len(got), "matches_oracle": match,
            "oracle_s": oracle_s, "joins": join_nodes(plan),
            "windows": _window_nodes(plan),
            "agg_update_paths": _update_paths(plan),
            "resident_device_bytes": resident, **numbers,
            "result": [[str(v) for v in r] for r in got[:4]]}), flush=True)
        if not match or not got:
            raise AssertionError(f"{name} disagrees with its numpy oracle "
                                 f"or is empty: {got[:3]} vs {want[:3]}")
        idle = [k for k in WINDOW_LAUNCHES.get(name, ())
                if not numbers["launches"][k]]
        if idle:
            raise AssertionError(f"{name} did not launch {idle}: "
                                 f"{numbers['launches']}")
    return shapes


def shape_launches(before: list = ()) -> list:
    """[kernel, shape, launches] of every kernel shape launched since the
    last reset, less the launches in `before` (an earlier reading)."""
    seen = {(k, tuple(sh)): c for k, sh, c in before}
    out = []
    for k in K.KERNELS:
        for shape, c in sorted(k.shapes.items(), key=str):
            shape = [str(x) for x in shape]
            c -= seen.get((k.__name__, tuple(shape)), 0)
            if c:
                out.append([k.__name__, shape, c])
    return out


def launched_shapes() -> list:
    """(kernel name, shape) of every shape launched since the last reset,
    the longest first."""
    return [(k.__name__, shape) for k in K.KERNELS
            for shape in sorted(k.shapes, key=lambda s: (-s[0], str(s)))]


def measure(q) -> tuple:
    """One DataFrame `q()` on the card: its first run between a
    launch-count reset and a read, then the warm median of REPS and one
    profiled run.  Returns (the first run's rows and DataFrame, the
    numbers to print, the (kernel, shape) pairs the first run
    launched)."""
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    df = q()
    got = df.collect()
    ms = (time.perf_counter() - t0) * 1e3
    launches = K.launch_counts()
    shapes = shape_launches()
    launched = launched_shapes()
    peak = torch.cuda.max_memory_allocated()
    warm = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        q().collect()
        warm.append((time.perf_counter() - t0) * 1e3)
    return got, df, {"first_ms": ms, "warm_ms": warm,
                     "warm_median_ms": statistics.median(warm),
                     "launches": launches, "shape_launches": shapes,
                     "peak_device_bytes": peak,
                     "profile": profile_query(q)}, launched


def run_string_filters(orders_df, orders: dict) -> list:
    """Each string filter over o_comment on the card against its numpy
    oracle (`measure`); returns the (kernel, shape) pairs they
    launched."""
    shapes = []
    for name in tpch.STRING_FILTERS:
        got, _, numbers, launched = measure(
            lambda name=name: tpch.string_filter(orders_df, name))
        shapes += launched
        want = oracle_rows(f"filter {name}", lambda: (
            tpch.oracle_string_filter(orders, name)))[0]
        print("filter " + json.dumps({"filter": name, "count": got,
                                      "oracle": want, **numbers}),
              flush=True)
        if got != want:
            raise AssertionError(f"string filter {name}: {got} against the "
                                 f"numpy oracle's {want}")
    return shapes


def run_outer_joins(dfs: dict, tables: dict) -> list:
    """Each outer join of tpch.OUTER_JOINS on the card against its numpy
    oracle (`measure`), with its join execs; each build must launch K3.
    Returns the (kernel, shape) pairs they launched."""
    shapes = []
    for name, (query, oracle) in tpch.OUTER_JOINS.items():
        got, df, numbers, launched = measure(lambda query=query: query(dfs))
        shapes += launched
        joins = join_nodes(df.session.last_plan)
        want = oracle_rows(f"outer_join {name}",
                           lambda: oracle(tables))[0]
        print("outer_join " + json.dumps({
            "join": name, "counts": got, "oracle": want, "joins": joins,
            **numbers}), flush=True)
        if not tpch.rows_match(want, got):
            raise AssertionError(f"outer join {name}: {got} against the "
                                 f"numpy oracle's {want}")
        if not joins or not all(j["build_k3_launches"] for j in joins) \
                or not numbers["launches"]["sort_words"]:
            raise AssertionError(f"outer join {name}: a build that "
                                 f"launched no K3: {joins} {numbers}")
    return shapes


def join_nodes(node, swapped: bool = False) -> list:
    """The plan's join execs: class, type, the columns of the side it
    builds, whether that side is broadcast, and whether the sides were
    swapped (the logical left child is built)."""
    out = []
    if isinstance(node, TpuHashJoinExec):
        out.append({"exec": type(node).__name__, "type": node.join_type,
                    "build": node.children[1].schema.names,
                    "broadcast": isinstance(node, TpuBroadcastHashJoinExec),
                    "swapped": swapped,
                    "build_k3_launches": node.build_sorts})
    for c in node.children:
        out += join_nodes(c, isinstance(node, TpuReorderColumnsExec))
    return out


def profile_query(q, top: int = 8) -> dict:
    """One more warm run under torch.profiler: the wall time, the summed
    device time of its kernels (busy share = device / wall) and the
    kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        q().collect()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [{"kernel": e.key[:90], "calls": e.count,
                     "ms": e.self_device_time_total / 1e3}
                    for e in kernels[:top]]}


def _expand_projections(node) -> list:
    """The projection count of every Expand in the plan, depth first."""
    out = [len(node.projections)] if type(node).__name__ == \
        "TpuExpandExec" else []
    for c in node.children:
        out += _expand_projections(c)
    return out


def _update_paths(node) -> list:
    """The update paths of every aggregate in the plan, depth first."""
    out = [dict(node.update_paths)] \
        if isinstance(node, TpuHashAggregateExec) else []
    for c in node.children:
        out += _update_paths(c)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    # (phase, when it ended), for the phase_seconds line
    ends = [("start", time.perf_counter())]
    card = card_line()
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(f"build: {K.build():.3f} s ({', '.join(K.built_libraries())})",
          flush=True)

    t0 = time.perf_counter()
    tables = tpch.generate(SF)
    cap = bucket_rows(len(tables["lineitem"]["l_orderkey"]))
    print(f"tables: sf={SF}, generated on the host in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    ends.append(("build and tables", time.perf_counter()))
    ORACLE_ROWS.update(precompute_oracles(tables))
    print(f"oracles: {len(ORACLE_ROWS)} computed by {ORACLE_WORKERS} "
          f"processes in {time.perf_counter() - ends[-1][1]:.3f} s, "
          f"{sum(t for _, t in ORACLE_ROWS.values()):.3f} s of theirs",
          flush=True)
    ends.append(("numpy oracles", time.perf_counter()))

    gen = torch.Generator(device="cuda").manual_seed(42)
    dev = torch.device("cuda")
    report = {}
    checked = phase2_shapes(cap)
    check_kernels(gen, dev, checked, report)
    torch.cuda.empty_cache()
    ends.append(("kernels", time.perf_counter()))
    launches, shapes, dfs, rows = run_queries(tables)
    ends.append(("queries", time.perf_counter()))
    shapes += run_string_filters(dfs["orders"], tables["orders"])
    shapes += run_outer_joins(dfs, tables)
    torch.cuda.empty_cache()
    print("sparsity " + json.dumps(partsupp_sparsity(tables)), flush=True)
    ends.append(("filters, outer joins and sparsity", time.perf_counter()))
    check_date_parts(dev)
    ends.append(("date parts", time.perf_counter()))
    check_date_arith(dev)
    shapes += run_date_queries(dfs["lineitem"], tables["lineitem"])
    torch.cuda.empty_cache()
    ends.append(("date arithmetic and casts", time.perf_counter()))
    check_text_casts(dev)
    shapes += run_text_queries(dfs["lineitem"], tables["lineitem"])
    torch.cuda.empty_cache()
    ends.append(("text casts", time.perf_counter()))
    check_math(dev)
    shapes += run_math_queries(dfs["lineitem"], tables["lineitem"])
    torch.cuda.empty_cache()
    ends.append(("math, bitwise and hash", time.perf_counter()))
    shapes += check_agg_functions()
    shapes += run_agg_queries(dfs, tables, rows)
    torch.cuda.empty_cache()
    ends.append(("first, last, distinct and string bounds",
                 time.perf_counter()))
    shapes += check_set_ops()
    shapes += run_set_queries(dfs, tables)
    torch.cuda.empty_cache()
    ends.append(("union, distinct, rollup and cube", time.perf_counter()))
    shapes += check_windows()
    shapes += run_window_queries(dfs, tables)
    del dfs
    torch.cuda.empty_cache()
    ends.append(("window functions", time.perf_counter()))
    shapes = list(dict.fromkeys(shapes))
    rest = [ks for ks in shapes if ks not in checked]
    print(f"kernels: {len(shapes) - len(rest)} of the {len(shapes)} shapes "
          f"launched by the queries, filters, outer joins, date, text, "
          f"math, aggregate, set and window queries were checked in phase "
          f"2; "
          f"checking "
          f"the other "
          f"{len(rest)}", flush=True)
    check_kernels(gen, dev, rest, report)
    ends.append(("launched shapes", time.perf_counter()))
    print("phase_seconds " + json.dumps(
        {name: t - before for (_, before), (name, t) in zip(ends, ends[1:])}),
        flush=True)

    kernels = []
    for k in K.KERNELS:
        row = report[k.__name__]
        kernels.append({"name": k.__name__, "route": "cuda",
                        "source": k.source, "replaces": k.replaces,
                        "launches": launches[k.__name__],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": "bytes",
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
