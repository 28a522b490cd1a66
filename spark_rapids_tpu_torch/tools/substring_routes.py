"""Time Substring's two routes on the same filters over the TPC-H tables.

Substring (ops/strings.py) slices the byte matrix when its position is a
non-negative literal and gathers with a capacity x max_len index
otherwise.  This runs each filter twice, once with a literal position
(the slice) and once with the same position as an expression that is
not a literal, `coalesce(lit(1))` (the gather), checks that both counts
agree, and prints for each its warm median of 5 and its peak device
bytes above the resident tables, then the card's name and power limit:

    python3 -m spark_rapids_tpu_torch.tools.substring_routes [--sf 10]
"""
import argparse
import json
import statistics
import subprocess
import time

import torch

from .. import TpuSession, tpch
from ..plan.logical import col, functions as F, lit

REPS = 5


def _filters(dfs: dict) -> dict:
    """(filter, route) -> a function counting the rows that pass."""
    out = {}
    for route, one in (("slice", 1), ("gather", F.coalesce(lit(1)))):
        out[("o_comment substr(1, 7) == 'special'", route)] = (
            lambda one=one: dfs["orders"].filter(
                col("o_comment").substr(one, 7) == "special"))
        out[("c_phone substr(1, 2) in Q22_CODES", route)] = (
            lambda one=one: dfs["customer"].filter(
                col("c_phone").substr(one, 2).isin(*tpch.Q22_CODES)))
    return {k: (lambda q=q: q().agg(F.count(lit(1)).alias("n")).collect())
            for k, q in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    args = ap.parse_args()
    tables = tpch.generate(args.sf)
    s = TpuSession(device="cuda")
    dfs = {n: s.from_numpy(tables[n], tpch.SCHEMAS[n])
           for n in ("orders", "customer")}
    counts = {}
    for (name, route), q in _filters(dfs).items():
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = q()
        peak = torch.cuda.max_memory_allocated() - resident
        warm = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            q()
            warm.append((time.perf_counter() - t0) * 1e3)
        counts.setdefault(name, set()).add(got[0][0])
        print(json.dumps({"filter": name, "route": route, "count": got[0][0],
                          "warm_ms": warm,
                          "warm_median_ms": statistics.median(warm),
                          "peak_above_resident_bytes": peak}), flush=True)
    for name, seen in counts.items():
        if len(seen) != 1:
            raise AssertionError(f"{name}: the routes disagree: {seen}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
