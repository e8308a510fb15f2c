"""TPC-H benchmark: deterministic data generator, q1 via the session API, and
an independent single-core NumPy oracle.

Counterpart of ``spark_rapids_tpu/benchmarks/tpch.py``, kept as the port's own
copy. The generator keeps the seed (20260729) and the draw order, so both
packages write equal tables and read the same files. Keys are dense (1..n)
rather than dbgen's sparse permutations; lineitem has ~6M rows per SF.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import pyarrow as pa


EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d):
    return (datetime.date(y, m, d) - EPOCH).days


START = _days(1992, 1, 1)
END = _days(1998, 8, 2)

NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
           "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA",
           "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
           "UNITED STATES"]
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]


def generate(sf: float, outdir: str, files_per_table: int = 4) -> dict:
    """Generate the q1/q3/q5 table subset at scale factor `sf` as parquet.
    Returns {table: path}. Idempotent: skips tables already on disk."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(20260729)
    n_orders = int(1_500_000 * sf)
    n_cust = max(int(150_000 * sf), 1)
    n_supp = max(int(10_000 * sf), 1)

    paths = {}

    def write(name, table, nfiles=files_per_table):
        from spark_rapids_tpu_torch.benchmarks.common import write_partitioned
        write_partitioned(outdir, name, table, nfiles, paths)

    # customer
    write("customer", pa.table({
        "c_custkey": pa.array(np.arange(1, n_cust + 1, dtype=np.int64)),
        "c_mktsegment": pa.array(
            np.array(SEGMENTS)[rng.integers(0, 5, n_cust)]),
        "c_nationkey": pa.array(rng.integers(0, 25, n_cust).astype(np.int32)),
    }), 1)

    # supplier
    write("supplier", pa.table({
        "s_suppkey": pa.array(np.arange(1, n_supp + 1, dtype=np.int64)),
        "s_nationkey": pa.array(rng.integers(0, 25, n_supp).astype(np.int32)),
    }), 1)

    # nation / region
    write("nation", pa.table({
        "n_nationkey": pa.array(np.arange(25, dtype=np.int32)),
        "n_name": pa.array(NATIONS),
        "n_regionkey": pa.array(np.array(NATION_REGION, dtype=np.int32)),
    }), 1)
    write("region", pa.table({
        "r_regionkey": pa.array(np.arange(5, dtype=np.int32)),
        "r_name": pa.array(REGIONS),
    }), 1)

    # orders. o_totalprice (q18) is DERIVED from o_orderkey, not rng-drawn:
    # inserting an rng draw here would shift every later lineitem draw and
    # silently desync cached lineitem dirs from regenerated orders dirs
    # (write() only regenerates on schema change).
    o_orderkey = np.arange(1, n_orders + 1, dtype=np.int64)
    o_orderdate = rng.integers(START, END - 150, n_orders).astype(np.int32)
    orders = pa.table({
        "o_orderkey": pa.array(o_orderkey),
        "o_custkey": pa.array(
            rng.integers(1, n_cust + 1, n_orders).astype(np.int64)),
        "o_orderdate": pa.array(o_orderdate, pa.int32()).cast(pa.date32()),
        "o_shippriority": pa.array(
            np.zeros(n_orders, dtype=np.int32)),
        "o_totalprice": pa.array(np.round(
            857.71 + (o_orderkey * 9973 % 45000000) / 100.0, 2)),
    })
    write("orders", orders)

    # lineitem: 1..7 lines per order (mean 4 → ~6M lines/SF1)
    nlines = rng.integers(1, 8, n_orders)
    l_orderkey = np.repeat(o_orderkey, nlines)
    l_orderdate = np.repeat(o_orderdate, nlines)
    n_li = len(l_orderkey)
    l_shipdate = (l_orderdate + rng.integers(1, 122, n_li)).astype(np.int32)
    l_receiptdate = (l_shipdate + rng.integers(1, 31, n_li)).astype(np.int32)
    cutoff = _days(1995, 6, 17)
    returnflag = np.where(l_receiptdate <= cutoff,
                          np.where(rng.random(n_li) < 0.5, "R", "A"), "N")
    linestatus = np.where(l_shipdate > cutoff, "O", "F")
    lineitem = pa.table({
        "l_orderkey": pa.array(l_orderkey),
        "l_suppkey": pa.array(
            rng.integers(1, n_supp + 1, n_li).astype(np.int64)),
        "l_quantity": pa.array(
            rng.integers(1, 51, n_li).astype(np.float64)),
        "l_extendedprice": pa.array(
            np.round(rng.uniform(900.0, 105000.0, n_li), 2)),
        "l_discount": pa.array(
            np.round(rng.integers(0, 11, n_li) * 0.01, 2)),
        "l_tax": pa.array(np.round(rng.integers(0, 9, n_li) * 0.01, 2)),
        "l_returnflag": pa.array(returnflag),
        "l_linestatus": pa.array(linestatus),
        "l_shipdate": pa.array(l_shipdate, pa.int32()).cast(pa.date32()),
    })
    write("lineitem", lineitem)
    return paths


def load(spark, paths: dict, files_per_partition: int = 2) -> dict:
    from spark_rapids_tpu_torch.benchmarks.common import load as _load
    return _load(spark, paths, files_per_partition)


# -- queries (session API) ---------------------------------------------------

def q1(dfs):
    """Pricing summary report (TPC-H q1)."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    li = dfs["lineitem"]
    cut = F.cast(F.lit("1998-09-02"), T.DATE)
    c = F.col
    return (li.filter(c("l_shipdate") <= cut)
            .select(c("l_returnflag"), c("l_linestatus"), c("l_quantity"),
                    c("l_extendedprice"), c("l_discount"),
                    (c("l_extendedprice") * (F.lit(1.0) - c("l_discount")))
                    .alias("disc_price"),
                    (c("l_extendedprice") * (F.lit(1.0) - c("l_discount"))
                     * (F.lit(1.0) + c("l_tax"))).alias("charge"))
            .group_by(c("l_returnflag"), c("l_linestatus"))
            .agg(F.sum(c("l_quantity")).alias("sum_qty"),
                 F.sum(c("l_extendedprice")).alias("sum_base_price"),
                 F.sum(c("disc_price")).alias("sum_disc_price"),
                 F.sum(c("charge")).alias("sum_charge"),
                 F.avg(c("l_quantity")).alias("avg_qty"),
                 F.avg(c("l_extendedprice")).alias("avg_price"),
                 F.avg(c("l_discount")).alias("avg_disc"),
                 F.count(c("l_quantity")).alias("count_order"))
            .sort(c("l_returnflag"), c("l_linestatus")))


# -- independent NumPy oracle (single core, the CPU-Spark stand-in) ----------

def load_np(paths: dict) -> dict:
    from spark_rapids_tpu_torch.benchmarks.common import load_np as _load_np
    return _load_np(paths)


def np_q1(tb):
    li = tb["lineitem"]
    keep = li["l_shipdate"] <= _days(1998, 9, 2)
    rf, ls = li["l_returnflag"][keep], li["l_linestatus"][keep]
    qty = li["l_quantity"][keep]
    price = li["l_extendedprice"][keep]
    disc = li["l_discount"][keep]
    tax = li["l_tax"][keep]
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    key = np.char.add(rf.astype("U1"), ls.astype("U1"))
    order = np.argsort(key, kind="stable")
    key, qty, price, disc, disc_price, charge = (
        a[order] for a in (key, qty, price, disc, disc_price, charge))
    uniq, start = np.unique(key, return_index=True)
    rows = []
    for g, s in enumerate(start):
        e = start[g + 1] if g + 1 < len(start) else len(key)
        n = e - s
        rows.append((uniq[g][0], uniq[g][1],
                     qty[s:e].sum(), price[s:e].sum(), disc_price[s:e].sum(),
                     charge[s:e].sum(), qty[s:e].sum() / n,
                     price[s:e].sum() / n, disc[s:e].sum() / n, n))
    return rows
