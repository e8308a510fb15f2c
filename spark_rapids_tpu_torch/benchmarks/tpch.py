"""TPC-H benchmark: deterministic data generator, the ladder q1, q3, q5 and
q18 via the session API (and q5 over sparse supplier ids), and independent
single-core NumPy oracles.

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


def q3(dfs):
    """Shipping priority (TPC-H q3): top-10 unshipped orders by revenue."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    c = F.col
    date = F.cast(F.lit("1995-03-15"), T.DATE)
    cust = dfs["customer"].filter(c("c_mktsegment") == F.lit("BUILDING"))
    orders = dfs["orders"].filter(c("o_orderdate") < date).select(
        c("o_orderkey"), c("o_custkey"), c("o_orderdate"), c("o_shippriority"))
    li = dfs["lineitem"].filter(c("l_shipdate") > date).select(
        c("l_orderkey"), c("l_extendedprice"), c("l_discount"))
    j = (cust.select(c("c_custkey").alias("o_custkey"))
         .join(orders, on="o_custkey")
         .select(c("o_orderkey").alias("l_orderkey"), c("o_orderdate"),
                 c("o_shippriority"))
         .join(li, on="l_orderkey"))
    return (j.select(c("l_orderkey"), c("o_orderdate"), c("o_shippriority"),
                     (c("l_extendedprice") * (F.lit(1.0) - c("l_discount")))
                     .alias("volume"))
            .group_by(c("l_orderkey"), c("o_orderdate"), c("o_shippriority"))
            .agg(F.sum(c("volume")).alias("revenue"))
            .sort(c("revenue"), c("o_orderdate"), ascending=[False, True])
            .limit(10))


def q5(dfs):
    """Local supplier volume (TPC-H q5): revenue by nation in ASIA."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    c = F.col
    d0 = F.cast(F.lit("1994-01-01"), T.DATE)
    d1 = F.cast(F.lit("1995-01-01"), T.DATE)
    asia = dfs["region"].filter(c("r_name") == F.lit("ASIA")).select(
        c("r_regionkey").alias("n_regionkey"))
    nations = (dfs["nation"].join(asia, on="n_regionkey")
               .select(c("n_nationkey"), c("n_name")))
    supp = (dfs["supplier"]
            .select(c("s_suppkey").alias("l_suppkey"),
                    c("s_nationkey").alias("n_nationkey"))
            .join(nations, on="n_nationkey"))
    orders = (dfs["orders"]
              .filter((c("o_orderdate") >= d0) & (c("o_orderdate") < d1))
              .select(c("o_orderkey").alias("l_orderkey"),
                      c("o_custkey").alias("c_custkey")))
    cust = dfs["customer"].select(c("c_custkey"),
                                  c("c_nationkey"))
    co = orders.join(cust, on="c_custkey")
    li = dfs["lineitem"].select(c("l_orderkey"), c("l_suppkey"),
                                c("l_extendedprice"), c("l_discount"))
    j = (li.join(co, on="l_orderkey")
         .join(supp, on="l_suppkey")
         # q5's extra equality: the customer must share the supplier's nation
         .filter(c("c_nationkey") == c("n_nationkey")))
    return (j.select(c("n_name"),
                     (c("l_extendedprice") * (F.lit(1.0) - c("l_discount")))
                     .alias("volume"))
            .group_by(c("n_name"))
            .agg(F.sum(c("volume")).alias("revenue"))
            .sort(c("revenue"), ascending=False))


#: multiplier that spreads the dense supplier keys 1..n over ~10^10 ids in
#: q5_sparse. It keeps every bucket of the join's 4,096-bucket Fibonacci table
#: at 4 keys or fewer at SF1 (the table takes 8); the stride 999,999,937 put
#: up to 29 keys in one bucket and would make the hash build refuse.
SPARSE_SUPPKEY_STRIDE = 1_000_003


def q5_sparse(dfs):
    """q5 with TPC-H's ``l_suppkey = s_suppkey`` condition carried on sparse
    64-bit supplier ids (``suppkey * SPARSE_SUPPKEY_STRIDE``): the supplier
    join's key range is too wide for the direct-address table, so its build
    (every supplier) takes the hash table. The joins: lineitem with the
    year's orders and their customers on ``l_orderkey``, then with every
    supplier on ``s_id``, the customer's nation held equal to the
    supplier's, then with ASIA's nations. Gives ``np_q5``'s answer."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch import types as T
    c = F.col
    stride = F.lit(SPARSE_SUPPKEY_STRIDE)
    d0 = F.cast(F.lit("1994-01-01"), T.DATE)
    d1 = F.cast(F.lit("1995-01-01"), T.DATE)
    asia = dfs["region"].filter(c("r_name") == F.lit("ASIA")).select(
        c("r_regionkey").alias("n_regionkey"))
    nations = (dfs["nation"].join(asia, on="n_regionkey")
               .select(c("n_nationkey"), c("n_name")))
    supp = dfs["supplier"].select((c("s_suppkey") * stride).alias("s_id"),
                                  c("s_nationkey").alias("n_nationkey"))
    orders = (dfs["orders"]
              .filter((c("o_orderdate") >= d0) & (c("o_orderdate") < d1))
              .select(c("o_orderkey").alias("l_orderkey"),
                      c("o_custkey").alias("c_custkey")))
    co = orders.join(dfs["customer"].select(c("c_custkey"),
                                            c("c_nationkey")),
                     on="c_custkey")
    li = dfs["lineitem"].select(c("l_orderkey"),
                                (c("l_suppkey") * stride).alias("s_id"),
                                c("l_extendedprice"), c("l_discount"))
    j = (li.join(co, on="l_orderkey")
         .join(supp, on="s_id")
         .filter(c("c_nationkey") == c("n_nationkey"))
         .join(nations, on="n_nationkey"))
    return (j.select(c("n_name"),
                     (c("l_extendedprice") * (F.lit(1.0) - c("l_discount")))
                     .alias("volume"))
            .group_by(c("n_name"))
            .agg(F.sum(c("volume")).alias("revenue"))
            .sort(c("revenue"), ascending=False))


def q18(dfs):
    """Large volume customer (TPC-H q18, adapted to the generator's schema
    subset: c_name is absent, so the output keys on c_custkey): a sum per
    order over all of lineitem, a HAVING filter, then joins back through
    orders and customer."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    li = dfs["lineitem"]
    big = (li.group_by(c("l_orderkey"))
           .agg(F.sum(c("l_quantity")).alias("sum_qty"))
           .filter(c("sum_qty") > F.lit(300.0)))
    orders = dfs["orders"].select(
        c("o_orderkey").alias("l_orderkey"), c("o_custkey"),
        c("o_orderdate"), c("o_totalprice"))
    cust = dfs["customer"].select(c("c_custkey").alias("o_custkey"))
    j = big.join(orders, on="l_orderkey").join(cust, on="o_custkey")
    return (j.select(c("o_custkey").alias("c_custkey"),
                     c("l_orderkey").alias("o_orderkey"),
                     c("o_orderdate"), c("o_totalprice"), c("sum_qty"))
            .sort(c("o_totalprice"), c("o_orderdate"), c("o_orderkey"),
                  ascending=[False, True, True])
            .limit(100))


QUERIES = {"q1": q1, "q3": q3, "q5": q5, "q18": q18}


# -- independent NumPy oracles (single core, the CPU-Spark stand-in) ---------

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


def np_q3(tb):
    cust = tb["customer"]
    orders = tb["orders"]
    li = tb["lineitem"]
    date = _days(1995, 3, 15)
    ck = cust["c_custkey"][cust["c_mktsegment"] == "BUILDING"]
    om = (orders["o_orderdate"] < date) & np.isin(orders["o_custkey"], ck)
    okeys = orders["o_orderkey"][om]
    odate = orders["o_orderdate"][om]
    oprio = orders["o_shippriority"][om]
    lm = (li["l_shipdate"] > date) & np.isin(li["l_orderkey"], okeys)
    lkey = li["l_orderkey"][lm]
    vol = li["l_extendedprice"][lm] * (1.0 - li["l_discount"][lm])
    order = np.argsort(lkey, kind="stable")
    lkey, vol = lkey[order], vol[order]
    uk, start = np.unique(lkey, return_index=True)
    rev = np.add.reduceat(vol, start)
    osort = np.argsort(okeys, kind="stable")
    pos = osort[np.searchsorted(okeys, uk, sorter=osort)]
    rows = sorted(zip(uk, odate[pos], oprio[pos], rev),
                  key=lambda r: (-r[3], r[1], r[0]))[:10]
    return [(int(k), int(d), int(p), float(r)) for k, d, p, r in rows]


def np_q18(tb):
    li = tb["lineitem"]
    order = np.argsort(li["l_orderkey"], kind="stable")
    lk, q = li["l_orderkey"][order], li["l_quantity"][order]
    uk, start = np.unique(lk, return_index=True)
    sums = np.add.reduceat(q, start)
    keep = sums > 300.0
    big, bsum = uk[keep], sums[keep]
    orders = tb["orders"]
    osort = np.argsort(orders["o_orderkey"], kind="stable")
    pos = osort[np.searchsorted(orders["o_orderkey"], big, sorter=osort)]
    # every o_custkey exists in customer (dense 1..n), so the customer
    # inner join filters nothing
    rows = sorted(zip(orders["o_custkey"][pos], big,
                      orders["o_orderdate"][pos],
                      orders["o_totalprice"][pos], bsum),
                  key=lambda r: (-r[3], r[2], r[1]))[:100]
    return [(int(c), int(o), int(d), float(t), float(s))
            for c, o, d, t, s in rows]


def _np_q5_lines(tb):
    """q5's lineitem rows in numpy: (their revenue terms, their supplier's
    nation key, nation key → name)."""
    date0, date1 = _days(1994, 1, 1), _days(1995, 1, 1)
    region = tb["region"]
    nation = tb["nation"]
    asia = region["r_regionkey"][region["r_name"] == "ASIA"]
    nmask = np.isin(nation["n_regionkey"], asia)
    nkeys = nation["n_nationkey"][nmask]
    nnames = nation["n_name"][nmask]
    supp = tb["supplier"]
    smask = np.isin(supp["s_nationkey"], nkeys)
    # supplier key → nation (dense s_suppkey 1..n)
    s_nation = np.full(int(supp["s_suppkey"].max()) + 1, -1, dtype=np.int64)
    s_nation[supp["s_suppkey"][smask]] = supp["s_nationkey"][smask]
    cust = tb["customer"]
    c_nation = np.full(int(cust["c_custkey"].max()) + 1, -2, dtype=np.int64)
    c_nation[cust["c_custkey"]] = cust["c_nationkey"]
    orders = tb["orders"]
    om = (orders["o_orderdate"] >= date0) & (orders["o_orderdate"] < date1)
    o_cnation = np.full(int(orders["o_orderkey"].max()) + 1, -3,
                        dtype=np.int64)
    o_cnation[orders["o_orderkey"][om]] = c_nation[orders["o_custkey"][om]]
    li = tb["lineitem"]
    lsn = s_nation[li["l_suppkey"]]
    lcn = o_cnation[li["l_orderkey"]]
    keep = (lsn >= 0) & (lsn == lcn)
    vol = li["l_extendedprice"][keep] * (1.0 - li["l_discount"][keep])
    return vol, lsn[keep], {int(k): n for k, n in zip(nkeys, nnames)}


def np_q5_terms(tb) -> dict:
    """The number of revenue terms q5 sums for each nation name."""
    _vol, nat, name_of = _np_q5_lines(tb)
    keys, n = np.unique(nat, return_counts=True)
    return {name_of[int(k)]: int(c) for k, c in zip(keys, n)}


def np_q5(tb):
    vol, nat, name_of = _np_q5_lines(tb)
    out = {}
    for k in np.unique(nat):
        out[name_of[int(k)]] = float(vol[nat == k].sum())
    return sorted(out.items(), key=lambda kv: -kv[1])
