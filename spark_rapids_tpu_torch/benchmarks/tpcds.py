"""TPC-DS subset benchmark: deterministic data generator, the star-join
DataFrame queries that the port runs via the session API, and independent
single-core NumPy oracles.

Counterpart of ``spark_rapids_tpu/benchmarks/tpcds.py``, kept as the port's
own copy. The generator keeps the seeds (20260730, and 20260731 for the
later tables and columns) and the draw order, so both packages write equal
tables and read the same files; the ``decimal(7,2)`` money columns are built
from their cents in one vectorized step rather than one Python ``Decimal``
per row. ``QUERIES`` holds all 22 of the reference's DataFrame queries:
q53, q63, q89 and q98 run a window over an aggregate, and q88 cross-joins
eight keyless counts (the nested-loop join). The queries follow the official TPC-DS text over
this schema subset; ``store_sales`` has ~2.88M rows per SF.

``sql_suite_oracles()`` maps each official SQL text the port lowers
(``SQL_PORTED``, 27 of ``sql/tpcds_queries.py``'s 40) to its oracle: the
DataFrame twin's where there is one, else one of the SQL-only oracles
(q13, q15, q61, q97, q12, q20, q26, copies of the reference's).
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa


N_DATES = 366 * 5            # 1998..2002
FIRST_YEAR = 1998
CATEGORIES = ["Home", "Books", "Electronics", "Music", "Sports", "Shoes",
              "Jewelry", "Men", "Women", "Children"]
GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
             "Advanced Degree", "Unknown"]


def generate(sf: float, outdir: str, files_per_table: int = 4) -> dict:
    """Generate the subset at scale factor `sf` (SF1 ≈ 2.9M store_sales).
    Returns {table: dir}. Idempotent per table."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(20260730)
    n_ss = int(2_880_000 * sf)
    n_item = max(int(18_000 * sf), 2000)
    n_cust = max(int(100_000 * sf), 100)
    n_addr = max(n_cust // 2, 50)
    n_store = max(int(12 * max(sf, 1)), 2)
    n_cd = 7 * 5 * 2 * 4     # education x marital x gender x dep buckets
    n_promo = max(int(300 * sf), 10)

    paths = {}

    def write(name, table, nfiles=files_per_table):
        from spark_rapids_tpu_torch.benchmarks.common import write_partitioned
        write_partitioned(outdir, name, table, nfiles, paths)

    # a second stream for the later tables and columns (the catalog and
    # web facts, the preferred flag), so the first stream's draws, and the
    # tables they make, do not depend on them
    rng5 = np.random.default_rng(20260731)

    # date_dim: one row per day, d_date_sk dense from 1
    sk = np.arange(1, N_DATES + 1, dtype=np.int64)
    doy = (sk - 1) % 366
    moy = (doy // 31 + 1).astype(np.int32)
    base_days = int((np.datetime64(f"{FIRST_YEAR}-01-01")
                     - np.datetime64("1970-01-01")) // np.timedelta64(1, "D"))
    write("date_dim", pa.table({
        "d_date_sk": pa.array(sk),
        "d_date": pa.array((base_days + sk - 1).astype(np.int32),
                           pa.int32()).cast(pa.date32()),
        # month sequence from 1200 (the official queries' param range)
        "d_month_seq": pa.array(
            (1200 + ((sk - 1) // 366) * 12 + (moy - 1)).astype(np.int32)),
        "d_year": pa.array((FIRST_YEAR + (sk - 1) // 366).astype(np.int32)),
        "d_moy": pa.array(moy),
        "d_dom": pa.array((doy % 31 + 1).astype(np.int32)),
        "d_qoy": pa.array(((moy - 1) // 3 + 1).astype(np.int32)),
        "d_dow": pa.array((doy % 7).astype(np.int32)),
    }), 1)

    # time_dim: one row per minute of day
    tsk = np.arange(1, 24 * 60 + 1, dtype=np.int64)
    write("time_dim", pa.table({
        "t_time_sk": pa.array(tsk),
        "t_hour": pa.array(((tsk - 1) // 60).astype(np.int32)),
        "t_minute": pa.array(((tsk - 1) % 60).astype(np.int32)),
    }), 1)

    # household_demographics: dep x vehicle x buy-potential cross
    n_hd = 10 * 6 * 3
    hd_sk = np.arange(1, n_hd + 1, dtype=np.int64)
    write("household_demographics", pa.table({
        "hd_demo_sk": pa.array(hd_sk),
        "hd_dep_count": pa.array(((hd_sk - 1) % 10).astype(np.int32)),
        "hd_vehicle_count": pa.array(
            (((hd_sk - 1) // 10) % 6 - 1).astype(np.int32)),
        "hd_buy_potential": pa.array(
            np.array([">10000", "5001-10000", "Unknown"])[
                ((hd_sk - 1) // 60) % 3]),
    }), 1)

    # item
    isk = np.arange(1, n_item + 1, dtype=np.int64)
    cat_id = rng.integers(0, len(CATEGORIES), n_item)
    brand_id = (cat_id + 1) * 1000 + rng.integers(1, 100, n_item)
    class_id = rng.integers(1, 17, n_item)
    write("item", pa.table({
        "i_item_sk": pa.array(isk),
        "i_item_id": pa.array([f"ITEM{k:08d}" for k in isk]),
        "i_item_desc": pa.array([f"desc {k} words" for k in isk]),
        "i_brand_id": pa.array(brand_id.astype(np.int32)),
        "i_brand": pa.array([f"brand#{b}" for b in brand_id]),
        "i_class_id": pa.array(class_id.astype(np.int32)),
        "i_class": pa.array([f"class{c}" for c in class_id]),
        "i_category_id": pa.array((cat_id + 1).astype(np.int32)),
        "i_category": pa.array(np.array(CATEGORIES)[cat_id]),
        "i_current_price": pa.array(
            np.round(rng.uniform(0.5, 100.0, n_item), 2)),
        "i_manufact_id": pa.array(
            rng.integers(1, 140, n_item).astype(np.int32)),
        "i_manager_id": pa.array(
            rng.integers(1, 100, n_item).astype(np.int32)),
        "i_color": pa.array(np.array(
            ["slate", "blanched", "burnished", "floral", "honeydew",
             "salmon", "powder", "peru"])[rng5.integers(0, 8, n_item)]),
    }), 1)

    # customer_demographics: full cross of the filter dimensions
    cd_sk = np.arange(1, n_cd + 1, dtype=np.int64)
    write("customer_demographics", pa.table({
        "cd_demo_sk": pa.array(cd_sk),
        "cd_gender": pa.array(np.array(GENDERS)[(cd_sk - 1) % 2]),
        "cd_marital_status": pa.array(
            np.array(MARITAL)[((cd_sk - 1) // 2) % 5]),
        "cd_education_status": pa.array(
            np.array(EDUCATION)[((cd_sk - 1) // 10) % 7]),
        "cd_dep_count": pa.array(((cd_sk - 1) // 70).astype(np.int32)),
        "cd_purchase_estimate": pa.array(
            (rng5.integers(1, 21, n_cd) * 500).astype(np.int32)),
        "cd_credit_rating": pa.array(np.array(
            ["Low Risk", "Good", "High Risk", "Unknown"])[
                rng5.integers(0, 4, n_cd)]),
    }), 1)

    # promotion
    psk = np.arange(1, n_promo + 1, dtype=np.int64)
    write("promotion", pa.table({
        "p_promo_sk": pa.array(psk),
        "p_channel_email": pa.array(
            np.where(rng.random(n_promo) < 0.5, "N", "Y")),
        "p_channel_event": pa.array(
            np.where(rng.random(n_promo) < 0.5, "N", "Y")),
        "p_channel_dmail": pa.array(
            np.where(rng5.random(n_promo) < 0.5, "N", "Y")),
        "p_channel_tv": pa.array(
            np.where(rng5.random(n_promo) < 0.5, "N", "Y")),
    }), 1)

    # customer_address / store (zips overlap so q19's <> filter selects)
    zips = rng.integers(10000, 10100, n_addr)
    cities = np.array(["Midway", "Fairview", "Oakland", "Salem", "Georgetown",
                       "Ashland", "Marion", "Union", "Clinton", "Greenfield"])
    states = np.array(["CA", "TX", "NY", "GA", "OH", "WA", "IL", "MI"])
    write("customer_address", pa.table({
        "ca_address_sk": pa.array(np.arange(1, n_addr + 1, dtype=np.int64)),
        "ca_zip": pa.array([f"{z:05d}" for z in zips]),
        "ca_city": pa.array(cities[rng.integers(0, len(cities), n_addr)]),
        "ca_state": pa.array(states[rng.integers(0, len(states), n_addr)]),
        "ca_country": pa.array(np.repeat("United States", n_addr)),
        "ca_county": pa.array(
            [f"{c} County" for c in
             cities[rng5.integers(0, len(cities), n_addr)]]),
        "ca_gmt_offset": pa.array(
            rng.choice([-5.0, -6.0, -7.0, -8.0], n_addr)),
    }), 1)
    szips = rng.integers(10000, 10100, n_store)
    write("store", pa.table({
        "s_store_sk": pa.array(np.arange(1, n_store + 1, dtype=np.int64)),
        "s_store_name": pa.array([f"store{k}" for k in range(n_store)]),
        "s_zip": pa.array([f"{z:05d}" for z in szips]),
        "s_city": pa.array(cities[rng.integers(0, len(cities), n_store)]),
        "s_county": pa.array(
            [f"{c} County" for c in
             cities[rng.integers(0, len(cities), n_store)]]),
        "s_state": pa.array(states[rng.integers(0, len(states), n_store)]),
        "s_number_employees": pa.array(
            rng.integers(200, 300, n_store).astype(np.int32)),
        "s_gmt_offset": pa.array(
            rng5.choice([-5.0, -6.0, -7.0, -8.0], n_store)),
    }), 1)

    # customer
    write("customer", pa.table({
        "c_customer_sk": pa.array(np.arange(1, n_cust + 1, dtype=np.int64)),
        "c_current_addr_sk": pa.array(
            rng.integers(1, n_addr + 1, n_cust).astype(np.int64)),
        "c_first_name": pa.array([f"First{k % 500}" for k in range(n_cust)]),
        "c_last_name": pa.array([f"Last{k % 700}" for k in range(n_cust)]),
        "c_preferred_cust_flag": pa.array(
            np.where(rng5.random(n_cust) < 0.5, "Y", "N")),
        "c_birth_year": pa.array(
            rng5.integers(1924, 1993, n_cust).astype(np.int32)),
        "c_birth_month": pa.array(
            rng5.integers(1, 13, n_cust).astype(np.int32)),
        "c_current_cdemo_sk": pa.array(
            rng5.integers(1, n_cd + 1, n_cust).astype(np.int64)),
    }), 1)

    # store_sales (fact). Money columns that TPC-DS declares decimal(7,2)
    # ride as decimal128(7,2): the decimal queries aggregate them exactly
    # on the device (scaled int64). The array is built from its cents
    # directly: the low word and its sign extension, as arrow stores it
    def dec72(arr):
        cents = np.round(np.asarray(arr) * 100).astype(np.int64)
        words = np.empty((len(cents), 2), dtype=np.int64)
        words[:, 0] = cents
        words[:, 1] = cents >> 63
        return pa.Array.from_buffers(pa.decimal128(7, 2), len(cents),
                                     [None, pa.py_buffer(words.tobytes())])

    # basket structure: a TICKET is one visit — one customer, household,
    # date, store, and address per ticket (row counts per ticket span 1..25
    # so q34's 15-20 band and q73's 1-5 band both select)
    n_tk = max(n_ss // 13, 1)
    tk_sizes = rng.integers(1, 26, n_tk)
    ticket = np.repeat(np.arange(1, n_tk + 1, dtype=np.int64), tk_sizes)
    if len(ticket) < n_ss:
        ticket = np.concatenate(
            [ticket, np.full(n_ss - len(ticket), n_tk, np.int64)])
    ticket = ticket[:n_ss]
    tk_cust = rng.integers(1, n_cust + 1, n_tk + 1).astype(np.int64)
    tk_hd = rng.integers(1, n_hd + 1, n_tk + 1).astype(np.int64)
    tk_date = rng.integers(1, N_DATES + 1, n_tk + 1).astype(np.int64)
    tk_store = rng.integers(1, n_store + 1, n_tk + 1).astype(np.int64)
    tk_addr = rng.integers(1, n_addr + 1, n_tk + 1).astype(np.int64)
    write("store_sales", pa.table({
        "ss_sold_date_sk": pa.array(tk_date[ticket - 1]),
        "ss_sold_time_sk": pa.array(
            rng.integers(1, 24 * 60 + 1, n_ss).astype(np.int64)),
        "ss_item_sk": pa.array(
            rng.integers(1, n_item + 1, n_ss).astype(np.int64)),
        "ss_customer_sk": pa.array(tk_cust[ticket - 1]),
        "ss_cdemo_sk": pa.array(
            rng.integers(1, n_cd + 1, n_ss).astype(np.int64)),
        "ss_hdemo_sk": pa.array(tk_hd[ticket - 1]),
        "ss_addr_sk": pa.array(tk_addr[ticket - 1]),
        "ss_promo_sk": pa.array(
            rng.integers(1, n_promo + 1, n_ss).astype(np.int64)),
        "ss_store_sk": pa.array(tk_store[ticket - 1]),
        "ss_ticket_number": pa.array(ticket),
        "ss_quantity": pa.array(
            rng.integers(1, 100, n_ss).astype(np.int32)),
        "ss_list_price": pa.array(
            np.round(rng.uniform(1.0, 200.0, n_ss), 2)),
        "ss_sales_price": pa.array(
            np.round(rng.uniform(1.0, 200.0, n_ss), 2)),
        "ss_ext_sales_price": pa.array(
            np.round(rng.uniform(1.0, 20000.0, n_ss), 2)),
        "ss_ext_list_price": pa.array(
            np.round(rng.uniform(1.0, 20000.0, n_ss), 2)),
        "ss_ext_tax": pa.array(
            np.round(rng.uniform(0.0, 1800.0, n_ss), 2)),
        "ss_coupon_amt": pa.array(
            np.round(rng.uniform(0.0, 50.0, n_ss), 2)),
        "ss_wholesale_cost": pa.array(
            np.round(rng.uniform(1.0, 100.0, n_ss), 2)),
        "ss_net_paid": dec72(rng.uniform(0.0, 20000.0, n_ss)),
        "ss_net_profit": dec72(rng.uniform(-5000.0, 15000.0, n_ss)),
        "ss_ext_wholesale_cost": dec72(rng.uniform(1.0, 10000.0, n_ss)),
    }))

    # catalog_sales / web_sales: the cross-channel facts q38/q87's
    # INTERSECT/EXCEPT and q14's shapes join against. Spec row ratios are
    # roughly ss : cs : ws = 2 : 1 : 0.5; half of each channel's
    # (customer, date) pairs ECHO store_sales visits so cross-channel
    # set operations select a meaningful overlap (spec customers shop in
    # several channels; independent draws would make the intersect ~empty).
    ss_date, ss_cust = tk_date[ticket - 1], tk_cust[ticket - 1]

    def channel(prefix, n_rows):
        take = rng5.integers(0, n_ss, n_rows)
        echo = rng5.random(n_rows) < 0.5
        date = np.where(echo, ss_date[take],
                        rng5.integers(1, N_DATES + 1, n_rows)).astype(np.int64)
        cust = np.where(echo, ss_cust[take],
                        rng5.integers(1, n_cust + 1, n_rows)).astype(np.int64)
        return pa.table({
            f"{prefix}_sold_date_sk": pa.array(date),
            f"{prefix}_bill_customer_sk": pa.array(cust),
            f"{prefix}_item_sk": pa.array(
                rng5.integers(1, n_item + 1, n_rows).astype(np.int64)),
            f"{prefix}_quantity": pa.array(
                rng5.integers(1, 100, n_rows).astype(np.int32)),
            f"{prefix}_list_price": pa.array(
                np.round(rng5.uniform(1.0, 200.0, n_rows), 2)),
            f"{prefix}_sales_price": pa.array(
                np.round(rng5.uniform(1.0, 200.0, n_rows), 2)),
            f"{prefix}_ext_sales_price": pa.array(
                np.round(rng5.uniform(1.0, 20000.0, n_rows), 2)),
            f"{prefix}_bill_addr_sk": pa.array(
                rng5.integers(1, n_addr + 1, n_rows).astype(np.int64)),
            f"{prefix}_bill_cdemo_sk": pa.array(
                rng5.integers(1, n_cd + 1, n_rows).astype(np.int64)),
            f"{prefix}_promo_sk": pa.array(
                rng5.integers(1, n_promo + 1, n_rows).astype(np.int64)),
            f"{prefix}_coupon_amt": pa.array(
                np.round(rng5.uniform(0.0, 50.0, n_rows), 2)),
            f"{prefix}_net_profit": pa.array(
                np.round(rng5.uniform(-5000.0, 15000.0, n_rows), 2)),
        })

    write("catalog_sales", channel("cs", max(n_ss // 2, 10)))
    write("web_sales", channel("ws", max(n_ss // 4, 10)))

    # inventory: weekly quantity-on-hand snapshots for a sampled
    # item subset (q22's rollup; the spec snapshots weekly per warehouse —
    # one warehouse keeps the subset fact compact)
    inv_dates = np.arange(1, N_DATES + 1, 7, dtype=np.int64)
    inv_items = np.arange(1, n_item + 1, max(1, n_item // 1000),
                          dtype=np.int64)
    dgrid, igrid = np.meshgrid(inv_dates, inv_items, indexing="ij")
    n_inv = dgrid.size
    write("inventory", pa.table({
        "inv_date_sk": pa.array(dgrid.ravel()),
        "inv_item_sk": pa.array(igrid.ravel()),
        "inv_warehouse_sk": pa.array(np.ones(n_inv, np.int64)),
        "inv_quantity_on_hand": pa.array(
            rng5.integers(0, 1000, n_inv).astype(np.int32)),
    }))
    return paths


def load(spark, paths: dict, files_per_partition: int = 2) -> dict:
    from spark_rapids_tpu_torch.benchmarks.common import load as _load
    return _load(spark, paths, files_per_partition)


# -- queries (session API; official TPC-DS text over this subset) -------------

def _star(dfs, moy, year=None):
    """store_sales ⋈ date_dim ⋈ item — the q3/q42/q52/q55 spine. q3 filters
    only the month (it groups by d_year); the others pin one year too."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    cond = c("d_moy") == F.lit(moy)
    if year is not None:
        cond = (c("d_year") == F.lit(year)) & cond
    dd = (dfs["date_dim"].filter(cond)
          .select(c("d_date_sk").alias("ss_sold_date_sk"), c("d_year")))
    return (dfs["store_sales"]
            .select(c("ss_sold_date_sk"), c("ss_item_sk"),
                    c("ss_ext_sales_price"))
            .join(dd, on="ss_sold_date_sk")
            .select(c("ss_item_sk").alias("i_item_sk"), c("d_year"),
                    c("ss_ext_sales_price")))


def q3(dfs):
    """Brand revenue by year for manufacturer 128 in November (official
    TPC-DS q3: d_moy = 11 and i_manufact_id = 128, grouped by d_year)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    item = (dfs["item"].filter(c("i_manufact_id") == F.lit(128))
            .select(c("i_item_sk"), c("i_brand_id"), c("i_brand")))
    j = _star(dfs, 11).join(item, on="i_item_sk")
    return (j.group_by(c("d_year"), c("i_brand_id"), c("i_brand"))
            .agg(F.sum(c("ss_ext_sales_price")).alias("sum_agg"))
            .sort(c("d_year"), c("sum_agg"), c("i_brand_id"),
                  ascending=[True, False, True])
            .limit(100))


def q42(dfs):
    """Category revenue for one manager's items, one month (official TPC-DS
    q42: i_manager_id = 1, d_year = 2000, d_moy = 11)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    item = (dfs["item"].filter(c("i_manager_id") == F.lit(1))
            .select(c("i_item_sk"), c("i_category_id"), c("i_category")))
    j = _star(dfs, 11, 2000).join(item, on="i_item_sk")
    return (j.group_by(c("d_year"), c("i_category_id"), c("i_category"))
            .agg(F.sum(c("ss_ext_sales_price")).alias("sum_agg"))
            .sort(c("sum_agg"), c("d_year"), c("i_category_id"),
                  ascending=[False, True, True])
            .limit(100))


def q52(dfs):
    """Brand revenue for one manager's items, one month (official TPC-DS
    q52: i_manager_id = 1, d_year = 2000, d_moy = 11)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    item = (dfs["item"].filter(c("i_manager_id") == F.lit(1))
            .select(c("i_item_sk"), c("i_brand_id"), c("i_brand")))
    j = _star(dfs, 11, 2000).join(item, on="i_item_sk")
    return (j.group_by(c("d_year"), c("i_brand_id"), c("i_brand"))
            .agg(F.sum(c("ss_ext_sales_price")).alias("ext_price"))
            .sort(c("d_year"), c("ext_price"), c("i_brand_id"),
                  ascending=[True, False, True])
            .limit(100))


def q55(dfs):
    """Brand revenue for one manager's items, one month (TPC-DS q55)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    item = (dfs["item"].filter(c("i_manager_id") == F.lit(28))
            .select(c("i_item_sk"), c("i_brand_id"), c("i_brand")))
    j = _star(dfs, 11, 1999).join(item, on="i_item_sk")
    return (j.group_by(c("i_brand_id"), c("i_brand"))
            .agg(F.sum(c("ss_ext_sales_price")).alias("ext_price"))
            .sort(c("ext_price"), c("i_brand_id"), ascending=[False, True])
            .limit(100))


def q7(dfs):
    """Average quantities for one demographic + non-event promos (TPC-DS q7)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    cd = (dfs["customer_demographics"]
          .filter((c("cd_gender") == F.lit("M"))
                  & (c("cd_marital_status") == F.lit("S"))
                  & (c("cd_education_status") == F.lit("College")))
          .select(c("cd_demo_sk").alias("ss_cdemo_sk")))
    promo = (dfs["promotion"]
             .filter((c("p_channel_email") == F.lit("N"))
                     | (c("p_channel_event") == F.lit("N")))
             .select(c("p_promo_sk").alias("ss_promo_sk")))
    dd = (dfs["date_dim"].filter(c("d_year") == F.lit(2000))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    item = dfs["item"].select(c("i_item_sk").alias("ss_item_sk"),
                              c("i_item_id"))
    j = (dfs["store_sales"]
         .join(cd, on="ss_cdemo_sk")
         .join(promo, on="ss_promo_sk")
         .join(dd, on="ss_sold_date_sk")
         .join(item, on="ss_item_sk"))
    return (j.group_by(c("i_item_id"))
            .agg(F.avg(c("ss_quantity")).alias("agg1"),
                 F.avg(c("ss_list_price")).alias("agg2"),
                 F.avg(c("ss_coupon_amt")).alias("agg3"),
                 F.avg(c("ss_sales_price")).alias("agg4"))
            .sort(c("i_item_id"))
            .limit(100))


def q19(dfs):
    """Brand revenue where customer zip differs from store zip (TPC-DS q19)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    dd = (dfs["date_dim"]
          .filter((c("d_year") == F.lit(1999)) & (c("d_moy") == F.lit(11)))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    item = (dfs["item"].filter(c("i_manager_id") == F.lit(8))
            .select(c("i_item_sk").alias("ss_item_sk"), c("i_brand_id"),
                    c("i_brand"), c("i_manufact_id")))
    cust = dfs["customer"].select(c("c_customer_sk").alias("ss_customer_sk"),
                                  c("c_current_addr_sk").alias("ca_address_sk"))
    addr = dfs["customer_address"].select(c("ca_address_sk"), c("ca_zip"))
    store = dfs["store"].select(c("s_store_sk").alias("ss_store_sk"),
                                c("s_zip"))
    j = (dfs["store_sales"]
         .select(c("ss_sold_date_sk"), c("ss_item_sk"), c("ss_customer_sk"),
                 c("ss_store_sk"), c("ss_ext_sales_price"))
         .join(dd, on="ss_sold_date_sk")
         .join(item, on="ss_item_sk")
         .join(cust, on="ss_customer_sk")
         .join(addr, on="ca_address_sk")
         .join(store, on="ss_store_sk")
         .filter(c("ca_zip") != c("s_zip")))
    return (j.group_by(c("i_brand_id"), c("i_brand"), c("i_manufact_id"))
            .agg(F.sum(c("ss_ext_sales_price")).alias("ext_price"))
            .sort(c("ext_price"), c("i_brand_id"), ascending=[False, True])
            .limit(100))


def q43(dfs):
    """Store sales by day of week (TPC-DS q43: one conditional sum per
    weekday)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    dd = (dfs["date_dim"].filter(c("d_year") == F.lit(2000))
          .select(c("d_date_sk").alias("ss_sold_date_sk"), c("d_dow")))
    store = dfs["store"].select(c("s_store_sk").alias("ss_store_sk"),
                                c("s_store_name"))
    j = (dfs["store_sales"]
         .select(c("ss_sold_date_sk"), c("ss_store_sk"),
                 c("ss_sales_price"))
         .join(dd, on="ss_sold_date_sk").join(store, on="ss_store_sk"))
    days = ["sun", "mon", "tue", "wed", "thu", "fri", "sat"]
    aggs = [F.sum(F.when(c("d_dow") == F.lit(i), c("ss_sales_price")))
            .alias(f"{d}_sales")
            for i, d in enumerate(days)]
    return (j.group_by(c("s_store_name")).agg(*aggs)
            .sort(c("s_store_name")).limit(100))


def q96(dfs):
    """Count of evening high-dependent-count sales at one store
    (TPC-DS q96)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    hd = (dfs["household_demographics"]
          .filter(c("hd_dep_count") == F.lit(5))
          .select(c("hd_demo_sk").alias("ss_hdemo_sk")))
    td = (dfs["time_dim"]
          .filter((c("t_hour") == F.lit(20)) & (c("t_minute") >= F.lit(30)))
          .select(c("t_time_sk").alias("ss_sold_time_sk")))
    store = (dfs["store"].filter(c("s_store_name") == F.lit("store0"))
             .select(c("s_store_sk").alias("ss_store_sk")))
    j = (dfs["store_sales"]
         .select(c("ss_hdemo_sk"), c("ss_sold_time_sk"), c("ss_store_sk"))
         .join(hd, on="ss_hdemo_sk").join(td, on="ss_sold_time_sk")
         .join(store, on="ss_store_sk"))
    return j.agg(F.count().alias("cnt"))


def _ticket_counts(dfs, dep_lo, dep_hi, cnt_lo, cnt_hi, years):
    """The q34/q73 spine: tickets by customer with household filters and a
    HAVING on the per-ticket row count."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    dd = (dfs["date_dim"]
          .filter(c("d_year").isin(*years)
                  & ((c("d_dom") >= F.lit(1)) & (c("d_dom") <= F.lit(3))
                     | (c("d_dom") >= F.lit(25)) & (c("d_dom") <= F.lit(28))))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    hd = (dfs["household_demographics"]
          .filter((c("hd_dep_count") >= F.lit(dep_lo))
                  & (c("hd_dep_count") <= F.lit(dep_hi))
                  & (c("hd_buy_potential") != F.lit("Unknown")))
          .select(c("hd_demo_sk").alias("ss_hdemo_sk")))
    grouped = (dfs["store_sales"]
               .select(c("ss_sold_date_sk"), c("ss_hdemo_sk"),
                       c("ss_customer_sk"), c("ss_ticket_number"))
               .join(dd, on="ss_sold_date_sk").join(hd, on="ss_hdemo_sk")
               .group_by(c("ss_ticket_number"), c("ss_customer_sk"))
               .agg(F.count().alias("cnt"))
               .filter((c("cnt") >= F.lit(cnt_lo))
                       & (c("cnt") <= F.lit(cnt_hi))))
    cust = dfs["customer"].select(c("c_customer_sk").alias("ss_customer_sk"),
                                  c("c_first_name"), c("c_last_name"))
    return (grouped.join(cust, on="ss_customer_sk")
            .select(c("c_last_name"), c("c_first_name"),
                    c("ss_ticket_number"), c("cnt")))


def q34(dfs):
    """Large-ticket frequent shoppers (TPC-DS q34: 15-20 items/ticket)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    return (_ticket_counts(dfs, 2, 9, 15, 20, (1999, 2000, 2001))
            .sort(c("c_last_name"), c("c_first_name"),
                  c("ss_ticket_number"), c("cnt"),
                  ascending=[True, True, True, False]))


def q73(dfs):
    """Small-ticket shoppers (TPC-DS q73: 1-5 items/ticket)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    # official text orders by (cnt desc, last name) only; the extra
    # first-name/ticket keys make tie order deterministic for the oracle
    return (_ticket_counts(dfs, 1, 9, 1, 5, (1999, 2000, 2001))
            .sort(c("cnt"), c("c_last_name"), c("c_first_name"),
                  c("ss_ticket_number"),
                  ascending=[False, True, True, True])
            .limit(1000))


def q79(dfs):
    """Per-ticket coupon amount and net profit for big stores on Mondays
    (TPC-DS q79; ss_net_profit is decimal(7,2) — exact sums)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    dd = (dfs["date_dim"]
          .filter((c("d_dow") == F.lit(1))
                  & c("d_year").isin(1998, 1999, 2000))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    hd = (dfs["household_demographics"]
          .filter((c("hd_dep_count") == F.lit(6))
                  | (c("hd_vehicle_count") > F.lit(2)))
          .select(c("hd_demo_sk").alias("ss_hdemo_sk")))
    store = (dfs["store"]
             .filter((c("s_number_employees") >= F.lit(200))
                     & (c("s_number_employees") <= F.lit(295)))
             .select(c("s_store_sk").alias("ss_store_sk"), c("s_city")))
    grouped = (dfs["store_sales"]
               .select(c("ss_sold_date_sk"), c("ss_hdemo_sk"),
                       c("ss_store_sk"), c("ss_customer_sk"),
                       c("ss_ticket_number"), c("ss_coupon_amt"),
                       c("ss_net_profit"))
               .join(dd, on="ss_sold_date_sk").join(hd, on="ss_hdemo_sk")
               .join(store, on="ss_store_sk")
               .group_by(c("ss_ticket_number"), c("ss_customer_sk"),
                         c("s_city"))
               .agg(F.sum(c("ss_coupon_amt")).alias("amt"),
                    F.sum(c("ss_net_profit")).alias("profit")))
    cust = dfs["customer"].select(c("c_customer_sk").alias("ss_customer_sk"),
                                  c("c_last_name"), c("c_first_name"))
    return (grouped.join(cust, on="ss_customer_sk")
            .select(c("c_last_name"), c("c_first_name"), c("s_city"),
                    c("profit"), c("ss_ticket_number"), c("amt"))
            .sort(c("c_last_name"), c("c_first_name"), c("s_city"),
                  c("profit"))
            .limit(100))


def q48(dfs):
    """Quantity sum under OR'd demographic/address/price-band predicates
    (TPC-DS q48; the ss_net_profit bands hit the decimal column)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    dd = (dfs["date_dim"].filter(c("d_year") == F.lit(2000))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    cd = (dfs["customer_demographics"]
          .select(c("cd_demo_sk").alias("ss_cdemo_sk"),
                  c("cd_marital_status"), c("cd_education_status")))
    ca = (dfs["customer_address"]
          .filter(c("ca_country") == F.lit("United States"))
          .select(c("ca_address_sk").alias("ss_addr_sk"), c("ca_state")))
    j = (dfs["store_sales"]
         .select(c("ss_sold_date_sk"), c("ss_cdemo_sk"), c("ss_addr_sk"),
                 c("ss_quantity"), c("ss_sales_price"), c("ss_net_profit"))
         .join(dd, on="ss_sold_date_sk").join(cd, on="ss_cdemo_sk")
         .join(ca, on="ss_addr_sk"))
    price = c("ss_sales_price")
    md = (((c("cd_marital_status") == F.lit("M"))
           & (c("cd_education_status") == F.lit("4 yr Degree"))
           & (price >= F.lit(100.0)) & (price <= F.lit(150.0)))
          | ((c("cd_marital_status") == F.lit("D"))
             & (c("cd_education_status") == F.lit("2 yr Degree"))
             & (price >= F.lit(50.0)) & (price <= F.lit(100.0)))
          | ((c("cd_marital_status") == F.lit("S"))
             & (c("cd_education_status") == F.lit("College"))
             & (price >= F.lit(150.0)) & (price <= F.lit(200.0))))
    profit = c("ss_net_profit")
    geo = ((c("ca_state").isin("CA", "TX", "OH")
            & (profit >= F.lit(0)) & (profit <= F.lit(2000)))
           | (c("ca_state").isin("NY", "GA", "WA")
              & (profit >= F.lit(150)) & (profit <= F.lit(3000)))
           | (c("ca_state").isin("IL", "MI")
              & (profit >= F.lit(50)) & (profit <= F.lit(25000))))
    return j.filter(md & geo).agg(F.sum(c("ss_quantity")).alias("total"))


def q27(dfs):
    """Item averages by state for one demographic slice (TPC-DS q27's base
    grouping — the subset omits the ROLLUP levels)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    cd = (dfs["customer_demographics"]
          .filter((c("cd_gender") == F.lit("F"))
                  & (c("cd_marital_status") == F.lit("W"))
                  & (c("cd_education_status") == F.lit("Primary")))
          .select(c("cd_demo_sk").alias("ss_cdemo_sk")))
    dd = (dfs["date_dim"].filter(c("d_year") == F.lit(1999))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    store = (dfs["store"].filter(c("s_state").isin("CA", "TX", "NY", "OH"))
             .select(c("s_store_sk").alias("ss_store_sk"), c("s_state")))
    item = dfs["item"].select(c("i_item_sk").alias("ss_item_sk"),
                              c("i_item_id"))
    j = (dfs["store_sales"]
         .join(cd, on="ss_cdemo_sk").join(dd, on="ss_sold_date_sk")
         .join(store, on="ss_store_sk").join(item, on="ss_item_sk"))
    return (j.group_by(c("i_item_id"), c("s_state"))
            .agg(F.avg(c("ss_quantity")).alias("agg1"),
                 F.avg(c("ss_list_price")).alias("agg2"),
                 F.avg(c("ss_coupon_amt")).alias("agg3"),
                 F.avg(c("ss_sales_price")).alias("agg4"))
            .sort(c("i_item_id"), c("s_state"))
            .limit(100))


def q46(dfs):
    """Weekend city shoppers whose bought-city differs from home city
    (TPC-DS q46)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    dd = (dfs["date_dim"]
          .filter(c("d_dow").isin(0, 6) & c("d_year").isin(1999, 2000, 2001))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    hd = (dfs["household_demographics"]
          .filter((c("hd_dep_count") == F.lit(5))
                  | (c("hd_vehicle_count") == F.lit(3)))
          .select(c("hd_demo_sk").alias("ss_hdemo_sk")))
    store = (dfs["store"]
             .filter(c("s_city").isin("Midway", "Fairview", "Oakland"))
             .select(c("s_store_sk").alias("ss_store_sk")))
    sale_addr = dfs["customer_address"].select(
        c("ca_address_sk").alias("ss_addr_sk"),
        c("ca_city").alias("bought_city"))
    grouped = (dfs["store_sales"]
               .select(c("ss_sold_date_sk"), c("ss_hdemo_sk"),
                       c("ss_store_sk"), c("ss_addr_sk"),
                       c("ss_customer_sk"), c("ss_ticket_number"),
                       c("ss_coupon_amt"), c("ss_ext_sales_price"))
               .join(dd, on="ss_sold_date_sk").join(hd, on="ss_hdemo_sk")
               .join(store, on="ss_store_sk").join(sale_addr, on="ss_addr_sk")
               .group_by(c("ss_ticket_number"), c("ss_customer_sk"),
                         c("bought_city"))
               .agg(F.sum(c("ss_coupon_amt")).alias("amt"),
                    F.sum(c("ss_ext_sales_price")).alias("profit")))
    cust = dfs["customer"].select(
        c("c_customer_sk").alias("ss_customer_sk"), c("c_first_name"),
        c("c_last_name"), c("c_current_addr_sk").alias("ca_address_sk"))
    home = dfs["customer_address"].select(c("ca_address_sk"),
                                          c("ca_city"))
    return (grouped.join(cust, on="ss_customer_sk")
            .join(home, on="ca_address_sk")
            .filter(c("ca_city") != c("bought_city"))
            .select(c("c_last_name"), c("c_first_name"), c("ca_city"),
                    c("bought_city"), c("ss_ticket_number"), c("amt"),
                    c("profit"))
            .sort(c("c_last_name"), c("c_first_name"), c("ca_city"),
                  c("bought_city"), c("ss_ticket_number"))
            .limit(100))


def q68(dfs):
    """q46's shape over ext list price / ext tax (TPC-DS q68)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    dd = (dfs["date_dim"]
          .filter((c("d_dom") >= F.lit(1)) & (c("d_dom") <= F.lit(2))
                  & c("d_year").isin(1998, 1999, 2000))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    hd = (dfs["household_demographics"]
          .filter((c("hd_dep_count") == F.lit(4))
                  | (c("hd_vehicle_count") == F.lit(3)))
          .select(c("hd_demo_sk").alias("ss_hdemo_sk")))
    store = (dfs["store"]
             .filter(c("s_city").isin("Midway", "Fairview"))
             .select(c("s_store_sk").alias("ss_store_sk")))
    sale_addr = dfs["customer_address"].select(
        c("ca_address_sk").alias("ss_addr_sk"),
        c("ca_city").alias("bought_city"))
    grouped = (dfs["store_sales"]
               .select(c("ss_sold_date_sk"), c("ss_hdemo_sk"),
                       c("ss_store_sk"), c("ss_addr_sk"),
                       c("ss_customer_sk"), c("ss_ticket_number"),
                       c("ss_ext_sales_price"), c("ss_ext_list_price"),
                       c("ss_ext_tax"))
               .join(dd, on="ss_sold_date_sk").join(hd, on="ss_hdemo_sk")
               .join(store, on="ss_store_sk").join(sale_addr, on="ss_addr_sk")
               .group_by(c("ss_ticket_number"), c("ss_customer_sk"),
                         c("bought_city"))
               .agg(F.sum(c("ss_ext_sales_price")).alias("extended_price"),
                    F.sum(c("ss_ext_list_price")).alias("list_price"),
                    F.sum(c("ss_ext_tax")).alias("extended_tax")))
    cust = dfs["customer"].select(
        c("c_customer_sk").alias("ss_customer_sk"), c("c_first_name"),
        c("c_last_name"), c("c_current_addr_sk").alias("ca_address_sk"))
    home = dfs["customer_address"].select(c("ca_address_sk"), c("ca_city"))
    return (grouped.join(cust, on="ss_customer_sk")
            .join(home, on="ca_address_sk")
            .filter(c("ca_city") != c("bought_city"))
            .select(c("c_last_name"), c("c_first_name"), c("ca_city"),
                    c("bought_city"), c("ss_ticket_number"),
                    c("extended_price"), c("extended_tax"), c("list_price"))
            .sort(c("c_last_name"), c("ss_ticket_number"))
            .limit(100))


def q6(dfs):
    """Customer states buying items priced over 1.2x their category average
    (TPC-DS q6; the correlated avg subquery is planned as a category-average
    join, as Spark itself rewrites it)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    cat_avg = (dfs["item"]
               .group_by(c("i_category"))
               .agg(F.avg(c("i_current_price")).alias("cat_avg")))
    item = (dfs["item"]
            .select(c("i_item_sk").alias("ss_item_sk"), c("i_category"),
                    c("i_current_price"))
            .join(cat_avg, on="i_category")
            .filter(c("i_current_price") > F.lit(1.2) * c("cat_avg"))
            .select(c("ss_item_sk")))
    dd = (dfs["date_dim"]
          .filter((c("d_year") == F.lit(2000)) & (c("d_moy") == F.lit(1)))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    cust = dfs["customer"].select(
        c("c_customer_sk").alias("ss_customer_sk"),
        c("c_current_addr_sk").alias("ca_address_sk"))
    addr = dfs["customer_address"].select(c("ca_address_sk"), c("ca_state"))
    j = (dfs["store_sales"]
         .select(c("ss_sold_date_sk"), c("ss_item_sk"), c("ss_customer_sk"))
         .join(dd, on="ss_sold_date_sk").join(item, on="ss_item_sk")
         .join(cust, on="ss_customer_sk").join(addr, on="ca_address_sk"))
    return (j.group_by(c("ca_state"))
            .agg(F.count().alias("cnt"))
            .filter(c("cnt") >= F.lit(10))
            .sort(c("cnt"), c("ca_state"))
            .limit(100))


def q65(dfs):
    """Store items whose revenue is at most 10% of the store's average item
    revenue (TPC-DS q65: two aggregations joined)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    dd = (dfs["date_dim"].filter(c("d_year") == F.lit(2000))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    per_item = (dfs["store_sales"]
                .select(c("ss_sold_date_sk"), c("ss_store_sk"),
                        c("ss_item_sk"), c("ss_sales_price"))
                .join(dd, on="ss_sold_date_sk")
                .group_by(c("ss_store_sk"), c("ss_item_sk"))
                .agg(F.sum(c("ss_sales_price")).alias("revenue")))
    per_store = (per_item.group_by(c("ss_store_sk"))
                 .agg(F.avg(c("revenue")).alias("ave")))
    store = dfs["store"].select(c("s_store_sk").alias("ss_store_sk"),
                                c("s_store_name"))
    item = dfs["item"].select(c("i_item_sk").alias("ss_item_sk"),
                              c("i_item_desc"), c("i_current_price"))
    return (per_item.join(per_store, on="ss_store_sk")
            .filter(c("revenue") <= F.lit(0.1) * c("ave"))
            .join(store, on="ss_store_sk").join(item, on="ss_item_sk")
            .select(c("s_store_name"), c("i_item_desc"), c("revenue"),
                    c("i_current_price"))
            .sort(c("s_store_name"), c("i_item_desc"))
            .limit(100))


def _win(df, fn, value_col, part_cols, out_name):
    """fn(value) over (partition by part_cols) with a full-partition frame:
    the q53/q63/q89 window avg and q98's window sum (``fn`` is ``F.avg`` or
    ``F.sum``)."""
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.expr import windows as WX
    spec = WX.WindowSpec(tuple(E.col(p) for p in part_cols), (),
                         WX.WindowFrame("rows", None, None))
    return df.window([E.Alias(
        WX.WindowExpression(fn(E.col(value_col)), spec), out_name)])


def q53(dfs):
    """Quarterly manufacturer sales vs their window average (TPC-DS q53:
    sum by manufact x quarter, avg OVER (PARTITION BY i_manufact_id),
    keep quarters deviating >10%)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    item = (dfs["item"]
            .filter(c("i_category").isin("Books", "Home", "Electronics"))
            .select(c("i_item_sk").alias("ss_item_sk"), c("i_manufact_id")))
    dd = (dfs["date_dim"].filter(c("d_year") == F.lit(2000))
          .select(c("d_date_sk").alias("ss_sold_date_sk"), c("d_qoy")))
    store = dfs["store"].select(c("s_store_sk").alias("ss_store_sk"))
    base = (dfs["store_sales"]
            .select(c("ss_item_sk"), c("ss_sold_date_sk"), c("ss_store_sk"),
                    c("ss_sales_price"))
            .join(item, on="ss_item_sk").join(dd, on="ss_sold_date_sk")
            .join(store, on="ss_store_sk")
            .group_by(c("i_manufact_id"), c("d_qoy"))
            .agg(F.sum(c("ss_sales_price")).alias("sum_sales")))
    w = _win(base, F.avg, "sum_sales", ["i_manufact_id"],
             "avg_quarterly_sales")
    return (w.filter((c("avg_quarterly_sales") > F.lit(0.0))
                     & (F.abs(c("sum_sales") - c("avg_quarterly_sales"))
                        / c("avg_quarterly_sales") > F.lit(0.1)))
            .select(c("i_manufact_id"), c("sum_sales"),
                    c("avg_quarterly_sales"))
            .sort(c("avg_quarterly_sales"), c("sum_sales"),
                  c("i_manufact_id"))
            .limit(100))


def q63(dfs):
    """Monthly manager sales vs their window average (TPC-DS q63 — q53's
    shape with i_manager_id and d_moy)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    item = (dfs["item"]
            .filter(c("i_category").isin("Books", "Home", "Electronics"))
            .select(c("i_item_sk").alias("ss_item_sk"), c("i_manager_id")))
    dd = (dfs["date_dim"].filter(c("d_year") == F.lit(2000))
          .select(c("d_date_sk").alias("ss_sold_date_sk"), c("d_moy")))
    base = (dfs["store_sales"]
            .select(c("ss_item_sk"), c("ss_sold_date_sk"),
                    c("ss_sales_price"))
            .join(item, on="ss_item_sk").join(dd, on="ss_sold_date_sk")
            .group_by(c("i_manager_id"), c("d_moy"))
            .agg(F.sum(c("ss_sales_price")).alias("sum_sales")))
    w = _win(base, F.avg, "sum_sales", ["i_manager_id"], "avg_monthly_sales")
    return (w.filter((c("avg_monthly_sales") > F.lit(0.0))
                     & (F.abs(c("sum_sales") - c("avg_monthly_sales"))
                        / c("avg_monthly_sales") > F.lit(0.1)))
            .select(c("i_manager_id"), c("sum_sales"),
                    c("avg_monthly_sales"))
            .sort(c("i_manager_id"), c("avg_monthly_sales"), c("sum_sales"))
            .limit(100))


def q89(dfs):
    """Monthly class sales per store vs the (category, brand, store) window
    average (TPC-DS q89)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    item = (dfs["item"]
            .filter(c("i_category").isin("Books", "Electronics", "Sports"))
            .select(c("i_item_sk").alias("ss_item_sk"), c("i_category"),
                    c("i_class"), c("i_brand")))
    dd = (dfs["date_dim"].filter(c("d_year") == F.lit(1999))
          .select(c("d_date_sk").alias("ss_sold_date_sk"), c("d_moy")))
    store = dfs["store"].select(c("s_store_sk").alias("ss_store_sk"),
                                c("s_store_name"))
    base = (dfs["store_sales"]
            .select(c("ss_item_sk"), c("ss_sold_date_sk"), c("ss_store_sk"),
                    c("ss_sales_price"))
            .join(item, on="ss_item_sk").join(dd, on="ss_sold_date_sk")
            .join(store, on="ss_store_sk")
            .group_by(c("i_category"), c("i_class"), c("i_brand"),
                      c("s_store_name"), c("d_moy"))
            .agg(F.sum(c("ss_sales_price")).alias("sum_sales")))
    w = _win(base, F.avg, "sum_sales",
             ["i_category", "i_brand", "s_store_name"], "avg_monthly_sales")
    return (w.filter((c("avg_monthly_sales") != F.lit(0.0))
                     & (F.abs(c("sum_sales") - c("avg_monthly_sales"))
                        / c("avg_monthly_sales") > F.lit(0.1)))
            .select(c("i_category"), c("i_class"), c("i_brand"),
                    c("s_store_name"), c("d_moy"), c("sum_sales"),
                    c("avg_monthly_sales"))
            .sort((c("sum_sales") - c("avg_monthly_sales")).alias("_d"),
                  c("s_store_name"), c("i_class"), c("d_moy"))
            .limit(100))


def q98(dfs):
    """Class revenue ratio (TPC-DS q98): item revenue and its share of the
    class total via SUM OVER (PARTITION BY i_class)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    item = (dfs["item"]
            .filter(c("i_category").isin("Sports", "Books", "Home"))
            .select(c("i_item_sk").alias("ss_item_sk"), c("i_item_id"),
                    c("i_item_desc"), c("i_category"), c("i_class"),
                    c("i_current_price")))
    dd = (dfs["date_dim"]
          .filter((c("d_year") == F.lit(1999)) & (c("d_moy") == F.lit(2)))
          .select(c("d_date_sk").alias("ss_sold_date_sk")))
    base = (dfs["store_sales"]
            .select(c("ss_item_sk"), c("ss_sold_date_sk"),
                    c("ss_ext_sales_price"))
            .join(item, on="ss_item_sk").join(dd, on="ss_sold_date_sk")
            .group_by(c("i_item_id"), c("i_item_desc"), c("i_category"),
                      c("i_class"), c("i_current_price"))
            .agg(F.sum(c("ss_ext_sales_price")).alias("itemrevenue")))
    w = _win(base, F.sum, "itemrevenue", ["i_class"], "class_revenue")
    return (w.select(c("i_item_id"), c("i_item_desc"), c("i_category"),
                     c("i_class"), c("i_current_price"), c("itemrevenue"),
                     (c("itemrevenue") * F.lit(100.0) / c("class_revenue"))
                     .alias("revenueratio"))
            .sort(c("i_category"), c("i_class"), c("i_item_id"),
                  c("i_item_desc"), c("revenueratio")))


def q88(dfs):
    """Half-hour traffic counts 8:30-12:30 (TPC-DS q88: eight filtered
    counts cross-joined into one row)."""
    import spark_rapids_tpu_torch.functions as F
    c = F.col
    hd = (dfs["household_demographics"]
          .filter(((c("hd_dep_count") == F.lit(3))
                   & (c("hd_vehicle_count") <= F.lit(5)))
                  | ((c("hd_dep_count") == F.lit(0))
                     & (c("hd_vehicle_count") <= F.lit(2)))
                  | ((c("hd_dep_count") == F.lit(1))
                     & (c("hd_vehicle_count") <= F.lit(3))))
          .select(c("hd_demo_sk").alias("ss_hdemo_sk")))
    store = (dfs["store"].filter(c("s_store_name") == F.lit("store0"))
             .select(c("s_store_sk").alias("ss_store_sk")))
    base = (dfs["store_sales"]
            .select(c("ss_hdemo_sk"), c("ss_sold_time_sk"), c("ss_store_sk"))
            .join(hd, on="ss_hdemo_sk").join(store, on="ss_store_sk"))

    td = dfs["time_dim"]
    out = None
    for i in range(8):
        hour = 8 + (i + 1) // 2
        lo_min = 30 if i % 2 == 0 else 0
        t = (td.filter((c("t_hour") == F.lit(hour))
                       & (c("t_minute") >= F.lit(lo_min))
                       & (c("t_minute") < F.lit(lo_min + 30)))
             .select(c("t_time_sk").alias("ss_sold_time_sk")))
        cnt = (base.join(t, on="ss_sold_time_sk")
               .agg(F.count().alias(f"h{i}")))
        out = cnt if out is None else out.join(cnt, how="cross")
    return out


QUERIES = {"q3": q3, "q42": q42, "q52": q52, "q55": q55, "q7": q7,
           "q19": q19, "q6": q6, "q27": q27, "q34": q34, "q43": q43,
           "q46": q46, "q48": q48, "q65": q65, "q68": q68, "q73": q73,
           "q79": q79, "q96": q96, "q53": q53, "q63": q63, "q89": q89,
           "q98": q98, "q88": q88}


# -- independent NumPy oracles ------------------------------------------------

def load_np(paths: dict) -> dict:
    from spark_rapids_tpu_torch.benchmarks.common import load_np as _load_np
    return _load_np(paths)


def _lex_top(rows, keys, ascending, limit):
    """Sort list-of-tuples rows by (key index, asc) spec, take limit."""
    import functools

    def cmp(a, b):
        for k, asc in zip(keys, ascending):
            if a[k] != b[k]:
                lt = a[k] < b[k]
                return (-1 if lt else 1) if asc else (1 if lt else -1)
        return 0
    return sorted(rows, key=functools.cmp_to_key(cmp))[:limit]


def _star_np(tb, moy, year=None):
    """Filtered fact rows: (item_sk, d_year, price) after the date join."""
    dd = tb["date_dim"]
    keep_d = dd["d_moy"] == moy
    if year is not None:
        keep_d &= dd["d_year"] == year
    year_of = dict(zip(dd["d_date_sk"][keep_d], dd["d_year"][keep_d]))
    ss = tb["store_sales"]
    out = []
    for dsk, isk, p in zip(ss["ss_sold_date_sk"], ss["ss_item_sk"],
                           ss["ss_ext_sales_price"]):
        y = year_of.get(dsk)
        if y is not None:
            out.append((isk, int(y), p))
    return out


def _rollup(tb, item_keep, moy, year, key_of):
    """Sum price grouped by (d_year, key_of(item_row)) over the star spine."""
    it = tb["item"]
    idx = {k: i for i, k in enumerate(it["i_item_sk"])}
    sums = {}
    for isk, y, p in _star_np(tb, moy, year):
        i = idx[isk]
        if not item_keep[i]:
            continue
        key = (y,) + key_of(it, i)
        sums[key] = sums.get(key, 0.0) + p
    return [key + (v,) for key, v in sums.items()]


def _brand_key(it, i):
    return (int(it["i_brand_id"][i]), it["i_brand"][i])


def np_q3(tb):
    keep = tb["item"]["i_manufact_id"] == 128
    rows = _rollup(tb, keep, 11, None, _brand_key)
    return _lex_top(rows, [0, 3, 1], [True, False, True], 100)


def np_q42(tb):
    keep = tb["item"]["i_manager_id"] == 1
    rows = _rollup(tb, keep, 11, 2000,
                   lambda it, i: (int(it["i_category_id"][i]),
                                  it["i_category"][i]))
    return _lex_top(rows, [3, 0, 1], [False, True, True], 100)


def np_q52(tb):
    keep = tb["item"]["i_manager_id"] == 1
    rows = _rollup(tb, keep, 11, 2000, _brand_key)
    return _lex_top(rows, [0, 3, 1], [True, False, True], 100)


def np_q55(tb):
    keep = tb["item"]["i_manager_id"] == 28
    rows = _rollup(tb, keep, 11, 1999, _brand_key)
    rows = [(bid, b, v) for (_y, bid, b, v) in rows]
    return _lex_top(rows, [2, 0], [False, True], 100)


def _np_demo_promo(tb, fact, dcol, icol, cdcol, prcol, qcol, lpcol,
                   cacol, spcol):
    """q7/q26 skeleton: per-item averages for single/College males on
    non-email-or-non-event promotions in year 2000."""
    cd = tb["customer_demographics"]
    cd_ok = set(cd["cd_demo_sk"][(cd["cd_gender"] == "M")
                                 & (cd["cd_marital_status"] == "S")
                                 & (cd["cd_education_status"] == "College")])
    pr = tb["promotion"]
    pr_ok = set(pr["p_promo_sk"][(pr["p_channel_email"] == "N")
                                 | (pr["p_channel_event"] == "N")])
    dd_ok = _d(tb, d_year=lambda y: y == 2000)
    it = tb["item"]
    item_id = dict(zip(it["i_item_sk"], it["i_item_id"]))
    f = tb[fact]
    acc = {}
    for cdk, prk, ddk, ik, q, lp, ca, sp in zip(
            f[cdcol], f[prcol], f[dcol], f[icol], f[qcol], f[lpcol],
            f[cacol], f[spcol]):
        if cdk in cd_ok and prk in pr_ok and ddk in dd_ok:
            a = acc.setdefault(item_id[ik], [0, 0.0, 0.0, 0.0, 0.0])
            a[0] += 1
            a[1] += q
            a[2] += lp
            a[3] += ca
            a[4] += sp
    rows = [(iid, a[1] / a[0], a[2] / a[0], a[3] / a[0], a[4] / a[0])
            for iid, a in acc.items()]
    return _lex_top(rows, [0], [True], 100)


def np_q7(tb):
    return _np_demo_promo(tb, "store_sales", "ss_sold_date_sk",
                          "ss_item_sk", "ss_cdemo_sk", "ss_promo_sk",
                          "ss_quantity", "ss_list_price", "ss_coupon_amt",
                          "ss_sales_price")


def np_q19(tb):
    dd = tb["date_dim"]
    dd_ok = set(dd["d_date_sk"][(dd["d_year"] == 1999)
                                & (dd["d_moy"] == 11)])
    it = tb["item"]
    it_info = {k: (int(b), br, int(m)) for k, b, br, m, mg in zip(
        it["i_item_sk"], it["i_brand_id"], it["i_brand"],
        it["i_manufact_id"], it["i_manager_id"]) if mg == 8}
    cu = tb["customer"]
    cust_addr = dict(zip(cu["c_customer_sk"], cu["c_current_addr_sk"]))
    ca = tb["customer_address"]
    zip_of = dict(zip(ca["ca_address_sk"], ca["ca_zip"]))
    st = tb["store"]
    szip = dict(zip(st["s_store_sk"], st["s_zip"]))
    ss = tb["store_sales"]
    sums = {}
    for ddk, ik, ck, sk, p in zip(
            ss["ss_sold_date_sk"], ss["ss_item_sk"], ss["ss_customer_sk"],
            ss["ss_store_sk"], ss["ss_ext_sales_price"]):
        if ddk not in dd_ok or ik not in it_info:
            continue
        if zip_of[cust_addr[ck]] == szip[sk]:
            continue
        key = it_info[ik]
        sums[key] = sums.get(key, 0.0) + p
    rows = [(bid, b, m, s) for (bid, b, m), s in sums.items()]
    return _lex_top(rows, [3, 0], [False, True], 100)


def _d(tb, **conds):
    """date_dim selector: {d_date_sk} passing all column conditions."""
    dd = tb["date_dim"]
    keep = np.ones(len(dd["d_date_sk"]), bool)
    for col, fn in conds.items():
        keep &= fn(dd[col])
    return set(dd["d_date_sk"][keep])


def np_q43(tb):
    ok_d = tb["date_dim"]
    keep = ok_d["d_year"] == 2000
    dow_of = dict(zip(ok_d["d_date_sk"][keep], ok_d["d_dow"][keep]))
    st = tb["store"]
    sname = dict(zip(st["s_store_sk"], st["s_store_name"]))
    ss = tb["store_sales"]
    sums = {}
    for ddk, sk, p in zip(ss["ss_sold_date_sk"], ss["ss_store_sk"],
                          ss["ss_sales_price"]):
        dow = dow_of.get(ddk)
        if dow is None:
            continue
        # Spark sum over an empty/never-hit day is NULL, not 0.0
        row = sums.setdefault(sname[sk], [None] * 7)
        row[int(dow)] = (row[int(dow)] or 0.0) + p
    rows = [(n,) + tuple(v) for n, v in sums.items()]
    return _lex_top(rows, [0], [True], 100)


def np_q96(tb):
    hd = tb["household_demographics"]
    ok_hd = set(hd["hd_demo_sk"][hd["hd_dep_count"] == 5])
    td = tb["time_dim"]
    ok_t = set(td["t_time_sk"][(td["t_hour"] == 20)
                               & (td["t_minute"] >= 30)])
    st = tb["store"]
    ok_s = set(st["s_store_sk"][st["s_store_name"] == "store0"])
    ss = tb["store_sales"]
    n = 0
    for h, t, s in zip(ss["ss_hdemo_sk"], ss["ss_sold_time_sk"],
                       ss["ss_store_sk"]):
        if h in ok_hd and t in ok_t and s in ok_s:
            n += 1
    return [(n,)]


def _np_tickets(tb, dep_lo, dep_hi, cnt_lo, cnt_hi, years):
    ok_d = _d(tb, d_year=lambda y: np.isin(y, years),
              d_dom=lambda d: ((d >= 1) & (d <= 3)) | ((d >= 25) & (d <= 28)))
    hd = tb["household_demographics"]
    ok_hd = set(hd["hd_demo_sk"][
        (hd["hd_dep_count"] >= dep_lo) & (hd["hd_dep_count"] <= dep_hi)
        & (hd["hd_buy_potential"] != "Unknown")])
    ss = tb["store_sales"]
    counts = {}
    for ddk, h, ck, tk in zip(ss["ss_sold_date_sk"], ss["ss_hdemo_sk"],
                              ss["ss_customer_sk"], ss["ss_ticket_number"]):
        if ddk in ok_d and h in ok_hd:
            key = (int(tk), int(ck))
            counts[key] = counts.get(key, 0) + 1
    cu = tb["customer"]
    fn = dict(zip(cu["c_customer_sk"], cu["c_first_name"]))
    ln = dict(zip(cu["c_customer_sk"], cu["c_last_name"]))
    return [(ln[ck], fn[ck], tk, n) for (tk, ck), n in counts.items()
            if cnt_lo <= n <= cnt_hi]


def np_q34(tb):
    rows = _np_tickets(tb, 2, 9, 15, 20, (1999, 2000, 2001))
    return _lex_top(rows, [0, 1, 2, 3], [True, True, True, False],
                    len(rows))


def np_q73(tb):
    rows = _np_tickets(tb, 1, 9, 1, 5, (1999, 2000, 2001))
    return _lex_top(rows, [3, 0, 1, 2], [False, True, True, True], 1000)


def np_q79(tb):
    from decimal import Decimal
    ok_d = _d(tb, d_dow=lambda d: d == 1,
              d_year=lambda y: np.isin(y, (1998, 1999, 2000)))
    hd = tb["household_demographics"]
    ok_hd = set(hd["hd_demo_sk"][(hd["hd_dep_count"] == 6)
                                 | (hd["hd_vehicle_count"] > 2)])
    st = tb["store"]
    ok_s = {k: c for k, c, n in zip(st["s_store_sk"], st["s_city"],
                                    st["s_number_employees"])
            if 200 <= n <= 295}
    ss = tb["store_sales"]
    sums = {}
    for ddk, h, sk, ck, tk, amt, prof in zip(
            ss["ss_sold_date_sk"], ss["ss_hdemo_sk"], ss["ss_store_sk"],
            ss["ss_customer_sk"], ss["ss_ticket_number"],
            ss["ss_coupon_amt"], ss["ss_net_profit"]):
        if ddk not in ok_d or h not in ok_hd or sk not in ok_s:
            continue
        key = (int(tk), int(ck), ok_s[sk])
        cur = sums.get(key)
        if cur is None:
            sums[key] = [amt, prof]
        else:
            cur[0] += amt
            cur[1] += prof
    cu = tb["customer"]
    fn = dict(zip(cu["c_customer_sk"], cu["c_first_name"]))
    ln = dict(zip(cu["c_customer_sk"], cu["c_last_name"]))
    rows = [(ln[ck], fn[ck], city, v[1], tk, v[0])
            for (tk, ck, city), v in sums.items()]
    return _lex_top(rows, [0, 1, 2, 3], [True, True, True, True], 100)


def np_q48(tb):
    ok_d = _d(tb, d_year=lambda y: y == 2000)
    cd = tb["customer_demographics"]
    cd_info = {k: (m, e) for k, m, e in zip(
        cd["cd_demo_sk"], cd["cd_marital_status"],
        cd["cd_education_status"])}
    ca = tb["customer_address"]
    st_of = dict(zip(ca["ca_address_sk"], ca["ca_state"]))
    ss = tb["store_sales"]
    total = 0
    for ddk, cdk, ak, q, sp, prof in zip(
            ss["ss_sold_date_sk"], ss["ss_cdemo_sk"], ss["ss_addr_sk"],
            ss["ss_quantity"], ss["ss_sales_price"], ss["ss_net_profit"]):
        if ddk not in ok_d:
            continue
        m, e = cd_info[cdk]
        p = float(sp)
        md = ((m == "M" and e == "4 yr Degree" and 100.0 <= p <= 150.0)
              or (m == "D" and e == "2 yr Degree" and 50.0 <= p <= 100.0)
              or (m == "S" and e == "College" and 150.0 <= p <= 200.0))
        if not md:
            continue
        state = st_of[ak]
        pr = float(prof)
        geo = ((state in ("CA", "TX", "OH") and 0 <= pr <= 2000)
               or (state in ("NY", "GA", "WA") and 150 <= pr <= 3000)
               or (state in ("IL", "MI") and 50 <= pr <= 25000))
        if geo:
            total += int(q)
    return [(total,)]


def np_q27(tb):
    cd = tb["customer_demographics"]
    ok_cd = set(cd["cd_demo_sk"][(cd["cd_gender"] == "F")
                                 & (cd["cd_marital_status"] == "W")
                                 & (cd["cd_education_status"] == "Primary")])
    ok_d = _d(tb, d_year=lambda y: y == 1999)
    st = tb["store"]
    s_state = {k: s for k, s in zip(st["s_store_sk"], st["s_state"])
               if s in ("CA", "TX", "NY", "OH")}
    it = tb["item"]
    iid = dict(zip(it["i_item_sk"], it["i_item_id"]))
    ss = tb["store_sales"]
    acc = {}
    for ddk, cdk, sk, ik, q, lp, cam, sp in zip(
            ss["ss_sold_date_sk"], ss["ss_cdemo_sk"], ss["ss_store_sk"],
            ss["ss_item_sk"], ss["ss_quantity"], ss["ss_list_price"],
            ss["ss_coupon_amt"], ss["ss_sales_price"]):
        if ddk not in ok_d or cdk not in ok_cd or sk not in s_state:
            continue
        key = (iid[ik], s_state[sk])
        cur = acc.setdefault(key, [0.0, 0.0, 0.0, 0.0, 0])
        cur[0] += q
        cur[1] += lp
        cur[2] += cam
        cur[3] += sp
        cur[4] += 1
    rows = [key + tuple(v / c[4] for v in c[:4])
            for key, c in acc.items()]
    return _lex_top(rows, [0, 1], [True, True], 100)


def _np_city_tickets(tb, dfilter, hd_pred, cities, val_cols):
    ok_d = dfilter
    hd = tb["household_demographics"]
    ok_hd = set(hd["hd_demo_sk"][hd_pred(hd)])
    st = tb["store"]
    ok_s = set(k for k, cty in zip(st["s_store_sk"], st["s_city"])
               if cty in cities)
    ca = tb["customer_address"]
    city_of = dict(zip(ca["ca_address_sk"], ca["ca_city"]))
    ss = tb["store_sales"]
    sums = {}
    for i, (ddk, h, sk, ak, ck, tk) in enumerate(zip(
            ss["ss_sold_date_sk"], ss["ss_hdemo_sk"], ss["ss_store_sk"],
            ss["ss_addr_sk"], ss["ss_customer_sk"],
            ss["ss_ticket_number"])):
        if ddk not in ok_d or h not in ok_hd or sk not in ok_s:
            continue
        key = (int(tk), int(ck), city_of[ak])
        cur = sums.setdefault(key, [0.0] * len(val_cols))
        for j, colname in enumerate(val_cols):
            cur[j] += ss[colname][i]
    cu = tb["customer"]
    fn = dict(zip(cu["c_customer_sk"], cu["c_first_name"]))
    ln = dict(zip(cu["c_customer_sk"], cu["c_last_name"]))
    addr_of = dict(zip(cu["c_customer_sk"], cu["c_current_addr_sk"]))
    rows = []
    for (tk, ck, bought), v in sums.items():
        home = city_of[addr_of[ck]]
        if home == bought:
            continue
        rows.append((ln[ck], fn[ck], home, bought, tk) + tuple(v))
    return rows


def np_q46(tb):
    ok_d = _d(tb, d_dow=lambda d: np.isin(d, (0, 6)),
              d_year=lambda y: np.isin(y, (1999, 2000, 2001)))
    rows = _np_city_tickets(
        tb, ok_d,
        lambda hd: (hd["hd_dep_count"] == 5) | (hd["hd_vehicle_count"] == 3),
        ("Midway", "Fairview", "Oakland"),
        ["ss_coupon_amt", "ss_ext_sales_price"])
    return _lex_top(rows, [0, 1, 2, 3, 4], [True] * 5, 100)


def np_q68(tb):
    ok_d = _d(tb, d_dom=lambda d: (d >= 1) & (d <= 2),
              d_year=lambda y: np.isin(y, (1998, 1999, 2000)))
    rows = _np_city_tickets(
        tb, ok_d,
        lambda hd: (hd["hd_dep_count"] == 4) | (hd["hd_vehicle_count"] == 3),
        ("Midway", "Fairview"),
        ["ss_ext_sales_price", "ss_ext_tax", "ss_ext_list_price"])
    return _lex_top(rows, [0, 4], [True, True], 100)


def np_q6(tb):
    it = tb["item"]
    cat_sums = {}
    for cat, p in zip(it["i_category"], it["i_current_price"]):
        cur = cat_sums.setdefault(cat, [0.0, 0])
        cur[0] += p
        cur[1] += 1
    cat_avg = {c: s / n for c, (s, n) in cat_sums.items()}
    ok_item = set(
        k for k, cat, p in zip(it["i_item_sk"], it["i_category"],
                               it["i_current_price"])
        if p > 1.2 * cat_avg[cat])
    ok_d = _d(tb, d_year=lambda y: y == 2000, d_moy=lambda m: m == 1)
    cu = tb["customer"]
    addr_of = dict(zip(cu["c_customer_sk"], cu["c_current_addr_sk"]))
    ca = tb["customer_address"]
    state_of = dict(zip(ca["ca_address_sk"], ca["ca_state"]))
    ss = tb["store_sales"]
    counts = {}
    for ddk, ik, ck in zip(ss["ss_sold_date_sk"], ss["ss_item_sk"],
                           ss["ss_customer_sk"]):
        if ddk not in ok_d or ik not in ok_item:
            continue
        s = state_of[addr_of[ck]]
        counts[s] = counts.get(s, 0) + 1
    rows = [(s, n) for s, n in counts.items() if n >= 10]
    return _lex_top(rows, [1, 0], [True, True], 100)


def np_q65(tb):
    ok_d = _d(tb, d_year=lambda y: y == 2000)
    ss = tb["store_sales"]
    rev = {}
    for ddk, sk, ik, p in zip(ss["ss_sold_date_sk"], ss["ss_store_sk"],
                              ss["ss_item_sk"], ss["ss_sales_price"]):
        if ddk not in ok_d:
            continue
        key = (int(sk), int(ik))
        rev[key] = rev.get(key, 0.0) + p
    per_store = {}
    for (sk, ik), r in rev.items():
        cur = per_store.setdefault(sk, [0.0, 0])
        cur[0] += r
        cur[1] += 1
    ave = {sk: s / n for sk, (s, n) in per_store.items()}
    st = tb["store"]
    sname = dict(zip(st["s_store_sk"], st["s_store_name"]))
    it = tb["item"]
    idesc = dict(zip(it["i_item_sk"], it["i_item_desc"]))
    iprice = dict(zip(it["i_item_sk"], it["i_current_price"]))
    rows = [(sname[sk], idesc[ik], r, iprice[ik])
            for (sk, ik), r in rev.items() if r <= 0.1 * ave[sk]]
    return _lex_top(rows, [0, 1], [True, True], 100)


def _window_dev(groups, part_of, thresh=0.1, zero_ok=False):
    """q53/q63/q89 tail: per-partition mean over the AGGREGATED rows, keep
    rows deviating more than `thresh` from it. groups: {key: sum}. Returns
    [(key..., sum, avg)]."""
    parts = {}
    for key, s in groups.items():
        parts.setdefault(part_of(key), []).append(s)
    means = {p: sum(v) / len(v) for p, v in parts.items()}
    out = []
    for key, s in groups.items():
        a = means[part_of(key)]
        cond = (a != 0.0) if zero_ok else (a > 0.0)
        if cond and abs(s - a) / a > thresh:
            out.append(key + (s, a))
    return out


def np_q53(tb):
    it = tb["item"]
    ok_cat = np.isin(it["i_category"], ["Books", "Home", "Electronics"])
    manu = {k: int(m) for k, m, o in zip(it["i_item_sk"], it["i_manufact_id"],
                                         ok_cat) if o}
    dd = tb["date_dim"]
    keep = dd["d_year"] == 2000
    qoy_of = dict(zip(dd["d_date_sk"][keep], dd["d_qoy"][keep]))
    ss = tb["store_sales"]
    groups = {}
    for ddk, ik, p in zip(ss["ss_sold_date_sk"], ss["ss_item_sk"],
                          ss["ss_sales_price"]):
        q = qoy_of.get(ddk)
        m = manu.get(ik)
        if q is None or m is None:
            continue
        key = (m, int(q))
        groups[key] = groups.get(key, 0.0) + p
    dev = _window_dev(groups, lambda k: k[0])
    rows = [(d[0], d[-2], d[-1]) for d in dev]
    return _lex_top(rows, [2, 1, 0], [True, True, True], 100)


def np_q63(tb):
    it = tb["item"]
    ok_cat = np.isin(it["i_category"], ["Books", "Home", "Electronics"])
    mgr = {k: int(m) for k, m, o in zip(it["i_item_sk"], it["i_manager_id"],
                                        ok_cat) if o}
    dd = tb["date_dim"]
    keep = dd["d_year"] == 2000
    moy_of = dict(zip(dd["d_date_sk"][keep], dd["d_moy"][keep]))
    ss = tb["store_sales"]
    groups = {}
    for ddk, ik, p in zip(ss["ss_sold_date_sk"], ss["ss_item_sk"],
                          ss["ss_sales_price"]):
        mo = moy_of.get(ddk)
        m = mgr.get(ik)
        if mo is None or m is None:
            continue
        key = (m, int(mo))
        groups[key] = groups.get(key, 0.0) + p
    dev = _window_dev(groups, lambda k: k[0])
    rows = [(d[0], d[-2], d[-1]) for d in dev]
    return _lex_top(rows, [0, 2, 1], [True, True, True], 100)


def np_q89(tb):
    it = tb["item"]
    ok = np.isin(it["i_category"], ["Books", "Electronics", "Sports"])
    info = {k: (cat, cl, br) for k, cat, cl, br, o in zip(
        it["i_item_sk"], it["i_category"], it["i_class"], it["i_brand"], ok)
        if o}
    dd = tb["date_dim"]
    keep = dd["d_year"] == 1999
    moy_of = dict(zip(dd["d_date_sk"][keep], dd["d_moy"][keep]))
    st = tb["store"]
    sname = dict(zip(st["s_store_sk"], st["s_store_name"]))
    ss = tb["store_sales"]
    groups = {}
    for ddk, ik, sk, p in zip(ss["ss_sold_date_sk"], ss["ss_item_sk"],
                              ss["ss_store_sk"], ss["ss_sales_price"]):
        mo = moy_of.get(ddk)
        inf = info.get(ik)
        if mo is None or inf is None:
            continue
        key = (inf[0], inf[1], inf[2], sname[sk], int(mo))
        groups[key] = groups.get(key, 0.0) + p
    dev = _window_dev(groups, lambda k: (k[0], k[2], k[3]), zero_ok=True)
    rows = [d + (d[-2] - d[-1],) for d in dev]       # append sum-avg key
    rows = _lex_top(rows, [7, 3, 1, 4], [True, True, True, True], 100)
    return [r[:-1] for r in rows]


def np_q98(tb):
    """q98 = the revenue-ratio skeleton over store_sales, no LIMIT."""
    rows = _np_revenue_ratio(tb, "store_sales", "ss_sold_date_sk",
                             "ss_item_sk", "ss_ext_sales_price", None)
    return rows


def np_q88(tb):
    hd = tb["household_demographics"]
    ok_hd = set(hd["hd_demo_sk"][
        ((hd["hd_dep_count"] == 3) & (hd["hd_vehicle_count"] <= 5))
        | ((hd["hd_dep_count"] == 0) & (hd["hd_vehicle_count"] <= 2))
        | ((hd["hd_dep_count"] == 1) & (hd["hd_vehicle_count"] <= 3))])
    st = tb["store"]
    ok_s = set(st["s_store_sk"][st["s_store_name"] == "store0"])
    td = tb["time_dim"]
    hour_of = dict(zip(td["t_time_sk"],
                       zip(td["t_hour"], td["t_minute"])))
    counts = [0] * 8
    ss = tb["store_sales"]
    for h, t, s in zip(ss["ss_hdemo_sk"], ss["ss_sold_time_sk"],
                       ss["ss_store_sk"]):
        if h not in ok_hd or s not in ok_s:
            continue
        hh, mm = hour_of[t]
        for i in range(8):
            hour = 8 + (i + 1) // 2
            lo = 30 if i % 2 == 0 else 0
            if hh == hour and lo <= mm < lo + 30:
                counts[i] += 1
                break
    return [tuple(counts)]


def _np_revenue_ratio(tb, fact, dcol, icol, vcol, limit):
    """q98/q12/q20 skeleton: item revenue + class-partition revenue ratio."""
    it = tb["item"]
    ok = np.isin(it["i_category"], ["Sports", "Books", "Home"])
    info = {k: (iid, d, cat, cl, float(p)) for k, iid, d, cat, cl, p, o in
            zip(it["i_item_sk"], it["i_item_id"], it["i_item_desc"],
                it["i_category"], it["i_class"], it["i_current_price"], ok)
            if o}
    ok_d = _d(tb, d_year=lambda y: y == 1999, d_moy=lambda m: m == 2)
    f = tb[fact]
    groups = {}
    for ddk, ik, p in zip(f[dcol], f[icol], f[vcol]):
        inf = info.get(ik)
        if ddk not in ok_d or inf is None:
            continue
        groups[inf] = groups.get(inf, 0.0) + p
    cls_total = {}
    for key, s in groups.items():
        cls_total[key[3]] = cls_total.get(key[3], 0.0) + s
    rows = [key + (s, s * 100.0 / cls_total[key[3]])
            for key, s in groups.items()]
    return _lex_top(rows, [2, 3, 0, 1, 6],
                    [True, True, True, True, True], limit)


NP_QUERIES = {name: globals()[f"np_{name}"] for name in QUERIES}


# Per-query float-tolerance column indexes (the reference's FLOAT_COLS for
# these queries): value equality, exact on keys, integers and decimals,
# rel 1e-9 on the float slots
FLOAT_COLS = {
    "q3": {3}, "q42": {3}, "q52": {3}, "q55": {2}, "q7": {1, 2, 3, 4},
    "q19": {3}, "q6": set(), "q27": {2, 3, 4, 5}, "q34": set(),
    "q43": {1, 2, 3, 4, 5, 6, 7}, "q46": {5, 6}, "q48": set(),
    "q65": {2, 3}, "q68": {5, 6, 7}, "q73": set(), "q79": {5},
    "q96": set(), "q53": {1, 2}, "q63": {1, 2}, "q89": {5, 6},
    "q98": {4, 5, 6}, "q88": set(),
}


def check_rows(got, exp, float_cols, rel=1e-9):
    """Value-equality check (no pytest dependency). Raises AssertionError with
    the first mismatching row pair. Explicit raises (not bare asserts): the
    exception IS the contract, and must survive `python -O`."""
    import math as _math
    if len(got) != len(exp):
        raise AssertionError((len(got), len(exp)))
    for g, e in zip(got, exp):
        if len(g) != len(e):
            raise AssertionError((g, e))
        for i, (a, b) in enumerate(zip(g, e)):
            if i in float_cols and a is not None and b is not None:
                if not _math.isclose(a, b, rel_tol=rel, abs_tol=1e-12):
                    raise AssertionError((g, e))
            elif a != b:   # exact slot, or a NULL in a float slot
                raise AssertionError((g, e))


# -- oracles of the official SQL texts without a DataFrame twin ------------

def np_q13(tb):
    """Official q13 (SQL-only; states fitted to the generator domain)."""
    ok_d = _d(tb, d_year=lambda y: y == 2001)
    cd = tb["customer_demographics"]
    cd_ms = dict(zip(cd["cd_demo_sk"], cd["cd_marital_status"]))
    cd_ed = dict(zip(cd["cd_demo_sk"], cd["cd_education_status"]))
    hd = tb["household_demographics"]
    hd_dep = dict(zip(hd["hd_demo_sk"], hd["hd_dep_count"]))
    ca = tb["customer_address"]
    ca_st = {k: s for k, s, c in zip(ca["ca_address_sk"], ca["ca_state"],
                                     ca["ca_country"])
             if c == "United States"}
    ss = tb["store_sales"]
    n = cnt = 0
    sq = sp = sw = 0.0
    st_tab = tb["store"]
    ok_s = set(st_tab["s_store_sk"])
    for ddk, sk2, cdk, hdk, ak, q, spr, esp, ewc, npf in zip(
            ss["ss_sold_date_sk"], ss["ss_store_sk"], ss["ss_cdemo_sk"],
            ss["ss_hdemo_sk"], ss["ss_addr_sk"], ss["ss_quantity"],
            ss["ss_sales_price"], ss["ss_ext_sales_price"],
            ss["ss_ext_wholesale_cost"], ss["ss_net_profit"]):
        if ddk not in ok_d or sk2 not in ok_s:
            continue
        ms, ed, dep = cd_ms.get(cdk), cd_ed.get(cdk), hd_dep.get(hdk)
        demo = ((ms == "M" and ed == "Advanced Degree"
                 and 100.0 <= spr <= 200.0 and dep == 3)
                or (ms == "S" and ed == "College"
                    and 50.0 <= spr <= 150.0 and dep == 1)
                or (ms == "W" and ed == "2 yr Degree"
                    and 1.0 <= spr <= 100.0 and dep == 1))
        if not demo:
            continue
        st = ca_st.get(ak)
        prof = float(npf)
        geo = ((st in ("CA", "TX", "OH") and 0 <= prof <= 2000)
               or (st in ("NY", "GA", "WA") and 150 <= prof <= 3000)
               or (st in ("IL", "MI", "CA") and 50 <= prof <= 2500))
        if not geo:
            continue
        cnt += 1
        sq += int(q)
        sp += float(esp)
        sw += float(ewc)
    if cnt == 0:
        return []   # loud vacuity (the test asserts a non-empty oracle)
    return [(sq / cnt, sp / cnt, sw / cnt, sw)]


_Q15_ZIPS = {"10005", "10010", "10020", "10035", "10040", "10055", "10070",
             "10085", "10090"}


def np_q15(tb):
    """Official q15: catalog sales by customer zip — zip-list OR state OR
    high-price disjunction, Q2/2001."""
    cu, ca, cs = tb["customer"], tb["customer_address"], tb["catalog_sales"]
    azip = dict(zip(ca["ca_address_sk"], ca["ca_zip"]))
    astate = dict(zip(ca["ca_address_sk"], ca["ca_state"]))
    caddr = dict(zip(cu["c_customer_sk"], cu["c_current_addr_sk"]))
    ok_d = _d(tb, d_qoy=lambda q: q == 2, d_year=lambda y: y == 2001)
    sums = {}
    for dk, ck, p in zip(cs["cs_sold_date_sk"], cs["cs_bill_customer_sk"],
                         cs["cs_sales_price"]):
        if dk not in ok_d:
            continue
        a = caddr[ck]
        z, st = azip[a], astate[a]
        if z in _Q15_ZIPS or st in ("CA", "WA", "GA") or p > 150:
            sums[z] = sums.get(z, 0.0) + p
    return [(z, sums[z]) for z in sorted(sums)][:100]


def np_q61(tb):
    """Official q61: promoted vs total Books revenue at gmt -6, Nov 2000;
    output (promotions, total, 100*promotions/total as decimal)."""
    from decimal import Decimal, ROUND_HALF_UP
    ss, st, pr, cu, ca, it = (tb["store_sales"], tb["store"],
                              tb["promotion"], tb["customer"],
                              tb["customer_address"], tb["item"])
    ok_d = _d(tb, d_year=lambda y: y == 2000, d_moy=lambda m: m == 11)
    ok_s = set(st["s_store_sk"][st["s_gmt_offset"] == -6.0])
    ok_ca = set(ca["ca_address_sk"][ca["ca_gmt_offset"] == -6.0])
    ok_i = set(it["i_item_sk"][it["i_category"] == "Books"])
    ok_p = set(pr["p_promo_sk"][(pr["p_channel_dmail"] == "Y")
                                | (pr["p_channel_email"] == "Y")
                                | (pr["p_channel_tv"] == "Y")])
    caddr = dict(zip(cu["c_customer_sk"], cu["c_current_addr_sk"]))
    promo = total = 0.0
    for dk, sk, pk, ck, ik, v in zip(
            ss["ss_sold_date_sk"], ss["ss_store_sk"], ss["ss_promo_sk"],
            ss["ss_customer_sk"], ss["ss_item_sk"],
            ss["ss_ext_sales_price"]):
        if dk not in ok_d or sk not in ok_s or ik not in ok_i \
                or caddr[ck] not in ok_ca:
            continue
        total += v
        if pk in ok_p:
            promo += v
    # cast(double as decimal(15,4)) twice, then (15,4)/(15,4) -> the
    # DECIMAL64-adjusted (18,6) HALF_UP division of expr/arithmetic.py,
    # then *100 at the same scale; Spark: a sum over an empty relation is
    # NULL
    if total == 0.0:
        return [(None, None, None)]
    li = int(Decimal(repr(float(promo))).scaleb(4)
             .to_integral_value(ROUND_HALF_UP))
    ri = int(Decimal(repr(float(total))).scaleb(4)
             .to_integral_value(ROUND_HALF_UP))
    import math as _m
    q = float(li) / float(ri) * 1e6
    vals = int(_m.floor(q + 0.5) if q >= 0 else _m.ceil(q - 0.5))
    ratio = Decimal(vals * 100).scaleb(-6)
    return [(float(promo), float(total), ratio)]


def np_q97(tb):
    """Official q97: distinct (customer, item) pairs per channel over the
    month window; full-outer overlap counts."""
    lo, hi = 1200, 1211
    dd = tb["date_dim"]
    ok_d = set(dd["d_date_sk"][(dd["d_month_seq"] >= lo)
                               & (dd["d_month_seq"] <= hi)])
    ss, cs = tb["store_sales"], tb["catalog_sales"]
    s = {(c, i) for d, c, i in zip(ss["ss_sold_date_sk"],
                                   ss["ss_customer_sk"], ss["ss_item_sk"])
         if d in ok_d}
    c = {(cc, i) for d, cc, i in zip(cs["cs_sold_date_sk"],
                                     cs["cs_bill_customer_sk"],
                                     cs["cs_item_sk"]) if d in ok_d}
    return [(len(s - c), len(c - s), len(s & c))]


def np_q12(tb):
    """Official q12: q98's revenue-ratio shape over web_sales."""
    return _np_revenue_ratio(tb, "web_sales", "ws_sold_date_sk",
                             "ws_item_sk", "ws_ext_sales_price", 100)


def np_q20(tb):
    """Official q20: q98's revenue-ratio shape over catalog_sales."""
    return _np_revenue_ratio(tb, "catalog_sales", "cs_sold_date_sk",
                             "cs_item_sk", "cs_ext_sales_price", 100)


def np_q26(tb):
    """Official q26: q7's demographics/promotion shape over catalog_sales."""
    return _np_demo_promo(tb, "catalog_sales", "cs_sold_date_sk",
                          "cs_item_sk", "cs_bill_cdemo_sk", "cs_promo_sk",
                          "cs_quantity", "cs_list_price", "cs_coupon_amt",
                          "cs_sales_price")


# the official TPC-DS texts' own oracles: the reference's, copied
# (``spark_rapids_tpu/benchmarks/tpcds.py``)

def np_q27_rollup(tb):
    """Official q27 shape: GROUP BY ROLLUP (i_item_id, s_state) with
    grouping(s_state), ordered nulls-first asc (Spark default)."""
    cd = tb["customer_demographics"]
    ok_cd = set(cd["cd_demo_sk"][(cd["cd_gender"] == "F")
                                 & (cd["cd_marital_status"] == "W")
                                 & (cd["cd_education_status"] == "Primary")])
    ok_d = _d(tb, d_year=lambda y: y == 1999)
    st = tb["store"]
    s_state = {k: s for k, s in zip(st["s_store_sk"], st["s_state"])
               if s in ("CA", "TX", "NY", "OH")}
    it = tb["item"]
    iid = dict(zip(it["i_item_sk"], it["i_item_id"]))
    ss = tb["store_sales"]
    acc = {}
    for ddk, cdk, sk, ik, q, lp, cam, sp in zip(
            ss["ss_sold_date_sk"], ss["ss_cdemo_sk"], ss["ss_store_sk"],
            ss["ss_item_sk"], ss["ss_quantity"], ss["ss_list_price"],
            ss["ss_coupon_amt"], ss["ss_sales_price"]):
        if ddk not in ok_d or cdk not in ok_cd or sk not in s_state:
            continue
        for key, g in (((iid[ik], s_state[sk]), 0),
                       ((iid[ik], None), 1), ((None, None), 3)):
            cur = acc.setdefault((key, g), [0.0, 0.0, 0.0, 0.0, 0])
            cur[0] += q
            cur[1] += lp
            cur[2] += cam
            cur[3] += sp
            cur[4] += 1
    rows = [(k[0], k[1], g & 1) + tuple(v / c[4] for v in c[:4])
            for (k, g), c in acc.items()]
    # asc with nulls first on (i_item_id, s_state)
    rows.sort(key=lambda r: ((r[0] is not None, r[0] or ""),
                             (r[1] is not None, r[1] or "")))
    return rows[:100]


def np_q36(tb):
    """Official q36: gross-margin rollup over (i_category, i_class) with
    rank-within-parent (SQL-only)."""
    ok_d = _d(tb, d_year=lambda y: y == 2001)
    it = tb["item"]
    icat = dict(zip(it["i_item_sk"], it["i_category"]))
    icls = dict(zip(it["i_item_sk"], it["i_class"]))
    st = tb["store"]
    ok_s = set(st["s_store_sk"])     # all 8 generator states pass the filter
    ss = tb["store_sales"]
    acc = {}
    for ddk, ik, sk2, npf, esp in zip(
            ss["ss_sold_date_sk"], ss["ss_item_sk"], ss["ss_store_sk"],
            ss["ss_net_profit"], ss["ss_ext_sales_price"]):
        if ddk not in ok_d or sk2 not in ok_s:
            continue
        for key in ((icat[ik], icls[ik]), (icat[ik], None), (None, None)):
            cur = acc.setdefault(key, [0.0, 0.0])
            cur[0] += float(npf)
            cur[1] += float(esp)
    rows = []
    for (cat, cls), (np_s, sp_s) in acc.items():
        loch = (0 if cls is not None else 1 if cat is not None else 2)
        rows.append([np_s / sp_s, cat, cls, loch])
    # rank within (lochierarchy, parent category) by margin asc
    from collections import defaultdict
    parts = defaultdict(list)
    for r in rows:
        parts[(r[3], r[1] if r[3] == 0 else None)].append(r)
    for rs in parts.values():
        rs.sort(key=lambda r: r[0])
        rank, prev = 0, None
        for i, r in enumerate(rs):
            if prev is None or r[0] != prev:
                rank = i + 1
            r.append(rank)
            prev = r[0]
    def skey(r):
        margin, cat, cls, loch, rk = r
        case_cat = cat if loch == 0 else None
        return (-loch,
                (0, "") if case_cat is None else (1, case_cat),
                rk,
                (0, "") if cat is None else (1, cat),
                (0, "") if cls is None else (1, cls))
    rows.sort(key=skey)
    return [tuple(r) for r in rows[:100]]


def np_q28(tb):
    """q28 oracle: six list-price buckets (avg / count / count distinct of
    ss_list_price under quantity + price/coupon/wholesale disjunctions),
    cross-joined into one row. Official default substitution parameters."""
    ss = tb["store_sales"]
    lp = ss["ss_list_price"]
    qty = ss["ss_quantity"]
    cp = ss["ss_coupon_amt"]
    wc = ss["ss_wholesale_cost"]
    params = [(0, 5, 8, 459, 57), (6, 10, 90, 2323, 31),
              (11, 15, 142, 12214, 79), (16, 20, 135, 6071, 38),
              (21, 25, 122, 836, 17), (26, 30, 154, 7326, 7)]
    row = []
    for qlo, qhi, lp0, cp0, wc0 in params:
        m = ((qty >= qlo) & (qty <= qhi)
             & (((lp >= lp0) & (lp <= lp0 + 10))
                | ((cp >= cp0) & (cp <= cp0 + 1000))
                | ((wc >= wc0) & (wc <= wc0 + 20))))
        vals = lp[m]
        row.append(float(vals.mean()) if len(vals) else None)
        row.append(int(len(vals)))
        row.append(int(len(np.unique(vals))))
    return [tuple(row)]


def _names_dates(tb, fact, date_col, cust_col, lo=1200, hi=1211):
    """{(c_last_name, c_first_name, d_date)} for one sales channel within a
    d_month_seq window — the q38/q87 arm."""
    dd = tb["date_dim"]
    sel = (dd["d_month_seq"] >= lo) & (dd["d_month_seq"] <= hi)
    dmap = dict(zip(dd["d_date_sk"][sel].tolist(),
                    dd["d_date"][sel].tolist()))
    cu = tb["customer"]
    fn = dict(zip(cu["c_customer_sk"], cu["c_first_name"]))
    ln = dict(zip(cu["c_customer_sk"], cu["c_last_name"]))
    f = tb[fact]
    out = set()
    for dk, ck in zip(f[date_col].tolist(), f[cust_col].tolist()):
        d = dmap.get(dk)
        if d is not None:
            out.add((ln[ck], fn[ck], d))
    return out


def np_q38(tb):
    s = (_names_dates(tb, "store_sales", "ss_sold_date_sk", "ss_customer_sk")
         & _names_dates(tb, "catalog_sales", "cs_sold_date_sk",
                        "cs_bill_customer_sk")
         & _names_dates(tb, "web_sales", "ws_sold_date_sk",
                        "ws_bill_customer_sk"))
    return [(len(s),)]


def np_q87(tb):
    s = (_names_dates(tb, "store_sales", "ss_sold_date_sk", "ss_customer_sk")
         - _names_dates(tb, "catalog_sales", "cs_sold_date_sk",
                        "cs_bill_customer_sk")
         - _names_dates(tb, "web_sales", "ws_sold_date_sk",
                        "ws_bill_customer_sk"))
    return [(len(s),)]


_Q8_ZIPS = {"10000", "10005", "10010", "10015", "10020", "10025", "10030",
            "10035", "10040", "10045", "10050", "10055", "10060", "10065",
            "10070", "10075", "10080", "10085", "10090", "10095"}


def np_q8(tb):
    """Official q8: store net profit for stores whose 2-digit zip prefix
    matches a V1 zip — V1 = (literal zip list) INTERSECT (zips with > 4
    preferred customers). The inner join against V1 multiplies each sale by
    the number of matching V1 zips (official semantics)."""
    from collections import Counter
    ca, cu, st = tb["customer_address"], tb["customer"], tb["store"]
    z1 = {z for z in ca["ca_zip"] if z in _Q8_ZIPS}
    azip = dict(zip(ca["ca_address_sk"], ca["ca_zip"]))
    pref = cu["c_preferred_cust_flag"] == "Y"
    cnt = Counter(azip[a] for a in cu["c_current_addr_sk"][pref].tolist())
    v1 = z1 & {z for z, n in cnt.items() if n > 4}
    ok_d = _d(tb, d_qoy=lambda q: q == 2, d_year=lambda y: y == 1998)
    mult = {sk: sum(1 for z in v1 if z[:2] == zp[:2])
            for sk, zp in zip(st["s_store_sk"], st["s_zip"])}
    name = dict(zip(st["s_store_sk"], st["s_store_name"]))
    ss = tb["store_sales"]
    sums = {}
    for dk, sk, prof in zip(ss["ss_sold_date_sk"], ss["ss_store_sk"],
                            ss["ss_net_profit"]):
        m = mult.get(sk, 0)
        if dk not in ok_d or not m:
            continue
        key = name[sk]
        sums[key] = sums.get(key, 0) + prof * m
    return [(k, sums[k]) for k in sorted(sums)][:100]


def np_q14(tb):
    """Official q14 (iceberg, first variant): cross_items = items whose
    (brand, class, category) sold in ALL THREE channels in 1999-2001
    (INTERSECT), avg_sales = global q*lp mean over the channels (UNION ALL),
    per-channel Nov-2001 group sums over cross_items with an iceberg HAVING
    against avg_sales, then ROLLUP over (channel, brand, class, category)."""
    it = tb["item"]
    trip = {sk: (int(b), int(cl), int(ca)) for sk, b, cl, ca in zip(
        it["i_item_sk"], it["i_brand_id"], it["i_class_id"],
        it["i_category_id"])}
    ok_d = _d(tb, d_year=lambda y: (y >= 1999) & (y <= 2001))
    chans = [
        ("store", "store_sales", "ss_sold_date_sk", "ss_item_sk",
         "ss_quantity", "ss_list_price"),
        ("catalog", "catalog_sales", "cs_sold_date_sk", "cs_item_sk",
         "cs_quantity", "cs_list_price"),
        ("web", "web_sales", "ws_sold_date_sk", "ws_item_sk",
         "ws_quantity", "ws_list_price"),
    ]
    trips_sold, tot, n_all = [], 0.0, 0
    for _, t, dcol, icol, qcol, pcol in chans:
        f = tb[t]
        m = np.isin(f[dcol], list(ok_d))
        trips_sold.append({trip[sk] for sk in f[icol][m].tolist()})
        qp = f[qcol][m].astype(np.float64) * f[pcol][m]
        tot += float(qp.sum())
        n_all += len(qp)
    cross_trips = trips_sold[0] & trips_sold[1] & trips_sold[2]
    cross_sk = {sk for sk, tr in trip.items() if tr in cross_trips}
    avg_sales = tot / n_all
    ok_d2 = _d(tb, d_year=lambda y: y == 2001, d_moy=lambda m_: m_ == 11)
    base = []
    for ch, t, dcol, icol, qcol, pcol in chans:
        f = tb[t]
        groups = {}
        for dk, sk, q, p in zip(f[dcol].tolist(), f[icol].tolist(),
                                f[qcol].tolist(), f[pcol].tolist()):
            if dk in ok_d2 and sk in cross_sk:
                cur = groups.setdefault(trip[sk], [0.0, 0])
                cur[0] += q * p
                cur[1] += 1
        for g, (s, n) in groups.items():
            if s > avg_sales:
                base.append((ch, g[0], g[1], g[2], s, n))
    agg = {}
    for ch, b, cl, ca, s, n in base:
        for lvl in range(5):          # rollup levels (), (ch), ... (all 4)
            key = tuple(v if i < lvl else None
                        for i, v in enumerate((ch, b, cl, ca)))
            cur = agg.setdefault(key, [0.0, 0])
            cur[0] += s
            cur[1] += n
    rows = [k + (v[0], v[1]) for k, v in agg.items()]
    rows.sort(key=lambda r: tuple((x is not None, x) for x in r[:4]))
    return rows[:100]


def np_q45(tb):
    """Official q45: web sales by (zip, city) — zip-list OR item-id-subquery
    disjunction, Q2/2001."""
    cu, ca, ws, it = (tb["customer"], tb["customer_address"],
                      tb["web_sales"], tb["item"])
    azip = dict(zip(ca["ca_address_sk"], ca["ca_zip"]))
    acity = dict(zip(ca["ca_address_sk"], ca["ca_city"]))
    caddr = dict(zip(cu["c_customer_sk"], cu["c_current_addr_sk"]))
    iid = dict(zip(it["i_item_sk"], it["i_item_id"]))
    want_ids = {iid[k] for k in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)
                if k in iid}
    ok_d = _d(tb, d_qoy=lambda q: q == 2, d_year=lambda y: y == 2001)
    sums = {}
    for dk, ck, ik, p in zip(ws["ws_sold_date_sk"],
                             ws["ws_bill_customer_sk"], ws["ws_item_sk"],
                             ws["ws_sales_price"]):
        if dk not in ok_d:
            continue
        a = caddr[ck]
        z = azip[a]
        if z in _Q15_ZIPS or iid[ik] in want_ids:
            key = (z, acity[a])
            sums[key] = sums.get(key, 0.0) + p
    return [k + (sums[k],) for k in sorted(sums)][:100]


def _np_three_channel(tb, key_col, key_filter_col, key_filter_vals,
                      year, moy):
    """q33/q56 skeleton: per-channel sums by an item attribute, restricted
    to items whose `key_filter_col` is in `key_filter_vals` and buyers at
    gmt -5, summed across channels."""
    it, ca = tb["item"], tb["customer_address"]
    keep_keys = {k for k, v in zip(it[key_col], it[key_filter_col])
                 if v in key_filter_vals}
    attr = {sk: k for sk, k in zip(it["i_item_sk"], it[key_col])}
    ok_ca = set(ca["ca_address_sk"][ca["ca_gmt_offset"] == -5.0])
    ok_d = _d(tb, d_year=lambda y_: y_ == year, d_moy=lambda m: m == moy)
    chans = [("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_addr_sk",
              "ss_ext_sales_price"),
             ("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
              "cs_bill_addr_sk", "cs_ext_sales_price"),
             ("web_sales", "ws_sold_date_sk", "ws_item_sk",
              "ws_bill_addr_sk", "ws_ext_sales_price")]
    sums = {}
    for t, dcol, icol, acol, vcol in chans:
        f = tb[t]
        for dk, ik, ak, v in zip(f[dcol], f[icol], f[acol], f[vcol]):
            k = attr[ik]
            if dk in ok_d and ak in ok_ca and k in keep_keys:
                sums[k] = sums.get(k, 0.0) + v
    rows = sorted(((k, s) for k, s in sums.items()),
                  key=lambda r: (r[1], r[0]))
    return rows[:100]


def np_q33(tb):
    """Official q33: Electronics manufacturers across the three channels."""
    return _np_three_channel(tb, "i_manufact_id", "i_category",
                             {"Electronics"}, 1998, 5)


def np_q56(tb):
    """Official q56: slate/blanched/burnished item ids across channels."""
    return _np_three_channel(tb, "i_item_id", "i_color",
                             {"slate", "blanched", "burnished"}, 2001, 2)


def np_q18(tb):
    """Official q18: 7 decimal averages over catalog buyers (female,
    education Unknown, birth-month set) rolled up over
    (item, country, state, county). Mirrors the engine's exact integer
    decimal arithmetic: each value casts to decimal(12,2) via float64
    HALF_UP (expr/cast.py float->decimal), sums stay int, and the average
    divides at +4 scale with integer HALF_UP (expr/aggregates.Average)."""
    import math as _m
    from decimal import Decimal

    def to_cents(v):                      # cast(x as decimal(12,2)) mirror
        scaled = float(v) * 100.0
        r = _m.floor(abs(scaled) + 0.5)
        return -r if scaled < 0 else r

    cd = tb["customer_demographics"]
    cd_ok = {k: int(dep) for k, g, e, dep in zip(
        cd["cd_demo_sk"], cd["cd_gender"], cd["cd_education_status"],
        cd["cd_dep_count"]) if g == "F" and e == "Unknown"}
    cu = tb["customer"]
    c_info = {k: (int(by), int(bm), int(ad)) for k, by, bm, ad in zip(
        cu["c_customer_sk"], cu["c_birth_year"], cu["c_birth_month"],
        cu["c_current_addr_sk"])}
    ca = tb["customer_address"]
    ca_info = {k: (co, st, cty) for k, co, st, cty in zip(
        ca["ca_address_sk"], ca["ca_country"], ca["ca_state"],
        ca["ca_county"])}
    states = {"CA", "TX", "NY", "GA", "OH", "WA"}
    months = {1, 6, 8, 9, 12, 2}
    ok_d = _d(tb, d_year=lambda y: y == 1998)
    iid_col = tb["item"]["i_item_id"]       # dense sks from 1
    cs = tb["catalog_sales"]
    acc = {}
    for dk, ik, cdk, ck, q, lp, cam, sp, npf in zip(
            cs["cs_sold_date_sk"], cs["cs_item_sk"],
            cs["cs_bill_cdemo_sk"], cs["cs_bill_customer_sk"],
            cs["cs_quantity"], cs["cs_list_price"], cs["cs_coupon_amt"],
            cs["cs_sales_price"], cs["cs_net_profit"]):
        dep = cd_ok.get(cdk)
        if dk not in ok_d or dep is None:
            continue
        by, bm, ad = c_info[ck]
        if bm not in months:
            continue
        country, state, county = ca_info[ad]
        if state not in states:
            continue
        iid = iid_col[ik - 1]
        vals = [to_cents(q), to_cents(lp), to_cents(cam), to_cents(sp),
                to_cents(npf), to_cents(by), to_cents(dep)]
        full = (iid, country, state, county)
        for lvl in range(5):                    # rollup levels
            key = tuple(v if i < lvl else None
                        for i, v in enumerate(full))
            a = acc.setdefault(key, [0] + [0] * 7)
            a[0] += 1
            for j, v in enumerate(vals):
                a[1 + j] += v
    rows = []
    for key, a in acc.items():
        cnt = a[0]
        avgs = []
        for j in range(7):                      # engine decimal avg mirror
            num = a[1 + j] * 10 ** 4
            qm = (abs(num) + cnt // 2) // cnt
            avgs.append(Decimal(-qm if num < 0 else qm).scaleb(-6))
        rows.append(key + tuple(avgs))
    rows.sort(key=lambda r: tuple((v is not None, v) for v in
                                  (r[1], r[2], r[3], r[0])))
    return rows[:100]


def np_q69(tb):
    """Official q69: demographics of customers (in-state) who bought in
    store but neither web nor catalog in Q2-2001 (EXISTS + two NOT
    EXISTS). cs_bill_customer_sk substitutes cs_ship_customer_sk (subset
    schema, header rule 2)."""
    dd_ok = _d(tb, d_year=lambda y: y == 2001,
               d_moy=lambda m: (m >= 4) & (m <= 6))

    def buyers(fact, dcol, ccol):
        f = tb[fact]
        return {c for d, c in zip(f[dcol], f[ccol]) if d in dd_ok}
    ss_b = buyers("store_sales", "ss_sold_date_sk", "ss_customer_sk")
    ws_b = buyers("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk")
    cs_b = buyers("catalog_sales", "cs_sold_date_sk",
                  "cs_bill_customer_sk")
    ca = tb["customer_address"]
    ok_ca = set(ca["ca_address_sk"][np.isin(ca["ca_state"],
                                            ["CA", "TX", "NY"])])
    cd = tb["customer_demographics"]
    cd_info = {k: (g, m, e, int(pe), cr) for k, g, m, e, pe, cr in zip(
        cd["cd_demo_sk"], cd["cd_gender"], cd["cd_marital_status"],
        cd["cd_education_status"], cd["cd_purchase_estimate"],
        cd["cd_credit_rating"])}
    cu = tb["customer"]
    counts = {}
    for ck, ad, cdk in zip(cu["c_customer_sk"], cu["c_current_addr_sk"],
                           cu["c_current_cdemo_sk"]):
        if ad not in ok_ca or ck not in ss_b or ck in ws_b or ck in cs_b:
            continue
        g, m, e, pe, cr = cd_info[cdk]
        key = (g, m, e, pe, cr)
        counts[key] = counts.get(key, 0) + 1
    rows = [(g, m, e, n, pe, n, cr, n)
            for (g, m, e, pe, cr), n in counts.items()]
    rows.sort(key=lambda r: (r[0], r[1], r[2], r[4], r[6]))
    return rows[:100]


def np_q22(tb):
    """Official q22: average quantity on hand rolled up over the item
    hierarchy for a 12-month-seq window (i_item_id substitutes
    i_product_name — subset schema, header rule 2)."""
    dd = tb["date_dim"]
    ok_d = set(dd["d_date_sk"][(dd["d_month_seq"] >= 1200)
                               & (dd["d_month_seq"] <= 1211)])
    it = tb["item"]
    info = {k: (iid, b, cl, ca) for k, iid, b, cl, ca in zip(
        it["i_item_sk"], it["i_item_id"], it["i_brand"], it["i_class"],
        it["i_category"])}
    inv = tb["inventory"]
    acc = {}
    for dk, ik, q in zip(inv["inv_date_sk"], inv["inv_item_sk"],
                         inv["inv_quantity_on_hand"]):
        if dk not in ok_d:
            continue
        full = info[ik]
        for lvl in range(5):
            key = tuple(v if i < lvl else None
                        for i, v in enumerate(full))
            a = acc.setdefault(key, [0, 0])
            a[0] += 1
            a[1] += int(q)
    rows = [key + (a[1] / a[0],) for key, a in acc.items()]
    rows.sort(key=lambda r: (r[4],) + tuple((v is not None, v)
                                            for v in r[:4]))
    return rows[:100]



# the official texts TorchSession lowers (sql/tpcds_queries.py): all 40
SQL_PORTED = ("q3", "q42", "q52", "q55", "q7", "q19", "q43", "q96", "q34",
              "q73", "q48", "q53", "q63", "q89", "q98", "q65", "q79", "q46",
              "q68", "q88", "q13", "q15", "q61", "q97", "q12", "q20", "q26",
              "q27", "q36", "q18", "q22", "q8", "q38", "q87", "q14", "q28",
              "q45", "q33", "q56", "q69")


def sql_suite_oracles():
    """{name: (oracle_fn, float_cols)} for every official SQL text the port
    lowers (the reference's ``sql_suite_oracles``, over ``SQL_PORTED``).
    Most texts reuse the DataFrame suite's oracles; the SQL-only ones have
    their own."""
    sql_only = {
        "q13": (np_q13, {0, 1, 2, 3}),
        "q15": (np_q15, {1}),
        "q61": (np_q61, {0, 1, 2}),
        "q97": (np_q97, set()),
        "q12": (np_q12, {4, 5, 6}),
        "q20": (np_q20, {4, 5, 6}),
        "q26": (np_q26, {1, 2, 3, 4}),
        "q27": (np_q27_rollup, {3, 4, 5, 6}),
        "q36": (np_q36, {0}),
        # avg(x) as sum(x*cnt)/sum(cnt) after the distinct rewrite
        "q28": (np_q28, {0, 3, 6, 9, 12, 15}),
        "q8": (np_q8, set()),
        "q38": (np_q38, set()),
        "q87": (np_q87, set()),
        "q14": (np_q14, {4}),
        "q45": (np_q45, {2}),
        "q33": (np_q33, {1}),
        "q56": (np_q56, {1}),
        # exact decimal averages (the engine's integer arithmetic mirrored)
        "q18": (np_q18, set()),
        "q69": (np_q69, set()),
        "q22": (np_q22, {4}),
    }
    return {name: sql_only.get(name) or (NP_QUERIES[name], FLOAT_COLS[name])
            for name in SQL_PORTED}
