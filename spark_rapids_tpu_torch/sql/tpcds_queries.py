"""Official TPC-DS query text (40 queries) for ``TorchSession.sql()``.

The port's copy of ``spark_rapids_tpu/sql/tpcds_queries.py``, text for
text. These are the official TPC-DS templates (tpcds.org) with bounded
substitutions: the parameter constants match the DataFrame formulations of
``benchmarks/tpcds.py`` so that the same NumPy oracles check the rows;
columns outside the generated subset schema take their subset equivalent
(q43: ``d_day_name = 'Sunday'`` becomes ``d_dow = 0``; q34/q73 take the
household-demographics predicates the DataFrame form uses; q19/q89 drop
output columns the generator does not carry); ORDER BY carries
deterministic tie-break keys where the official text leaves ties open; zip
lists take values of the generated 10000-10099 domain, and magnitude
thresholds scale to the subset's value ranges.

The structure is the official text: the join shapes, derived tables,
CASE/BETWEEN/IN/HAVING, windows, ROLLUP, set operations (q8/q14/q38/q87),
IN-subqueries (q14/q45) and the FULL OUTER JOIN of q97. ``TorchSession``
lowers 27 of them; the other 13 (ROLLUP/GROUPING SETS, set operations,
DISTINCT aggregates, IN and EXISTS subqueries) raise
``NotImplementedError`` while they are lowered.
"""

SQL_QUERIES = {}

SQL_QUERIES["q3"] = """
select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
       sum(ss_ext_sales_price) sum_agg
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manufact_id = 128
  and dt.d_moy = 11
group by dt.d_year, item.i_brand_id, item.i_brand
order by dt.d_year, sum_agg desc, brand_id
limit 100
"""

SQL_QUERIES["q42"] = """
select dt.d_year, item.i_category_id, item.i_category,
       sum(ss_ext_sales_price) sum_agg
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 11
  and dt.d_year = 2000
group by dt.d_year, item.i_category_id, item.i_category
order by sum_agg desc, dt.d_year, item.i_category_id
limit 100
"""

SQL_QUERIES["q52"] = """
select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim dt, store_sales, item
where dt.d_date_sk = store_sales.ss_sold_date_sk
  and store_sales.ss_item_sk = item.i_item_sk
  and item.i_manager_id = 1
  and dt.d_moy = 11
  and dt.d_year = 2000
group by dt.d_year, item.i_brand_id, item.i_brand
order by dt.d_year, ext_price desc, brand_id
limit 100
"""

SQL_QUERIES["q55"] = """
select i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 28
  and d_moy = 11
  and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, brand_id
limit 100
"""

SQL_QUERIES["q7"] = """
select i_item_id,
       avg(ss_quantity) agg1,
       avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3,
       avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk
  and ss_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
"""

SQL_QUERIES["q19"] = """
select i_brand_id brand_id, i_brand brand, i_manufact_id,
       sum(ss_ext_sales_price) ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 8
  and d_moy = 11
  and d_year = 1999
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)
  and ss_store_sk = s_store_sk
group by i_brand_id, i_brand, i_manufact_id
order by ext_price desc, brand_id
limit 100
"""

SQL_QUERIES["q43"] = """
select s_store_name,
       sum(case when (d_dow = 0) then ss_sales_price else null end) sun_sales,
       sum(case when (d_dow = 1) then ss_sales_price else null end) mon_sales,
       sum(case when (d_dow = 2) then ss_sales_price else null end) tue_sales,
       sum(case when (d_dow = 3) then ss_sales_price else null end) wed_sales,
       sum(case when (d_dow = 4) then ss_sales_price else null end) thu_sales,
       sum(case when (d_dow = 5) then ss_sales_price else null end) fri_sales,
       sum(case when (d_dow = 6) then ss_sales_price else null end) sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk
  and s_store_sk = ss_store_sk
  and d_year = 2000
group by s_store_name
order by s_store_name
limit 100
"""

SQL_QUERIES["q96"] = """
select count(*) cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = time_dim.t_time_sk
  and ss_hdemo_sk = household_demographics.hd_demo_sk
  and ss_store_sk = s_store_sk
  and time_dim.t_hour = 20
  and time_dim.t_minute >= 30
  and household_demographics.hd_dep_count = 5
  and store.s_store_name = 'store0'
order by count(*)
limit 100
"""

SQL_QUERIES["q34"] = """
select c_last_name, c_first_name, ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, household_demographics
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        and (date_dim.d_dom between 1 and 3
             or date_dim.d_dom between 25 and 28)
        and household_demographics.hd_buy_potential <> 'Unknown'
        and household_demographics.hd_dep_count between 2 and 9
        and date_dim.d_year in (1999, 2000, 2001)
      group by ss_ticket_number, ss_customer_sk
      having count(*) between 15 and 20) dn, customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name, ss_ticket_number, cnt desc
"""

SQL_QUERIES["q73"] = """
select c_last_name, c_first_name, ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, household_demographics
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        and (date_dim.d_dom between 1 and 3
             or date_dim.d_dom between 25 and 28)
        and household_demographics.hd_buy_potential <> 'Unknown'
        and household_demographics.hd_dep_count between 1 and 9
        and date_dim.d_year in (1999, 2000, 2001)
      group by ss_ticket_number, ss_customer_sk
      having count(*) between 1 and 5) dj, customer
where ss_customer_sk = c_customer_sk
order by cnt desc, c_last_name, c_first_name, ss_ticket_number
limit 1000
"""

SQL_QUERIES["q48"] = """
select sum(ss_quantity) total
from store_sales, store, customer_demographics, customer_address, date_dim
where s_store_sk = ss_store_sk
  and ss_sold_date_sk = d_date_sk
  and d_year = 2000
  and ((cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'M'
        and cd_education_status = '4 yr Degree'
        and ss_sales_price between 100.00 and 150.00)
       or (cd_demo_sk = ss_cdemo_sk
           and cd_marital_status = 'D'
           and cd_education_status = '2 yr Degree'
           and ss_sales_price between 50.00 and 100.00)
       or (cd_demo_sk = ss_cdemo_sk
           and cd_marital_status = 'S'
           and cd_education_status = 'College'
           and ss_sales_price between 150.00 and 200.00))
  and ((ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('CA', 'TX', 'OH')
        and ss_net_profit between 0 and 2000)
       or (ss_addr_sk = ca_address_sk
           and ca_country = 'United States'
           and ca_state in ('NY', 'GA', 'WA')
           and ss_net_profit between 150 and 3000)
       or (ss_addr_sk = ca_address_sk
           and ca_country = 'United States'
           and ca_state in ('IL', 'MI')
           and ss_net_profit between 50 and 25000))
"""

SQL_QUERIES["q53"] = """
select * from
  (select i_manufact_id, sum(ss_sales_price) sum_sales,
          avg(sum(ss_sales_price)) over (partition by i_manufact_id)
            avg_quarterly_sales
   from item, store_sales, date_dim, store
   where ss_item_sk = i_item_sk
     and ss_sold_date_sk = d_date_sk
     and ss_store_sk = s_store_sk
     and d_year = 2000
     and i_category in ('Books', 'Home', 'Electronics')
   group by i_manufact_id, d_qoy) tmp1
where avg_quarterly_sales > 0
  and case when avg_quarterly_sales > 0
           then abs(sum_sales - avg_quarterly_sales) / avg_quarterly_sales
           else null end > 0.1
order by avg_quarterly_sales, sum_sales, i_manufact_id
limit 100
"""

SQL_QUERIES["q63"] = """
select * from
  (select i_manager_id, sum(ss_sales_price) sum_sales,
          avg(sum(ss_sales_price)) over (partition by i_manager_id)
            avg_monthly_sales
   from item, store_sales, date_dim
   where ss_item_sk = i_item_sk
     and ss_sold_date_sk = d_date_sk
     and d_year = 2000
     and i_category in ('Books', 'Home', 'Electronics')
   group by i_manager_id, d_moy) tmp1
where avg_monthly_sales > 0
  and case when avg_monthly_sales > 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by i_manager_id, avg_monthly_sales, sum_sales
limit 100
"""

SQL_QUERIES["q89"] = """
select * from
  (select i_category, i_class, i_brand, s_store_name, d_moy,
          sum(ss_sales_price) sum_sales,
          avg(sum(ss_sales_price))
            over (partition by i_category, i_brand, s_store_name)
            avg_monthly_sales
   from item, store_sales, date_dim, store
   where ss_item_sk = i_item_sk
     and ss_sold_date_sk = d_date_sk
     and ss_store_sk = s_store_sk
     and d_year = 1999
     and i_category in ('Books', 'Electronics', 'Sports')
   group by i_category, i_class, i_brand, s_store_name, d_moy) tmp1
where avg_monthly_sales <> 0
  and abs(sum_sales - avg_monthly_sales) / avg_monthly_sales > 0.1
order by sum_sales - avg_monthly_sales, s_store_name, i_class, d_moy
limit 100
"""

SQL_QUERIES["q98"] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price) itemrevenue,
       sum(ss_ext_sales_price) * 100.0
         / sum(sum(ss_ext_sales_price)) over (partition by i_class)
         revenueratio
from store_sales, item, date_dim
where ss_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ss_sold_date_sk = d_date_sk
  and d_year = 1999
  and d_moy = 2
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
"""

SQL_QUERIES["q27"] = """
select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1,
       avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3,
       avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk
  and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'F'
  and cd_marital_status = 'W'
  and cd_education_status = 'Primary'
  and d_year = 1999
  and s_state in ('CA', 'TX', 'NY', 'OH')
group by rollup (i_item_id, s_state)
order by i_item_id, s_state
limit 100
"""

SQL_QUERIES["q65"] = """
select s_store_name, i_item_desc, sc.revenue, i_current_price
from store, item,
     (select ss_store_sk, ss_item_sk, sum(ss_sales_price) revenue
      from store_sales, date_dim
      where ss_sold_date_sk = d_date_sk and d_year = 2000
      group by ss_store_sk, ss_item_sk) sc,
     (select ss_store_sk, avg(revenue) ave
      from (select ss_store_sk, ss_item_sk, sum(ss_sales_price) revenue
            from store_sales, date_dim
            where ss_sold_date_sk = d_date_sk and d_year = 2000
            group by ss_store_sk, ss_item_sk) sa
      group by ss_store_sk) sb
where sb.ss_store_sk = sc.ss_store_sk
  and sc.revenue <= 0.1 * sb.ave
  and s_store_sk = sc.ss_store_sk
  and i_item_sk = sc.ss_item_sk
order by s_store_name, i_item_desc
limit 100
"""

SQL_QUERIES["q79"] = """
select c_last_name, c_first_name, s_city, profit, ss_ticket_number, amt
from (select ss_ticket_number, ss_customer_sk, store.s_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_store_sk = store.s_store_sk
        and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        and (household_demographics.hd_dep_count = 6
             or household_demographics.hd_vehicle_count > 2)
        and date_dim.d_dow = 1
        and date_dim.d_year in (1998, 1999, 2000)
        and store.s_number_employees between 200 and 295
      group by ss_ticket_number, ss_customer_sk, store.s_city) ms, customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name, s_city, profit
limit 100
"""

SQL_QUERIES["q46"] = """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       amt, profit
from (select ss_ticket_number, ss_customer_sk,
             ca_city bought_city,
             sum(ss_coupon_amt) amt, sum(ss_ext_sales_price) profit
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_store_sk = store.s_store_sk
        and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        and store_sales.ss_addr_sk = customer_address.ca_address_sk
        and (household_demographics.hd_dep_count = 5
             or household_demographics.hd_vehicle_count = 3)
        and date_dim.d_dow in (6, 0)
        and date_dim.d_year in (1999, 2000, 2001)
        and store.s_city in ('Midway', 'Fairview', 'Oakland')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, c_first_name, current_addr.ca_city, bought_city,
         ss_ticket_number
limit 100
"""

SQL_QUERIES["q68"] = """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       extended_price, extended_tax, list_price
from (select ss_ticket_number, ss_customer_sk,
             ca_city bought_city,
             sum(ss_ext_sales_price) extended_price,
             sum(ss_ext_list_price) list_price,
             sum(ss_ext_tax) extended_tax
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where store_sales.ss_sold_date_sk = date_dim.d_date_sk
        and store_sales.ss_store_sk = store.s_store_sk
        and store_sales.ss_hdemo_sk = household_demographics.hd_demo_sk
        and store_sales.ss_addr_sk = customer_address.ca_address_sk
        and date_dim.d_dom between 1 and 2
        and (household_demographics.hd_dep_count = 4
             or household_demographics.hd_vehicle_count = 3)
        and date_dim.d_year in (1998, 1999, 2000)
        and store.s_city in ('Midway', 'Fairview')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, ss_ticket_number
limit 100
"""

SQL_QUERIES["q88"] = """
select * from
 (select count(*) h8_30_to_9
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = time_dim.t_time_sk
    and ss_hdemo_sk = household_demographics.hd_demo_sk
    and ss_store_sk = s_store_sk
    and time_dim.t_hour = 8 and time_dim.t_minute >= 30
    and time_dim.t_minute < 60
    and ((household_demographics.hd_dep_count = 3
          and household_demographics.hd_vehicle_count <= 5)
         or (household_demographics.hd_dep_count = 0
             and household_demographics.hd_vehicle_count <= 2)
         or (household_demographics.hd_dep_count = 1
             and household_demographics.hd_vehicle_count <= 3))
    and store.s_store_name = 'store0') s1,
 (select count(*) h9_to_9_30
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = time_dim.t_time_sk
    and ss_hdemo_sk = household_demographics.hd_demo_sk
    and ss_store_sk = s_store_sk
    and time_dim.t_hour = 9 and time_dim.t_minute >= 0
    and time_dim.t_minute < 30
    and ((household_demographics.hd_dep_count = 3
          and household_demographics.hd_vehicle_count <= 5)
         or (household_demographics.hd_dep_count = 0
             and household_demographics.hd_vehicle_count <= 2)
         or (household_demographics.hd_dep_count = 1
             and household_demographics.hd_vehicle_count <= 3))
    and store.s_store_name = 'store0') s2,
 (select count(*) h9_30_to_10
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = time_dim.t_time_sk
    and ss_hdemo_sk = household_demographics.hd_demo_sk
    and ss_store_sk = s_store_sk
    and time_dim.t_hour = 9 and time_dim.t_minute >= 30
    and time_dim.t_minute < 60
    and ((household_demographics.hd_dep_count = 3
          and household_demographics.hd_vehicle_count <= 5)
         or (household_demographics.hd_dep_count = 0
             and household_demographics.hd_vehicle_count <= 2)
         or (household_demographics.hd_dep_count = 1
             and household_demographics.hd_vehicle_count <= 3))
    and store.s_store_name = 'store0') s3,
 (select count(*) h10_to_10_30
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = time_dim.t_time_sk
    and ss_hdemo_sk = household_demographics.hd_demo_sk
    and ss_store_sk = s_store_sk
    and time_dim.t_hour = 10 and time_dim.t_minute >= 0
    and time_dim.t_minute < 30
    and ((household_demographics.hd_dep_count = 3
          and household_demographics.hd_vehicle_count <= 5)
         or (household_demographics.hd_dep_count = 0
             and household_demographics.hd_vehicle_count <= 2)
         or (household_demographics.hd_dep_count = 1
             and household_demographics.hd_vehicle_count <= 3))
    and store.s_store_name = 'store0') s4,
 (select count(*) h10_30_to_11
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = time_dim.t_time_sk
    and ss_hdemo_sk = household_demographics.hd_demo_sk
    and ss_store_sk = s_store_sk
    and time_dim.t_hour = 10 and time_dim.t_minute >= 30
    and time_dim.t_minute < 60
    and ((household_demographics.hd_dep_count = 3
          and household_demographics.hd_vehicle_count <= 5)
         or (household_demographics.hd_dep_count = 0
             and household_demographics.hd_vehicle_count <= 2)
         or (household_demographics.hd_dep_count = 1
             and household_demographics.hd_vehicle_count <= 3))
    and store.s_store_name = 'store0') s5,
 (select count(*) h11_to_11_30
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = time_dim.t_time_sk
    and ss_hdemo_sk = household_demographics.hd_demo_sk
    and ss_store_sk = s_store_sk
    and time_dim.t_hour = 11 and time_dim.t_minute >= 0
    and time_dim.t_minute < 30
    and ((household_demographics.hd_dep_count = 3
          and household_demographics.hd_vehicle_count <= 5)
         or (household_demographics.hd_dep_count = 0
             and household_demographics.hd_vehicle_count <= 2)
         or (household_demographics.hd_dep_count = 1
             and household_demographics.hd_vehicle_count <= 3))
    and store.s_store_name = 'store0') s6,
 (select count(*) h11_30_to_12
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = time_dim.t_time_sk
    and ss_hdemo_sk = household_demographics.hd_demo_sk
    and ss_store_sk = s_store_sk
    and time_dim.t_hour = 11 and time_dim.t_minute >= 30
    and time_dim.t_minute < 60
    and ((household_demographics.hd_dep_count = 3
          and household_demographics.hd_vehicle_count <= 5)
         or (household_demographics.hd_dep_count = 0
             and household_demographics.hd_vehicle_count <= 2)
         or (household_demographics.hd_dep_count = 1
             and household_demographics.hd_vehicle_count <= 3))
    and store.s_store_name = 'store0') s7,
 (select count(*) h12_to_12_30
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = time_dim.t_time_sk
    and ss_hdemo_sk = household_demographics.hd_demo_sk
    and ss_store_sk = s_store_sk
    and time_dim.t_hour = 12 and time_dim.t_minute >= 0
    and time_dim.t_minute < 30
    and ((household_demographics.hd_dep_count = 3
          and household_demographics.hd_vehicle_count <= 5)
         or (household_demographics.hd_dep_count = 0
             and household_demographics.hd_vehicle_count <= 2)
         or (household_demographics.hd_dep_count = 1
             and household_demographics.hd_vehicle_count <= 3))
    and store.s_store_name = 'store0') s8
"""

# -- SQL-only additions (no DataFrame adaptation exists; oracles in
# benchmarks/tpcds.py np_q13/np_q36). State lists substitute the generator's
# 8-state domain; q36 carries deterministic ORDER BY tie-breaks.

SQL_QUERIES["q13"] = """
select avg(ss_quantity) aq, avg(ss_ext_sales_price) ap,
       avg(ss_ext_wholesale_cost) aw, sum(ss_ext_wholesale_cost) sw
from store_sales, store, customer_demographics, household_demographics,
     customer_address, date_dim
where s_store_sk = ss_store_sk
  and ss_sold_date_sk = d_date_sk and d_year = 2001
  and ((ss_hdemo_sk = hd_demo_sk
        and cd_demo_sk = ss_cdemo_sk
        and cd_marital_status = 'M'
        and cd_education_status = 'Advanced Degree'
        and ss_sales_price between 100.00 and 200.00
        and hd_dep_count = 3)
       or (ss_hdemo_sk = hd_demo_sk
           and cd_demo_sk = ss_cdemo_sk
           and cd_marital_status = 'S'
           and cd_education_status = 'College'
           and ss_sales_price between 50.00 and 150.00
           and hd_dep_count = 1)
       or (ss_hdemo_sk = hd_demo_sk
           and cd_demo_sk = ss_cdemo_sk
           and cd_marital_status = 'W'
           and cd_education_status = '2 yr Degree'
           and ss_sales_price between 1.00 and 100.00
           and hd_dep_count = 1))
  and ((ss_addr_sk = ca_address_sk
        and ca_country = 'United States'
        and ca_state in ('CA', 'TX', 'OH')
        and ss_net_profit between 0 and 2000)
       or (ss_addr_sk = ca_address_sk
           and ca_country = 'United States'
           and ca_state in ('NY', 'GA', 'WA')
           and ss_net_profit between 150 and 3000)
       or (ss_addr_sk = ca_address_sk
           and ca_country = 'United States'
           and ca_state in ('IL', 'MI', 'CA')
           and ss_net_profit between 50 and 2500))
"""

SQL_QUERIES["q36"] = """
select sum(ss_net_profit) / sum(ss_ext_sales_price) gross_margin,
       i_category, i_class,
       grouping(i_category) + grouping(i_class) lochierarchy,
       rank() over (partition by grouping(i_category) + grouping(i_class),
                    case when grouping(i_class) = 0 then i_category end
                    order by sum(ss_net_profit) / sum(ss_ext_sales_price)
                    asc) rank_within_parent
from store_sales, date_dim d1, item, store
where d1.d_year = 2001
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and s_state in ('CA', 'TX', 'NY', 'GA', 'OH', 'WA', 'IL', 'MI')
group by rollup (i_category, i_class)
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category end,
         rank_within_parent, i_category, i_class
limit 100
"""

SQL_QUERIES["q28"] = """
select  *
from (select avg(ss_list_price) B1_LP
            ,count(ss_list_price) B1_CNT
            ,count(distinct ss_list_price) B1_CNTD
      from store_sales
      where ss_quantity between 0 and 5
        and (ss_list_price between 8 and 8+10
             or ss_coupon_amt between 459 and 459+1000
             or ss_wholesale_cost between 57 and 57+20)) B1,
     (select avg(ss_list_price) B2_LP
            ,count(ss_list_price) B2_CNT
            ,count(distinct ss_list_price) B2_CNTD
      from store_sales
      where ss_quantity between 6 and 10
        and (ss_list_price between 90 and 90+10
             or ss_coupon_amt between 2323 and 2323+1000
             or ss_wholesale_cost between 31 and 31+20)) B2,
     (select avg(ss_list_price) B3_LP
            ,count(ss_list_price) B3_CNT
            ,count(distinct ss_list_price) B3_CNTD
      from store_sales
      where ss_quantity between 11 and 15
        and (ss_list_price between 142 and 142+10
             or ss_coupon_amt between 12214 and 12214+1000
             or ss_wholesale_cost between 79 and 79+20)) B3,
     (select avg(ss_list_price) B4_LP
            ,count(ss_list_price) B4_CNT
            ,count(distinct ss_list_price) B4_CNTD
      from store_sales
      where ss_quantity between 16 and 20
        and (ss_list_price between 135 and 135+10
             or ss_coupon_amt between 6071 and 6071+1000
             or ss_wholesale_cost between 38 and 38+20)) B4,
     (select avg(ss_list_price) B5_LP
            ,count(ss_list_price) B5_CNT
            ,count(distinct ss_list_price) B5_CNTD
      from store_sales
      where ss_quantity between 21 and 25
        and (ss_list_price between 122 and 122+10
             or ss_coupon_amt between 836 and 836+1000
             or ss_wholesale_cost between 17 and 17+20)) B5,
     (select avg(ss_list_price) B6_LP
            ,count(ss_list_price) B6_CNT
            ,count(distinct ss_list_price) B6_CNTD
      from store_sales
      where ss_quantity between 26 and 30
        and (ss_list_price between 154 and 154+10
             or ss_coupon_amt between 7326 and 7326+1000
             or ss_wholesale_cost between 7 and 7+20)) B6
limit 100
"""

SQL_QUERIES["q8"] = """
select s_store_name, sum(ss_net_profit)
from store_sales, date_dim, store,
     (select ca_zip
      from (
       (select substr(ca_zip,1,5) ca_zip
        from customer_address
        where substr(ca_zip,1,5) in ('10000','10005','10010','10015',
              '10020','10025','10030','10035','10040','10045','10050',
              '10055','10060','10065','10070','10075','10080','10085',
              '10090','10095'))
       intersect
       (select ca_zip
        from (select substr(ca_zip,1,5) ca_zip, count(*) cnt
              from customer_address, customer
              where ca_address_sk = c_current_addr_sk and
                    c_preferred_cust_flag = 'Y'
              group by ca_zip
              having count(*) > 4) A1)) A2) V1
where ss_store_sk = s_store_sk
  and ss_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 1998
  and (substr(s_zip,1,2) = substr(V1.ca_zip,1,2))
group by s_store_name
order by s_store_name
limit 100
"""

SQL_QUERIES["q38"] = """
select count(*) from (
    select distinct c_last_name, c_first_name, d_date
    from store_sales, date_dim, customer
          where store_sales.ss_sold_date_sk = date_dim.d_date_sk
      and store_sales.ss_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200+11
  intersect
    select distinct c_last_name, c_first_name, d_date
    from catalog_sales, date_dim, customer
          where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
      and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200+11
  intersect
    select distinct c_last_name, c_first_name, d_date
    from web_sales, date_dim, customer
          where web_sales.ws_sold_date_sk = date_dim.d_date_sk
      and web_sales.ws_bill_customer_sk = customer.c_customer_sk
      and d_month_seq between 1200 and 1200+11
) hot_cust
limit 100
"""

SQL_QUERIES["q87"] = """
select count(*)
from ((select distinct c_last_name, c_first_name, d_date
       from store_sales, date_dim, customer
       where store_sales.ss_sold_date_sk = date_dim.d_date_sk
         and store_sales.ss_customer_sk = customer.c_customer_sk
         and d_month_seq between 1200 and 1200+11)
       except
      (select distinct c_last_name, c_first_name, d_date
       from catalog_sales, date_dim, customer
       where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
         and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
         and d_month_seq between 1200 and 1200+11)
       except
      (select distinct c_last_name, c_first_name, d_date
       from web_sales, date_dim, customer
       where web_sales.ws_sold_date_sk = date_dim.d_date_sk
         and web_sales.ws_bill_customer_sk = customer.c_customer_sk
         and d_month_seq between 1200 and 1200+11)
) cool_cust
"""

SQL_QUERIES["q14"] = """
with cross_items as
 (select i_item_sk ss_item_sk
 from item,
 (select iss.i_brand_id brand_id
     ,iss.i_class_id class_id
     ,iss.i_category_id category_id
 from store_sales, item iss, date_dim d1
 where ss_item_sk = iss.i_item_sk
   and ss_sold_date_sk = d1.d_date_sk
   and d1.d_year between 1999 and 1999 + 2
 intersect
 select ics.i_brand_id
     ,ics.i_class_id
     ,ics.i_category_id
 from catalog_sales, item ics, date_dim d2
 where cs_item_sk = ics.i_item_sk
   and cs_sold_date_sk = d2.d_date_sk
   and d2.d_year between 1999 and 1999 + 2
 intersect
 select iws.i_brand_id
     ,iws.i_class_id
     ,iws.i_category_id
 from web_sales, item iws, date_dim d3
 where ws_item_sk = iws.i_item_sk
   and ws_sold_date_sk = d3.d_date_sk
   and d3.d_year between 1999 and 1999 + 2) x
 where i_brand_id = brand_id
      and i_class_id = class_id
      and i_category_id = category_id
),
 avg_sales as
 (select avg(quantity*list_price) average_sales
  from (select ss_quantity quantity
             ,ss_list_price list_price
       from store_sales
           ,date_dim
       where ss_sold_date_sk = d_date_sk
         and d_year between 1999 and 1999 + 2
       union all
       select cs_quantity quantity
             ,cs_list_price list_price
       from catalog_sales
           ,date_dim
       where cs_sold_date_sk = d_date_sk
         and d_year between 1999 and 1999 + 2
       union all
       select ws_quantity quantity
             ,ws_list_price list_price
       from web_sales
           ,date_dim
       where ws_sold_date_sk = d_date_sk
         and d_year between 1999 and 1999 + 2) x)
select channel, i_brand_id,i_class_id,i_category_id,sum(sales) sum_sales,
       sum(number_sales) sum_number_sales
from(
       select 'store' channel, i_brand_id,i_class_id
             ,i_category_id,sum(ss_quantity*ss_list_price) sales
             ,count(*) number_sales
       from store_sales
           ,item
           ,date_dim
       where ss_item_sk in (select ss_item_sk from cross_items)
         and ss_item_sk = i_item_sk
         and ss_sold_date_sk = d_date_sk
         and d_year = 1999+2
         and d_moy = 11
       group by i_brand_id,i_class_id,i_category_id
       having sum(ss_quantity*ss_list_price) > (select average_sales from avg_sales)
       union all
       select 'catalog' channel, i_brand_id,i_class_id,i_category_id
             ,sum(cs_quantity*cs_list_price) sales
             ,count(*) number_sales
       from catalog_sales
           ,item
           ,date_dim
       where cs_item_sk in (select ss_item_sk from cross_items)
         and cs_item_sk = i_item_sk
         and cs_sold_date_sk = d_date_sk
         and d_year = 1999+2
         and d_moy = 11
       group by i_brand_id,i_class_id,i_category_id
       having sum(cs_quantity*cs_list_price) > (select average_sales from avg_sales)
       union all
       select 'web' channel, i_brand_id,i_class_id,i_category_id
             ,sum(ws_quantity*ws_list_price) sales
             ,count(*) number_sales
       from web_sales
           ,item
           ,date_dim
       where ws_item_sk in (select ss_item_sk from cross_items)
         and ws_item_sk = i_item_sk
         and ws_sold_date_sk = d_date_sk
         and d_year = 1999+2
         and d_moy = 11
       group by i_brand_id,i_class_id,i_category_id
       having sum(ws_quantity*ws_list_price) > (select average_sales from avg_sales)
 ) y
group by rollup (channel, i_brand_id, i_class_id, i_category_id)
order by channel,i_brand_id,i_class_id,i_category_id
limit 100
"""

SQL_QUERIES["q15"] = """
select ca_zip, sum(cs_sales_price)
from catalog_sales, customer, customer_address, date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and (substr(ca_zip,1,5) in ('10005','10010','10020','10035','10040',
                              '10055','10070','10085','10090')
       or ca_state in ('CA','WA','GA')
       or cs_sales_price > 150)
  and cs_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 2001
group by ca_zip
order by ca_zip
limit 100
"""

SQL_QUERIES["q45"] = """
select ca_zip, ca_city, sum(ws_sales_price)
from web_sales, customer, customer_address, date_dim, item
where ws_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ws_item_sk = i_item_sk
  and (substr(ca_zip,1,5) in ('10005','10010','10020','10035','10040',
                              '10055','10070','10085','10090')
       or
       i_item_id in (select i_item_id
                     from item
                     where i_item_sk in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)
                    )
      )
  and ws_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 2001
group by ca_zip, ca_city
order by ca_zip, ca_city
limit 100
"""

SQL_QUERIES["q61"] = """
select promotions, total,
       cast(promotions as decimal(15,4))/cast(total as decimal(15,4))*100
from
  (select sum(ss_ext_sales_price) promotions
   from store_sales, store, promotion, date_dim, customer,
        customer_address, item
   where ss_sold_date_sk = d_date_sk
     and ss_store_sk = s_store_sk
     and ss_promo_sk = p_promo_sk
     and ss_customer_sk = c_customer_sk
     and ca_address_sk = c_current_addr_sk
     and ss_item_sk = i_item_sk
     and ca_gmt_offset = -6
     and i_category = 'Books'
     and (p_channel_dmail = 'Y' or p_channel_email = 'Y'
          or p_channel_tv = 'Y')
     and s_gmt_offset = -6
     and d_year = 2000
     and d_moy = 11) promotional_sales,
  (select sum(ss_ext_sales_price) total
   from store_sales, store, date_dim, customer, customer_address, item
   where ss_sold_date_sk = d_date_sk
     and ss_store_sk = s_store_sk
     and ss_customer_sk = c_customer_sk
     and ca_address_sk = c_current_addr_sk
     and ss_item_sk = i_item_sk
     and ca_gmt_offset = -6
     and i_category = 'Books'
     and s_gmt_offset = -6
     and d_year = 2000
     and d_moy = 11) all_sales
order by promotions, total
limit 100
"""

SQL_QUERIES["q97"] = """
with ssci as (
select ss_customer_sk customer_sk
      ,ss_item_sk item_sk
from store_sales,date_dim
where ss_sold_date_sk = d_date_sk
  and d_month_seq between 1200 and 1200 + 11
group by ss_customer_sk
        ,ss_item_sk),
csci as(
 select cs_bill_customer_sk customer_sk
      ,cs_item_sk item_sk
from catalog_sales,date_dim
where cs_sold_date_sk = d_date_sk
  and d_month_seq between 1200 and 1200 + 11
group by cs_bill_customer_sk
        ,cs_item_sk)
select sum(case when ssci.customer_sk is not null
                 and csci.customer_sk is null then 1 else 0 end) store_only
      ,sum(case when ssci.customer_sk is null
                 and csci.customer_sk is not null then 1 else 0 end)
           catalog_only
      ,sum(case when ssci.customer_sk is not null
                 and csci.customer_sk is not null then 1 else 0 end)
           store_and_catalog
from ssci full outer join csci on (ssci.customer_sk = csci.customer_sk
                               and ssci.item_sk = csci.item_sk)
limit 100
"""

SQL_QUERIES["q33"] = """
with ss as (
 select
          i_manufact_id,sum(ss_ext_sales_price) total_sales
 from
 	store_sales,
 	date_dim,
         customer_address,
         item
 where
         i_manufact_id in (select
  i_manufact_id
from
 item
where i_category in ('Electronics'))
 and     ss_item_sk              = i_item_sk
 and     ss_sold_date_sk         = d_date_sk
 and     d_year                  = 1998
 and     d_moy                   = 5
 and     ss_addr_sk              = ca_address_sk
 and     ca_gmt_offset           = -5
 group by i_manufact_id),
 cs as (
 select
          i_manufact_id,sum(cs_ext_sales_price) total_sales
 from
 	catalog_sales,
 	date_dim,
         customer_address,
         item
 where
         i_manufact_id               in (select
  i_manufact_id
from
 item
where i_category in ('Electronics'))
 and     cs_item_sk              = i_item_sk
 and     cs_sold_date_sk         = d_date_sk
 and     d_year                  = 1998
 and     d_moy                   = 5
 and     cs_bill_addr_sk         = ca_address_sk
 and     ca_gmt_offset           = -5
 group by i_manufact_id),
 ws as (
 select
          i_manufact_id,sum(ws_ext_sales_price) total_sales
 from
 	web_sales,
 	date_dim,
         customer_address,
         item
 where
         i_manufact_id               in (select
  i_manufact_id
from
 item
where i_category in ('Electronics'))
 and     ws_item_sk              = i_item_sk
 and     ws_sold_date_sk         = d_date_sk
 and     d_year                  = 1998
 and     d_moy                   = 5
 and     ws_bill_addr_sk         = ca_address_sk
 and     ca_gmt_offset           = -5
 group by i_manufact_id)
 select  i_manufact_id ,sum(total_sales) total_sales
 from  (select * from ss
        union all
        select * from cs
        union all
        select * from ws) tmp1
 group by i_manufact_id
 order by total_sales, i_manufact_id
limit 100
"""

SQL_QUERIES["q56"] = """
with ss as (
 select i_item_id,sum(ss_ext_sales_price) total_sales
 from
 	store_sales,
 	date_dim,
         customer_address,
         item
 where i_item_id in (select
     i_item_id
from item
where i_color in ('slate','blanched','burnished'))
 and     ss_item_sk              = i_item_sk
 and     ss_sold_date_sk         = d_date_sk
 and     d_year                  = 2001
 and     d_moy                   = 2
 and     ss_addr_sk              = ca_address_sk
 and     ca_gmt_offset           = -5
 group by i_item_id),
 cs as (
 select i_item_id,sum(cs_ext_sales_price) total_sales
 from
 	catalog_sales,
 	date_dim,
         customer_address,
         item
 where
         i_item_id               in (select
  i_item_id
from item
where i_color in ('slate','blanched','burnished'))
 and     cs_item_sk              = i_item_sk
 and     cs_sold_date_sk         = d_date_sk
 and     d_year                  = 2001
 and     d_moy                   = 2
 and     cs_bill_addr_sk         = ca_address_sk
 and     ca_gmt_offset           = -5
 group by i_item_id),
 ws as (
 select i_item_id,sum(ws_ext_sales_price) total_sales
 from
 	web_sales,
 	date_dim,
         customer_address,
         item
 where
         i_item_id               in (select
  i_item_id
from item
where i_color in ('slate','blanched','burnished'))
 and     ws_item_sk              = i_item_sk
 and     ws_sold_date_sk         = d_date_sk
 and     d_year                  = 2001
 and     d_moy                   = 2
 and     ws_bill_addr_sk         = ca_address_sk
 and     ca_gmt_offset           = -5
 group by i_item_id)
 select  i_item_id ,sum(total_sales) total_sales
 from  (select * from ss
        union all
        select * from cs
        union all
        select * from ws) tmp1
 group by i_item_id
 order by total_sales, i_item_id
limit 100
"""

SQL_QUERIES["q12"] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ws_ext_sales_price) itemrevenue,
       sum(ws_ext_sales_price) * 100.0
         / sum(sum(ws_ext_sales_price)) over (partition by i_class)
         revenueratio
from web_sales, item, date_dim
where ws_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ws_sold_date_sk = d_date_sk
  and d_year = 1999
  and d_moy = 2
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
"""

SQL_QUERIES["q20"] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(cs_ext_sales_price) itemrevenue,
       sum(cs_ext_sales_price) * 100.0
         / sum(sum(cs_ext_sales_price)) over (partition by i_class)
         revenueratio
from catalog_sales, item, date_dim
where cs_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and cs_sold_date_sk = d_date_sk
  and d_year = 1999
  and d_moy = 2
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
"""

SQL_QUERIES["q26"] = """
select i_item_id,
       avg(cs_quantity) agg1,
       avg(cs_list_price) agg2,
       avg(cs_coupon_amt) agg3,
       avg(cs_sales_price) agg4
from catalog_sales, customer_demographics, date_dim, item, promotion
where cs_sold_date_sk = d_date_sk
  and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk
  and cs_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
"""

SQL_QUERIES["q18"] = """
select i_item_id,
       ca_country,
       ca_state,
       ca_county,
       avg( cast(cs_quantity as decimal(12,2))) agg1,
       avg( cast(cs_list_price as decimal(12,2))) agg2,
       avg( cast(cs_coupon_amt as decimal(12,2))) agg3,
       avg( cast(cs_sales_price as decimal(12,2))) agg4,
       avg( cast(cs_net_profit as decimal(12,2))) agg5,
       avg( cast(c_birth_year as decimal(12,2))) agg6,
       avg( cast(cd1.cd_dep_count as decimal(12,2))) agg7
 from catalog_sales, customer_demographics cd1,
      customer_demographics cd2, customer, customer_address, date_dim, item
 where cs_sold_date_sk = d_date_sk and
       cs_item_sk = i_item_sk and
       cs_bill_cdemo_sk = cd1.cd_demo_sk and
       cs_bill_customer_sk = c_customer_sk and
       cd1.cd_gender = 'F' and
       cd1.cd_education_status = 'Unknown' and
       c_current_cdemo_sk = cd2.cd_demo_sk and
       c_current_addr_sk = ca_address_sk and
       c_birth_month in (1,6,8,9,12,2) and
       d_year = 1998 and
       ca_state in ('CA','TX','NY','GA','OH','WA')
 group by rollup (i_item_id, ca_country, ca_state, ca_county)
 order by ca_country, ca_state, ca_county, i_item_id
 limit 100
"""

SQL_QUERIES["q69"] = """
select
  cd_gender,
  cd_marital_status,
  cd_education_status,
  count(*) cnt1,
  cd_purchase_estimate,
  count(*) cnt2,
  cd_credit_rating,
  count(*) cnt3
 from
  customer c, customer_address ca, customer_demographics
 where
  c.c_current_addr_sk = ca.ca_address_sk and
  ca_state in ('CA','TX','NY') and
  cd_demo_sk = c.c_current_cdemo_sk and
  exists (select *
          from store_sales, date_dim
          where c.c_customer_sk = ss_customer_sk and
                ss_sold_date_sk = d_date_sk and
                d_year = 2001 and
                d_moy between 4 and 4+2) and
   (not exists (select *
                from web_sales, date_dim
                where c.c_customer_sk = ws_bill_customer_sk and
                      ws_sold_date_sk = d_date_sk and
                      d_year = 2001 and
                      d_moy between 4 and 4+2) and
    not exists (select *
                from catalog_sales, date_dim
                where c.c_customer_sk = cs_bill_customer_sk and
                      cs_sold_date_sk = d_date_sk and
                      d_year = 2001 and
                      d_moy between 4 and 4+2))
 group by cd_gender, cd_marital_status, cd_education_status,
          cd_purchase_estimate, cd_credit_rating
 order by cd_gender, cd_marital_status, cd_education_status,
          cd_purchase_estimate, cd_credit_rating
 limit 100
"""

SQL_QUERIES["q22"] = """
select i_item_id,
       i_brand,
       i_class,
       i_category,
       avg(inv_quantity_on_hand) qoh
       from inventory, date_dim, item
       where inv_date_sk = d_date_sk
              and inv_item_sk = i_item_sk
              and d_month_seq between 1200 and 1200 + 11
       group by rollup(i_item_id, i_brand, i_class, i_category)
order by qoh, i_item_id, i_brand, i_class, i_category
limit 100
"""
