"""The official TPC-DS SQL texts through ``TorchSession.sql()`` on the CPU.

- the port's copy of the 40 texts (``sql/tpcds_queries.py``) equals the
  reference's, text for text, and the port lowers all 40;
- each of the 40, at SF 0.012 (the size of the reference's
  ``tests/test_sql_tpcds.py``), equals its NumPy oracle
  (``benchmarks/tpcds.sql_suite_oracles``) under ``check_rows``, and the
  port's oracles equal the reference's;
- a hand-written text for each refusal that is left (LIKE, ``%``, ``||``,
  stddev, SELECT without FROM, a TIMESTAMP literal, ...) raises
  ``NotImplementedError`` while it is lowered, before anything runs;
- the 11 texts lowered since the DataFrame suite (CASE, windows, division,
  substr, IS NULL, the full outer join and the decimal cast) also equal the
  reference's ``TpuSession.sql()`` on the same files, and so do q14, q36,
  q28 and q69 of the 13 lowered last (``test_torch_sql_tpcds_subqueries.py``:
  ROLLUP over a union of three channels, the set operations and the
  subqueries). They are split over this file and
  ``test_torch_sql_tpcds_windows.py`` / ``test_torch_sql_tpcds_ratios.py`` /
  ``test_torch_sql_tpcds_subqueries.py``, which import the fixture and
  helpers from here, so that no file holds one worker for long.

Tolerance: ``check_rows``: exact on keys, integers, strings and decimals,
rel 1e-9 on each text's float columns (sums of doubles in another order;
q28's averages are ``sum(x*cnt)/sum(cnt)`` after the DISTINCT rewrite).
"""

import pytest

from spark_rapids_tpu.benchmarks import tpcds as jtpcds
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.sql.tpcds_queries import SQL_QUERIES as JSQL

from spark_rapids_tpu_torch.benchmarks import tpcds
from spark_rapids_tpu_torch.exec import joins as XJ
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.sql.tpcds_queries import SQL_QUERIES

SF = 0.012
ORACLES = tpcds.sql_suite_oracles()
# one text over the TPC-DS views for each construct the lowering still
# refuses
REFUSED = {
    "like": "select i_item_id from item where i_item_id like 'ITEM%1'",
    "remainder": "select ss_quantity % 7 from store_sales",
    "concat": "select i_brand || i_class from item",
    "stddev": "select stddev(ss_quantity) from store_sales",
    "no from": "select 1",
    "timestamp literal": "select d_date_sk from date_dim "
                         "where d_date < timestamp '2000-01-01 00:00:00'",
    "string function": "select upper(i_brand) from item",
    "math function": "select round(ss_list_price, 1) from store_sales",
    "nullif": "select nullif(ss_quantity, 0) from store_sales",
    "variance": "select var_pop(ss_quantity) from store_sales",
    "smallint cast": "select cast(ss_quantity as smallint) from store_sales",
    "untyped null": "select null from item",
    "in over columns": "select i_item_sk from item "
                       "where i_item_sk in (i_brand_id, i_class_id)",
}
# refused texts the reference cannot run, each beside a text of the same
# answer that it runs: it collects no untyped NULL column (its arrow
# conversion has no null type), evaluates no IN over columns, and compares
# no date with a timestamp (its ``promote`` has no such pair; Spark
# compares the date's midnight)
REFERENCE_FAILS = {
    "timestamp literal": "select d_date_sk from date_dim "
                         "where d_date < date '2000-01-01'",
    "untyped null": "select i_item_sk from item",
    "in over columns": "select i_item_sk from item "
                       "where i_item_sk = i_brand_id "
                       "or i_item_sk = i_class_id",
}
NEW = ["q43", "q97", "q53", "q63", "q89", "q98", "q12", "q20", "q61", "q19",
       "q15"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(port session, reference session, numpy tables) over one SF 0.012
    generation; both sessions register every table as a temp view."""
    paths = tpcds.generate(SF, str(tmp_path_factory.mktemp("tpcds_sql")))
    spark = TorchSession(device="cpu")
    tpcds.load(spark, paths)
    ref = TpuSession()
    jtpcds.load(ref, paths)
    return spark, ref, tpcds.load_np(paths)


def rows(df):
    return [tuple(r.values()) for r in df.collect().to_pylist()]


def matches_the_reference_session(data, name):
    """The text through both sessions: equal under ``check_rows`` and
    equal to the oracle."""
    spark, ref, tb = data
    got = rows(spark.sql(SQL_QUERIES[name]))
    want = rows(ref.sql(JSQL[name]))
    oracle, float_cols = ORACLES[name]
    assert want, "vacuous: the reference returned no rows"
    tpcds.check_rows(got, want, float_cols)
    tpcds.check_rows(got, [tuple(r) for r in oracle(tb)], float_cols)
    return got


def test_sql_text_is_the_references():
    assert SQL_QUERIES == JSQL
    assert len(SQL_QUERIES) == 40
    assert sorted(tpcds.SQL_PORTED) == sorted(SQL_QUERIES)
    assert len(set(tpcds.SQL_PORTED)) == 40
    assert set(NEW) <= set(tpcds.SQL_PORTED)


def test_oracles_equal_the_references(data):
    _, _, tb = data
    ref = jtpcds.sql_suite_oracles()
    for name, (fn, float_cols) in ORACLES.items():
        assert float_cols == ref[name][1], name
        assert fn(tb) == ref[name][0](tb), name


@pytest.mark.parametrize("name", tpcds.SQL_PORTED)
def test_sql_text_matches_the_oracle(data, name):
    spark, _, tb = data
    got = rows(spark.sql(SQL_QUERIES[name]))
    oracle, float_cols = ORACLES[name]
    exp = [tuple(r) for r in oracle(tb)]
    assert exp, "vacuous test: the oracle returned no rows"
    tpcds.check_rows(got, exp, float_cols)


@pytest.mark.parametrize("name", list(REFUSED))
def test_unported_texts_raise_while_lowered(data, name):
    """Each text here was refused while lowered until the expression slice
    ported its construct; under its old name it now lowers and gives the
    reference session's rows (floats within 1e-9 relative)."""
    spark, ref, _ = data
    got = sorted(rows(spark.sql(REFUSED[name])), key=repr)
    if name in REFERENCE_FAILS:
        # the reference fails on the text (ROADMAP Queue 3): Spark's answer
        # through a text it runs
        with pytest.raises(Exception):
            ref.sql(REFUSED[name]).collect()
        exp = sorted(rows(ref.sql(REFERENCE_FAILS[name])), key=repr)
        exp = [tuple(None for _ in r) if name == "untyped null" else r
               for r in exp]
    else:
        exp = sorted(rows(ref.sql(REFUSED[name])), key=repr)
    assert len(got) == len(exp) and exp
    for g, e in zip(got, exp):
        assert g == pytest.approx(e, rel=1e-9, nan_ok=True), (name, g, e)


def test_sql_equals_the_dataframe_twins(data):
    """The 20 texts with a DataFrame twin (all the DataFrame queries but
    q6 and q27: q27's text rolls up, its DataFrame query does not) give the
    twin's rows."""
    spark, _, _ = data
    dfs = dict(spark._views)
    twins = [q for q in tpcds.SQL_PORTED
             if q in tpcds.QUERIES and q != "q27"]
    assert len(twins) == 20
    for q in twins:
        tpcds.check_rows(rows(spark.sql(SQL_QUERIES[q])),
                         rows(tpcds.QUERIES[q](dfs)), tpcds.FLOAT_COLS[q])


def _joins(plan, cls):
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children:
        out += _joins(c, cls)
    return out


def test_q97_runs_a_full_outer_join_on_the_rank_path(data):
    spark, _, tb = data
    plan = spark.sql(SQL_QUERIES["q97"]).physical_plan()
    got = [tuple(r.values()) for r in plan.execute_collect().to_pylist()]
    assert got == [tuple(r) for r in tpcds.np_q97(tb)]
    (full,) = [j for j in _joins(plan, XJ.HashJoinExec)
               if j.join_type == "fullouter"]
    assert full.stats["probe_mode"] == "rank"
    store_only, catalog_only, both = got[0]
    # the unmatched build (catalog) rows are the catalog-only pairs
    assert full.build_side == "right"
    assert full.stats["unmatched_build_rows"] == catalog_only > 0
    assert store_only > 0 and both > 0


def test_q61_runs_a_nested_loop_join(data):
    spark, _, _ = data
    plan = spark.sql(SQL_QUERIES["q61"]).physical_plan()
    plan.execute_collect()
    (nlj,) = _joins(plan, XJ.NestedLoopJoinExec)
    assert nlj.join_type == "inner" and nlj.stats["pairs"] == 1


@pytest.mark.parametrize("name", ["q43", "q97", "q19", "q15"])
def test_new_texts_match_the_reference_session(data, name):
    matches_the_reference_session(data, name)
