"""The official TPC-DS texts with division (q12, q20: the class revenue
ratio, ``sum(x) * 100.0 / sum(sum(x)) over (...)``; q61: the promotion
ratio of two single-row subqueries cross-joined, through
``cast(... as decimal(15,4))``) through ``TorchSession.sql()`` and the
reference's ``TpuSession.sql()`` on the same SF 0.012 files, each also
against its NumPy oracle. The fixture and helpers are
``test_torch_sql_tpcds.py``'s.

Tolerance: ``check_rows``: exact on keys, strings and decimals (q61's
ratio), rel 1e-9 on the float columns.
"""

import decimal

import pytest

from test_torch_sql_tpcds import data, matches_the_reference_session  # noqa: F401


@pytest.mark.parametrize("name", ["q12", "q20", "q61"])
def test_ratio_texts_match_the_reference_session(data, name):
    got = matches_the_reference_session(data, name)
    if name == "q61":
        (row,) = got
        assert isinstance(row[2], decimal.Decimal)
        assert row[2].as_tuple().exponent == -6      # decimal(18,6)
