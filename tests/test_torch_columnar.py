"""The port's Arrow ↔ device conversion (columnar/arrow.py, vector.py,
batch.py) held against the JAX package's ``ColumnarBatch.from_arrow`` on the
same table, for every ported type with nulls. Tolerance: exact — values,
validity and sorted string dictionaries over the whole padded capacity — and
the round trip back to Arrow gives the input table."""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity


def _table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)

    def mask():
        return rng.random(n) < 0.2

    return pa.table({
        "b": pa.array(rng.random(n) < 0.5, mask=mask()),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=mask()),
        "l": pa.array(rng.integers(-2**62, 2**62, n), mask=mask()),
        "d": pa.array(rng.normal(size=n), mask=mask()),
        "s": pa.array(np.array(["pear", "", "apple", "zz", "é"])[
            rng.integers(0, 5, n)], mask=mask()),
        "dt": pa.array(rng.integers(-1000, 20000, n).astype(np.int32),
                       mask=mask()).cast(pa.date32()),
    })


@pytest.mark.parametrize("n", [0, 1, 8, 9, 1000])
def test_from_arrow_matches_jax_and_round_trips(n):
    t = _table(n, seed=n)
    mine = ColumnarBatch.from_arrow(t, "cpu")
    ref = JBatch.from_arrow(t)
    assert mine.num_rows == ref.num_rows == n
    assert mine.capacity == ref.capacity == bucket_capacity(n)
    for name, tc, jc in zip(t.column_names, mine.columns, ref.columns):
        assert tc.dtype.sql_name == jc.dtype.sql_name, name
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data),
                                      err_msg=name)
        np.testing.assert_array_equal(tc.validity.numpy(),
                                      np.asarray(jc.validity), err_msg=name)
        if tc.is_string:
            assert tc.dictionary.equals(jc.dictionary)
    assert mine.to_arrow().equals(t)


def test_bucket_capacity_matches_jax():
    from spark_rapids_tpu.columnar.vector import bucket_capacity as jbucket
    for n in [0, 1, 7, 8, 9, 1000, 20_000, 1 << 20, (1 << 20) + 1]:
        assert bucket_capacity(n) == jbucket(n)
