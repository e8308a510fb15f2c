"""The port's CSV scan (``io/csv_native.py``, ``ops/csv_decode.py``, the CSV
half of ``io/filescan.py``, ``io/readers.CsvReader``) held against the JAX
package: the cases of the reference's ``tests/test_io.py`` CSV tests, each
through ``TorchSession(device="cpu")`` and ``TpuSession`` with the same
confs on the same file (header name mapping, quotes, malformed fields to
null, overflow and over-long fields, the float gate, the scope fallbacks and
the fuzz comparison), the host boundary scan array for array, and the three
parse functions on the same fields.

Tolerance: exact. The port's double parse is bit for bit the reference's
(the same digit loop and one division by an exact power of ten); against
pyarrow's parse (strtod) it is exact on plain decimals of up to 15
significant digits and within 1 ulp at 16 (past 16 digits it is off by up
to 4 ulp, as the reference's is: ``test_double_parse_against_strtod``).
One documented difference:
the exponent/inf/nan gate looks at the double columns' fields only, so a
file whose string column holds those letters keeps the device parse, where
the reference reads it through arrow; the values are the same.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.io import csv_native as JCN
from spark_rapids_tpu.ops import csv_decode as JCD
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.io import csv_native as CN
from spark_rapids_tpu_torch.ops import csv_decode as CD
from spark_rapids_tpu_torch.session import TorchSession

DEV = "spark.rapids.tpu.sql.csv.deviceDecode.enabled"
FLOATS = "spark.rapids.tpu.sql.csv.read.float.enabled"
ON = {DEV: "true"}
ON_F = {DEV: "true", FLOATS: "true"}


def _write(tmp_path, text, name="t.csv"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _schemas(*fields):
    return (T.StructType([T.StructField(n, getattr(T, t)) for n, t in fields]),
            JT.StructType([JT.StructField(n, getattr(JT, t))
                           for n, t in fields]))


def _both(path, fields, conf=None, **kw):
    """The port's and the reference's read_csv of one file, and the port's
    CSV routes."""
    s, js = _schemas(*fields) if fields else (None, None)
    CN.reset_routes()
    got = TorchSession(dict(conf or {}), device="cpu").read_csv(
        path, schema=s, **kw).collect()
    routes = dict(CN.routes)
    want = TpuSession(dict(conf or {})).read_csv(path, schema=js,
                                                 **kw).collect()
    assert got.equals(want), (got, want)
    return got, routes


DEVICE = {"device_files": 1, "arrow_files": 0}
ARROW = {"device_files": 0, "arrow_files": 1}


def test_csv_scan_with_schema(tmp_path):
    path = _write(tmp_path, "a,b,c\n1,x,2.5\n2,,\n,z,0.25\n")
    got, routes = _both(path, [("a", "INT"), ("b", "STRING"),
                               ("c", "DOUBLE")], ON_F)
    assert got.column("a").to_pylist() == [1, 2, None]
    assert got.column("b").to_pylist() == ["x", None, "z"]
    assert got.column("c").to_pylist() == [2.5, None, 0.25]
    assert routes == ARROW          # a string column: the arrow reader


def test_csv_disabled_raises_at_planning(tmp_path):
    path = _write(tmp_path, "a\n1\n2\n")
    spark = TorchSession({"spark.rapids.tpu.sql.format.csv.enabled": "false"},
                         device="cpu")
    df = spark.read_csv(path)
    with pytest.raises(NotImplementedError, match="csv.enabled"):
        df.physical_plan()


def test_csv_ints_device_equals_host(tmp_path):
    text = "a,b\n1,10\n-5,9223372036854775807\n,42\n8,-9223372036854775808\n"
    path = _write(tmp_path, text)
    on, r_on = _both(path, [("a", "LONG"), ("b", "LONG")], ON)
    off, r_off = _both(path, [("a", "LONG"), ("b", "LONG")], {DEV: "false"})
    assert r_on == DEVICE and r_off == ARROW
    assert on["a"].to_pylist() == off["a"].to_pylist() == [1, -5, None, 8]
    assert on["b"].to_pylist() == off["b"].to_pylist() == \
        [10, 9223372036854775807, 42, -9223372036854775808]
    # '+7' parses as Long.parseLong does on the device; pyarrow refuses it
    p2 = _write(tmp_path, "a\n+7\n", name="plus.csv")
    got, _ = _both(p2, [("a", "LONG")], ON)
    assert got["a"].to_pylist() == [7]


def test_csv_malformed_is_null(tmp_path):
    path = _write(tmp_path, "a\n12\nx9\n--3\n+\n8\n")
    got, routes = _both(path, [("a", "LONG")], ON)
    assert got["a"].to_pylist() == [12, None, None, None, 8]
    assert routes == DEVICE


def test_csv_doubles_gated(tmp_path):
    path = _write(tmp_path, "x,y\n1.5,2\n-0.25,7\n,0\n3.,1\n")
    fields = [("x", "DOUBLE"), ("y", "LONG")]
    out, r = _both(path, fields, {FLOATS: "true"})   # not engaged on CPU
    assert out["x"].to_pylist() == [1.5, -0.25, None, 3.0] and r == ARROW
    out, r = _both(path, fields, ON)                 # the gate off
    assert r == ARROW
    on, r = _both(path, fields, ON_F)
    assert r == DEVICE
    assert on["x"].to_pylist() == [1.5, -0.25, None, 3.0]
    assert on["y"].to_pylist() == [2, 7, 0, 1]


def test_csv_fallback_scope(tmp_path):
    """Exponents and quoted strings take the arrow reader, same results."""
    path = _write(tmp_path, "x\n1e3\n2.5\n", name="e.csv")
    out, r = _both(path, [("x", "DOUBLE")], ON_F)
    assert out["x"].to_pylist() == [1000.0, 2.5] and r == ARROW
    path2 = _write(tmp_path, 's\n"a,b"\nplain\n', name="q.csv")
    out2, r2 = _both(path2, [("s", "STRING")], ON)
    assert out2["s"].to_pylist() == ["a,b", "plain"] and r2 == ARROW


def test_csv_equivalence_fuzz(tmp_path):
    rng = np.random.default_rng(5)
    n = 500
    a = rng.integers(-10**12, 10**12, n)
    rows = ["a,b"]
    for i in range(n):
        av = "" if rng.random() < 0.1 else str(a[i])
        rows.append(f"{av},{rng.integers(-2**31, 2**31 - 1)}")
    path = _write(tmp_path, "\n".join(rows) + "\n", name="f.csv")
    fields = [("a", "LONG"), ("b", "INT")]
    on, r_on = _both(path, fields, ON)
    off, r_off = _both(path, fields, {DEV: "false"})
    assert (r_on, r_off) == (DEVICE, ARROW)
    assert on.equals(off)


def test_csv_header_name_mapping(tmp_path):
    path = _write(tmp_path, "b,a\n1,2\n3,4\n", name="swap.csv")
    out, r = _both(path, [("a", "LONG"), ("b", "LONG")], ON)
    assert out["a"].to_pylist() == [2, 4] and out["b"].to_pylist() == [1, 3]
    assert r == DEVICE


def test_csv_overflow_and_overlong(tmp_path):
    text = ("a\n9223372036854775807\n9223372036854775808\n"
            "-9223372036854775808\n-9223372036854775809\n"
            "123456789012345678901234567\n7\n")
    path = _write(tmp_path, text, name="ovf.csv")
    out, r = _both(path, [("a", "LONG")], ON)
    assert out["a"].to_pylist() == [9223372036854775807, None,
                                    -9223372036854775808, None, None, 7]
    assert r == DEVICE
    p2 = _write(tmp_path, "a\n2147483647\n2147483648\n-2147483649\n1\n",
                name="i32.csv")
    out, r = _both(p2, [("a", "INT")], ON)
    assert out["a"].to_pylist() == [2147483647, None, None, 1]


def test_csv_quoted_fields_device_path(tmp_path):
    path = _write(tmp_path, 'a,b\n"5",10\n6,"20"\n"7","30"\n,40\n',
                  name="qint.csv")
    fields = [("a", "LONG"), ("b", "LONG")]
    s, js = _schemas(*fields)
    assert CN.try_scan_for_device(path, s, ",", True, False) is not None
    out, r = _both(path, fields, ON)
    assert out["a"].to_pylist() == [5, 6, 7, None]
    assert out["b"].to_pylist() == [10, 20, 30, 40]
    assert r == DEVICE


@pytest.mark.parametrize("text,rows", [
    ('a,b\n"1,5",10\n2,20\n', 2),     # delimiter inside quotes: content
    ('a,b\n"1\n5",10\n2,20\n', 2),    # newline inside quotes: content
    ('a\n"5""6"\n', None),            # a doubled quote: the arrow reader
    ('a\n"5\n', None),                # unterminated: the arrow reader
    ("a,b\n1,2\n3\n", None),          # ragged rows
    ("a,b\n1,2\r\n", None),           # CR line ends
    ("a,b\n1,2,\n", None),            # a trailing delimiter
    ('"a",b\n1,2\n', None),           # a quoted header
    ("c,b\n1,2\n", None),             # a schema column not in the header
    ("a,b\n", 0),                     # a header and no rows
])
def test_boundary_scan_matches_reference(tmp_path, text, rows):
    path = _write(tmp_path, text, name="b.csv")
    s, js = _schemas(("a", "LONG"), ("b", "LONG"))
    got = CN.try_scan_for_device(path, s, ",", True, False)
    want = JCN.try_scan_for_device(path, js, ",", True, False)
    assert (got is None) == (want is None) == (rows is None)
    if got is not None:
        assert got.n_rows == want.n_rows == rows
        assert got.col_of == want.col_of
        np.testing.assert_array_equal(got.starts, want.starts)
        np.testing.assert_array_equal(got.lens, want.lens)
        np.testing.assert_array_equal(got.data, want.data)


def test_csv_float_gate_ignores_header_letters(tmp_path):
    path = _write(tmp_path, "price,value\n1.5,2.25\n", name="hdr.csv")
    fields = [("price", "DOUBLE"), ("value", "DOUBLE")]
    s, _js = _schemas(*fields)
    assert CN.try_scan_for_device(path, s, ",", True, True) is not None
    out, r = _both(path, fields, ON_F)
    assert out["price"].to_pylist() == [1.5]
    assert out["value"].to_pylist() == [2.25]
    assert r == DEVICE


def test_csv_float_gate_looks_at_double_fields_only(tmp_path):
    """Letters in a string column keep the port's device parse (the
    reference reads the file through arrow); an exponent in a double field
    still sends the file to arrow. The values are the same."""
    path = _write(tmp_path, "f,x\nN,1.25\nA,-0.5\nR,3\n", name="flag.csv")
    s, js = _schemas(("x", "DOUBLE"))
    assert CN.try_scan_for_device(path, s, ",", True, True) is not None
    assert JCN.try_scan_for_device(path, js, ",", True, True) is None
    out, r = _both(path, [("x", "DOUBLE")], ON_F)
    assert r == DEVICE and out["x"].to_pylist() == [1.25, -0.5, 3.0]
    p2 = _write(tmp_path, "f,x\nN,1.25\nA,2e1\n", name="exp.csv")
    assert CN.try_scan_for_device(p2, s, ",", True, True) is None
    out, r = _both(p2, [("x", "DOUBLE")], ON_F)
    assert r == ARROW and out["x"].to_pylist() == [1.25, 20.0]


def _fields(rng, n):
    """Random numeric fields (plain, signed, long fractions, malformed and
    empty) as CSV bytes with their starts and lengths."""
    pieces = []
    for _ in range(n):
        k = rng.random()
        if k < 0.3:
            v = str(int(rng.integers(-2**63, 2**63 - 1, dtype=np.int64)))
        elif k < 0.6:
            v = f"{rng.uniform(-1e6, 1e6):.{int(rng.integers(0, 12))}f}"
        elif k < 0.7:
            v = "0." + "".join(rng.choice(list("0123456789"), 20))
        elif k < 0.8:
            v = rng.choice(["", "-", "+", "1.2.3", "x1", "--1", "+5", "7."])
        else:
            v = str(int(rng.integers(-2**31, 2**31)))
        pieces.append(v.encode())
    data = b"".join(pieces)
    lens = np.array([len(p) for p in pieces], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    return np.frombuffer(data, np.uint8), starts, lens


def test_parse_functions_match_reference():
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    n = 2048
    data, starts, lens = _fields(rng, n)
    lens[-8:] = -1                                   # padding rows
    args_t = (torch.from_numpy(data.copy()), torch.from_numpy(starts),
              torch.from_numpy(lens))
    args_j = (jnp.asarray(data), jnp.asarray(starts), jnp.asarray(lens))
    for fn, jfn in ((CD.parse_int64, JCD.parse_int64),
                    (CD.parse_int32, JCD.parse_int32),
                    (CD.parse_float64, JCD.parse_float64)):
        v, m = fn(*args_t, n)
        jv, jm = jfn(*args_j, n)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        gv, wv = v.numpy(), np.asarray(jv)
        if gv.dtype == np.float64:
            gv, wv = gv.view(np.int64), wv.view(np.int64)
        # the reference leaves an out-of-range int32 field's truncated
        # value behind its null; the scan zeroes every null slot
        mask = m.numpy()
        np.testing.assert_array_equal(gv[mask], wv[mask])


def test_double_parse_against_strtod(tmp_path):
    """The device parse against pyarrow's (strtod's) on plain decimals:
    exact up to 15 significant digits, at most 1 ulp at 16. Past 16 digits
    the digit loop's sum rounds before the division and the parse is off by
    up to 4 ulp (the reference's conf doc says 1): those fields are held
    bit for bit to the reference's parse instead, and the gap is recorded
    in ROADMAP.md's Queue 3."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    for nd, bound in ((15, 0), (16, 1), (17, None), (20, None)):
        vals = []
        for _ in range(3000):
            digits = str(rng.integers(1, 10)) + "".join(
                rng.choice(list("0123456789"), nd - 1))
            k = int(rng.integers(0, nd))
            sign = "-" if rng.random() < 0.5 else ""
            vals.append(sign + digits[:nd - k] + "." + digits[nd - k:])
        path = _write(tmp_path, "x\n" + "\n".join(vals) + "\n",
                      name=f"d{nd}.csv")
        s, _js = _schemas(("x", "DOUBLE"))
        got = TorchSession(ON_F, device="cpu").read_csv(
            path, schema=s).collect()
        g = got["x"].to_numpy().view(np.int64)
        if bound is not None:
            want = TorchSession({DEV: "false"}, device="cpu").read_csv(
                path, schema=s).collect()
            w = want["x"].to_numpy().view(np.int64)
            assert int(np.abs(g - w).max()) <= bound, nd
        else:
            data = np.frombuffer(open(path, "rb").read(), np.uint8)
            lens = np.array([len(v) for v in vals], np.int32)
            starts = (2 + np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
                      ).astype(np.int32)
            jv, _jm = JCD.parse_float64(jnp.asarray(data), jnp.asarray(starts),
                                        jnp.asarray(lens), len(vals))
            np.testing.assert_array_equal(g, np.asarray(jv).view(np.int64))


def test_csv_pruned_scan_reads_its_columns(tmp_path):
    """A scan with a header narrows to its query's columns on both
    routes."""
    import spark_rapids_tpu_torch.functions as F
    from spark_rapids_tpu_torch.io.filescan import FileSourceScanExec
    path = _write(tmp_path, "a,b,c\n1,2,3\n4,5,6\n", name="p.csv")
    s, _js = _schemas(("a", "LONG"), ("b", "LONG"), ("c", "LONG"))
    for conf, want_routes in ((ON, DEVICE), ({DEV: "false"}, ARROW)):
        df = TorchSession(conf, device="cpu").read_csv(path, schema=s)
        df = df.filter(F.col("c") > F.lit(3)).select("a")
        plan = df.physical_plan()
        scan = plan
        while not isinstance(scan, FileSourceScanExec):
            scan = scan.children[0]
        assert scan.output.names == ["a", "c"]
        CN.reset_routes()
        assert df.collect()["a"].to_pylist() == [4]
        assert CN.routes == want_routes
    # without a header the schema names the columns in order: no narrowing
    p2 = _write(tmp_path, "1,2,3\n4,5,6\n", name="nh.csv")
    df = TorchSession(ON, device="cpu").read_csv(p2, schema=s, header=False)
    plan = df.select("a").physical_plan()
    scan = plan
    while not isinstance(scan, FileSourceScanExec):
        scan = scan.children[0]
    assert scan.output.names == ["a", "b", "c"]
    assert df.select("a").collect()["a"].to_pylist() == [1, 4]
