"""The null expressions, ``Substring`` and ``UnaryMinus`` of the PyTorch port
on the CPU, held against the JAX package.

The same arrow arrays (numpy seeds, nulls included) go to the device
through each package's own arrow conversion, and each expression is
evaluated by both on the same columns: ``IsNull``, ``IsNotNull``,
``IsNaN``, ``Coalesce`` (ints of two widths, doubles, decimals, dates,
strings of two dictionaries), ``NaNvl``, ``AtLeastNNonNulls``,
``UnaryMinus``, and ``Substring`` over dictionary strings at positions and
lengths of every sign (``java_substring`` itself against the reference's on
every combination, where the reference is Spark's: a negative position
that reaches before the string's start is the one place it is not). A
string result's dictionary must be sorted and unique, so that codes
compare as the strings do; a comparison of two
substrings over two dictionaries (TPC-DS q19's
``substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)``) runs through both
sessions.

Tolerance: none. Values, validity bits, and for strings the dictionary
and the codes, are compared exactly.
"""

from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.columnar import arrow as RA
from spark_rapids_tpu.expr import arithmetic as RAR
from spark_rapids_tpu.expr import core as RE
from spark_rapids_tpu.expr import nullexprs as RN
from spark_rapids_tpu.expr import predicates as RP
from spark_rapids_tpu.expr import strings as RS
from spark_rapids_tpu.ops import strings as ROS
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.columnar import arrow as PA
from spark_rapids_tpu_torch.expr import arithmetic as AR
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import nullexprs as N
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.ops import strings as OS
from spark_rapids_tpu_torch.session import TorchSession

CAP = 64
N_ROWS = 50


def _both(arr):
    """One arrow array as a port Col and a reference Col."""
    return (E.Col.from_vector(PA.array_to_device(arr, None, CAP, "cpu")),
            RE.Col.from_vector(RA.array_to_device(arr, None, CAP)))


def _eval(port_expr, ref_expr, cols):
    pc = port_expr.eval(E.EvalContext([c[0] for c in cols], N_ROWS, CAP,
                                      "cpu"))
    rc = ref_expr.eval(RE.EvalContext([c[1] for c in cols], N_ROWS, CAP))
    return pc, rc


def _assert_same(pc, rc):
    assert str(pc.dtype) == str(rc.dtype)
    pm, rm = pc.validity.numpy(), np.asarray(rc.validity)
    np.testing.assert_array_equal(pm, rm)
    pv, rv = pc.values.numpy(), np.asarray(rc.values)
    # values compare where valid; invalid slots hold the canonical default
    # in both (checked where the reference canonicalizes)
    np.testing.assert_array_equal(pv[pm], rv[rm])
    if pc.dictionary is not None or rc.dictionary is not None:
        assert pc.dictionary.to_pylist() == rc.dictionary.to_pylist()
        d = pc.dictionary.to_pylist()
        assert d == sorted(set(d))          # sorted and unique


def _nulls(rng, values, p=0.25):
    return [None if rng.random() < p else v for v in values]


def _arrays(seed):
    rng = np.random.default_rng(seed)
    ints = _nulls(rng, rng.integers(-50, 50, N_ROWS).tolist())
    longs = _nulls(rng, rng.integers(-2**40, 2**40, N_ROWS).tolist())
    dbl = rng.normal(size=N_ROWS)
    dbl[rng.random(N_ROWS) < 0.1] = np.nan
    doubles = _nulls(rng, dbl.tolist())
    strs = _nulls(rng, [f"{w}{rng.integers(0, 30)}" for w in
                        rng.choice(["ab", "zip-1000", "x", ""], N_ROWS)])
    strs2 = _nulls(rng, [f"q{rng.integers(0, 9)}" for _ in range(N_ROWS)])
    decs = _nulls(rng, [Decimal(int(v)).scaleb(-2) for v in
                        rng.integers(-10**6, 10**6, N_ROWS)])
    dates = _nulls(rng, rng.integers(0, 20000, N_ROWS).tolist())
    return {
        "int": pa.array(ints, pa.int32()),
        "long": pa.array(longs, pa.int64()),
        "double": pa.array(doubles, pa.float64()),
        "string": pa.array(strs, pa.string()),
        "string2": pa.array(strs2, pa.string()),
        "decimal": pa.array(decs, pa.decimal128(9, 2)),
        "date": pa.array(dates, pa.int32()).cast(pa.date32()),
    }


KINDS = ["int", "long", "double", "string", "decimal", "date"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_is_null_and_is_not_null(kind, seed):
    col = _both(_arrays(seed)[kind])
    ref = RE.BoundReference(0, col[1].dtype)
    for pcls, rcls in ((N.IsNull, RN.IsNull), (N.IsNotNull, RN.IsNotNull)):
        pe = pcls(E.BoundReference(0, col[0].dtype))
        assert str(pe.dtype) == "boolean" and not pe.nullable
        pc, rc = _eval(pe, rcls(ref), [col])
        _assert_same(pc, rc)
        # the padding past the live rows is never null-tested true
        assert not pc.values[N_ROWS:].any() or pcls is N.IsNotNull


@pytest.mark.parametrize("pair", [("int", "long"), ("long", "int"),
                                  ("double", "double"), ("decimal", "decimal"),
                                  ("date", "date"), ("string", "string2"),
                                  ("string2", "string")])
@pytest.mark.parametrize("seed", [2, 3])
def test_coalesce(pair, seed):
    arrs, other = _arrays(seed), _arrays(seed + 10)
    a, b = _both(arrs[pair[0]]), _both(other[pair[1]])
    pe = N.Coalesce(E.BoundReference(0, a[0].dtype),
                    E.BoundReference(1, b[0].dtype))
    re_ = RN.Coalesce(RE.BoundReference(0, a[1].dtype),
                      RE.BoundReference(1, b[1].dtype))
    pc, rc = _eval(pe, re_, [a, b])
    _assert_same(pc, rc)
    # three children, the last one a literal: never null
    if pair[0] in ("int", "long", "double"):
        pe3 = N.Coalesce(E.BoundReference(0, a[0].dtype),
                         E.BoundReference(1, b[0].dtype), E.Literal(7))
        re3 = RN.Coalesce(RE.BoundReference(0, a[1].dtype),
                          RE.BoundReference(1, b[1].dtype), RE.Literal(7))
        pc, rc = _eval(pe3, re3, [a, b])
        _assert_same(pc, rc)
        assert pc.validity[:N_ROWS].all()


@pytest.mark.parametrize("seed", [4, 5])
def test_isnan_nanvl_and_at_least_n_non_nulls(seed):
    arrs = _arrays(seed)
    d, i, s = _both(arrs["double"]), _both(arrs["int"]), _both(arrs["string"])
    pd_, rd = E.BoundReference(0, d[0].dtype), RE.BoundReference(0, d[1].dtype)
    _assert_same(*_eval(N.IsNaN(pd_), RN.IsNaN(rd), [d]))
    _assert_same(*_eval(N.NaNvl(pd_, E.Literal(-1.0)),
                        RN.NaNvl(rd, RE.Literal(-1.0)), [d]))
    for n in (1, 2, 3):
        pe = N.AtLeastNNonNulls(n, pd_, E.BoundReference(1, i[0].dtype),
                                E.BoundReference(2, s[0].dtype))
        re_ = RN.AtLeastNNonNulls(n, rd, RE.BoundReference(1, i[1].dtype),
                                  RE.BoundReference(2, s[1].dtype))
        pc, rc = _eval(pe, re_, [d, i, s])
        np.testing.assert_array_equal(pc.values.numpy()[:N_ROWS],
                                      np.asarray(rc.values)[:N_ROWS])


@pytest.mark.parametrize("kind", ["int", "long", "double", "decimal"])
def test_unary_minus(kind):
    col = _both(_arrays(6)[kind])
    pc, rc = _eval(AR.UnaryMinus(E.BoundReference(0, col[0].dtype)),
                   RAR.UnaryMinus(RE.BoundReference(0, col[1].dtype)), [col])
    _assert_same(pc, rc)


POSITIONS = [-9, -3, -1, 0, 1, 2, 4, 12]
LENGTHS = [None, -1, 0, 1, 3, 5, 40]


def _spark_substring(w, pos, length):
    """Spark's answer through the reference's helper. Where a negative
    position reaches before the string's start and a length is given,
    Spark counts the end from that unclamped start
    (``UTF8String.substringSQL``), so the answer is the prefix of
    ``len(w) + pos + length`` characters. The reference clamps the start
    first and keeps the whole length (ROADMAP Queue 3)."""
    if pos < 0 and len(w) + pos < 0 and length is not None:
        return ROS.java_substring(w, 1, len(w) + pos + length)
    return ROS.java_substring(w, pos, length)


def test_java_substring_matches_the_reference():
    """Bit for bit the reference's wherever the reference is Spark's."""
    words = ["", "a", "zip-10005", "héllo wörld", "TPC-DS"]
    for w in words:
        for p in POSITIONS:
            for ln in LENGTHS:
                assert OS.java_substring(w, p, ln) == \
                    _spark_substring(w, p, ln), (w, p, ln)


@pytest.mark.parametrize("pos,length,spark,reference", [
    (-5, 3, "a", "abc"), (-5, 2, "", "ab"), (-4, 3, "ab", "abc"),
    (-4, 1, "", "a"), (-3, 2, "ab", "ab")])
def test_substring_before_the_start_counts_the_length_from_there(
        tmp_path, pos, length, spark, reference):
    """``substring('abc', -5, 3)`` is 'a' in Spark (the frame [-2, 1)
    keeps one character); the reference answers 'abc'. Through both
    sessions' SQL on the same file."""
    assert OS.java_substring("abc", pos, length) == spark
    assert ROS.java_substring("abc", pos, length) == reference
    path = str(tmp_path / "abc.parquet")
    pq.write_table(pa.table({"s": pa.array(["abc", None, "abc"])}), path)
    out = []
    for sess in (TorchSession(device="cpu"), TpuSession()):
        sess.create_or_replace_temp_view("t", sess.read_parquet(path))
        out.append([r["p"] for r in sess.sql(
            f"select substr(s, {pos}, {length}) as p from t"
        ).collect().to_pylist()])
    assert out == [[spark, None, spark], [reference, None, reference]]


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("length", LENGTHS)
def test_substring_on_dictionary_strings(pos, length):
    col = _both(_arrays(7)["string"])
    args = [E.Literal(pos)] + ([E.Literal(length)] if length is not None
                               else [])
    rargs = [RE.Literal(pos)] + ([RE.Literal(length)] if length is not None
                                 else [])
    pe = S.Substring(E.BoundReference(0, col[0].dtype), *args)
    re_ = RS.Substring(RE.BoundReference(0, col[1].dtype), *rargs)
    pc, rc = _eval(pe, re_, [col])
    words = _arrays(7)["string"].to_pylist()[:N_ROWS]
    want = [None if w is None else _spark_substring(w, pos, length)
            for w in words]
    d = pc.dictionary.to_pylist()
    assert d == sorted(set(d))              # sorted and unique
    valid = pc.validity.numpy()[:N_ROWS]
    codes = pc.values.numpy()[:N_ROWS]
    assert [d[k] if v else None for k, v in zip(codes, valid)] == want
    if all(w is None or _spark_substring(w, pos, length)
           == ROS.java_substring(w, pos, length) for w in words):
        _assert_same(pc, rc)                # bit for bit where Spark's
        np.testing.assert_array_equal(pc.values.numpy(),
                                      np.asarray(rc.values))


def test_substring_refuses_non_literal_arguments():
    s = E.BoundReference(0, E.Literal("x").dtype)
    n = E.BoundReference(1, E.Literal(1).dtype)
    with pytest.raises(NotImplementedError):
        _ = S.Substring(s, n).dtype
    with pytest.raises(NotImplementedError):
        _ = S.Substring(n, E.Literal(1)).dtype


def test_substrings_of_two_dictionaries_compare_as_strings(tmp_path):
    """q19's ``substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)``: the two
    results have two dictionaries, which the comparison aligns."""
    rng = np.random.default_rng(8)
    a = pa.array([f"{rng.integers(10000, 10040)}-{rng.integers(0, 99)}"
                  for _ in range(N_ROWS)])
    b = pa.array([f"{rng.integers(10000, 10040)}{rng.integers(0, 9)}"
                  for _ in range(N_ROWS)])
    ca, cb = _both(a), _both(b)
    for pcls, rcls in ((P.NotEqual, RP.NotEqual), (P.EqualTo, RP.EqualTo),
                       (P.LessThan, RP.LessThan)):
        pe = pcls(S.Substring(E.BoundReference(0, ca[0].dtype),
                              E.Literal(1), E.Literal(5)),
                  S.Substring(E.BoundReference(1, cb[0].dtype),
                              E.Literal(1), E.Literal(5)))
        re_ = rcls(RS.Substring(RE.BoundReference(0, ca[1].dtype),
                                RE.Literal(1), RE.Literal(5)),
                   RS.Substring(RE.BoundReference(1, cb[1].dtype),
                                RE.Literal(1), RE.Literal(5)))
        pc, rc = _eval(pe, re_, [ca, cb])
        _assert_same(pc, rc)
        want = [pcls is P.NotEqual and x[:5] != y[:5]
                or pcls is P.EqualTo and x[:5] == y[:5]
                or pcls is P.LessThan and x[:5] < y[:5]
                for x, y in zip(a.to_pylist(), b.to_pylist())]
        assert pc.values.numpy()[:N_ROWS].tolist() == want
    # and through both sessions' SQL, with a group-by over the substring
    path = str(tmp_path / "z.parquet")
    pq.write_table(pa.table({"a": a, "b": b}), path)
    out = []
    for sess in (TorchSession(device="cpu"), TpuSession()):
        sess.create_or_replace_temp_view("z", sess.read_parquet(path))
        out.append(sess.sql(
            "select substr(a, 1, 5) as p, count(*) as n from z "
            "where substr(a, 1, 5) <> substr(b, 1, 5) "
            "group by substr(a, 1, 5) order by p").collect().to_pylist())
    assert out[0] == out[1] and out[0]


@pytest.mark.parametrize("seed", [9, 10])
def test_null_functions_through_sql(tmp_path, seed):
    """IS [NOT] NULL, coalesce, CASE with a NULL branch, abs and negation in
    SQL text, through both sessions on the same file."""
    arrs = _arrays(seed)
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({k: arrs[k] for k in ("int", "long", "double",
                                                  "string", "decimal")}
                            | {"id": pa.array(np.arange(N_ROWS))}), path)
    text = ("select id, coalesce(int, long) as c, -double as nd, "
            "abs(decimal) as ad, coalesce(string, 'none') as s, "
            "case when int is null then null when int > 0 then long "
            "else -long end as w, "
            "case when string is not null then 1 end as has "
            "from t where long is not null or double is null order by id")
    out = []
    for sess in (TorchSession(device="cpu"), TpuSession()):
        sess.create_or_replace_temp_view("t", sess.read_parquet(path))
        out.append(sess.sql(text).collect())
    assert out[0].schema.names == out[1].schema.names
    got, want = out[0].to_pylist(), out[1].to_pylist()
    assert got
    for g, w in zip(got, want):
        for k in g:
            if isinstance(w[k], float) and np.isnan(w[k]):
                assert np.isnan(g[k])
            else:
                assert g[k] == w[k], (k, g, w)
    assert len(got) == len(want)
