"""split in the PyTorch port on the CPU, held against the JAX package.

A numpy-seeded string column (nulls, empty strings, leading, trailing and
doubled separators, non-ASCII) goes through ``TorchSession(device="cpu")``
and ``TpuSession``: the fused ``split(..)[i]`` and ``size(split(..))``
(dictionary transforms), the materialized ``split`` (a list<string>
column: each dictionary entry split once, gathered by code), its explode,
and the port's copy of ``java_split`` against the reference's on its limit
cases (``tests/test_expressions_r2.py``). Then the ``test_gap_*`` cases:
Spark's ``split`` (``UTF8String.split``) treats limit 0 as -1 and an empty
pattern as the characters, and Java's ``String.split`` adds no capture
group's text and no leading empty part for a zero-width match at the
start; the reference's ``re.split`` does otherwise. Tolerance: none
(strings, lists and ints exact).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.expr import core as JE
from spark_rapids_tpu.expr.strings import java_split as ref_java_split
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.expr.strings import java_split, spark_split
from spark_rapids_tpu_torch.session import TorchSession

TEXTS = ["a,b,c", "a,,b", ",lead", "trail,", ",,", "", "one", "déjà,vu,é",
         "x, y ,z", "a,b,c,d,e,f"]


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(71)
    n = 200
    s = [None if rng.random() < 0.1 else TEXTS[int(k)]
         for k in rng.integers(0, len(TEXTS), n)]
    t = pa.table({"k": pa.array(np.arange(n), pa.int64()),
                  "s": pa.array(s, pa.string())})
    return (TorchSession(device="cpu").create_dataframe(t, 2),
            TpuSession().create_dataframe(t, 2))


CASES = {
    "item0": lambda f, e: f.element_at0(f.split("s", ","), 0),
    "item2": lambda f, e: f.element_at0(f.split("s", ","), 2),
    "item-limit": lambda f, e: f.element_at0(f.split("s", ",", 2), 1),
    "size": lambda f, e: f.size(f.split("s", ",")),
    "size-limit": lambda f, e: f.size(f.split("s", ",", 2)),
    "size-regex": lambda f, e: f.size(f.split("s", r"\s*,\s*")),
    "split": lambda f, e: f.split("s", ","),
    "split-limit1": lambda f, e: f.split("s", ",", 1),
    "split-limit3": lambda f, e: f.split("s", ",", 3),
    "split-regex": lambda f, e: f.split("s", r"\s*,\s*"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_as_the_reference(frames, case):
    port, ref = frames
    got = port.select("k", CASES[case](F, JE).alias("r")).collect()
    want = ref.select("k", JE.Alias(CASES[case](JF, JE), "r")).collect()
    assert got.to_pylist() == want.to_pylist()


def test_split_then_extract_from_the_column(frames):
    port, ref = frames
    col = port.select("k", F.split("s", ",").alias("w"))
    got = col.select("k", F.size("w").alias("n"),
                     F.element_at("w", -1).alias("last"),
                     F.array_contains("w", "b").alias("has_b")).collect()
    want = ref.select("k", JE.Alias(JF.split("s", ","), "w")).collect()
    for g, w in zip(got.to_pylist(), want.to_pylist()):
        ws = w["w"]
        assert g["n"] == (-1 if ws is None else len(ws))
        assert g["last"] == (ws[-1] if ws else None)
        assert g["has_b"] == (None if ws is None else "b" in ws)


def test_size_of_a_null_split_is_minus_one(frames):
    port, _ = frames
    out = port.select("s", F.size(F.split("s", ",")).alias("n")).collect()
    for r in out.to_pylist():
        if r["s"] is None:
            assert r["n"] == -1


@pytest.mark.parametrize("s,pat,limit", [
    ("a,b,c", ",", 1), ("a,b,c", ",", 2), ("a,b,c", ",", -1),
    ("a,,", ",", 0), ("a,,", ",", -1), ("", ",", 0), (",", ",", 0),
    ("a1b22c", r"\d+", -1), (" a b ", " ", 0), ("a,b", ";", -1)])
def test_java_split_limit_cases_as_the_reference(s, pat, limit):
    assert java_split(s, pat, limit) == ref_java_split(s, pat, limit)


def test_gap_split_limit_zero():
    """Spark's UTF8String.split turns limit 0 into -1, keeping trailing
    empty strings; the reference passes 0 to Java's rules, which drop
    them."""
    assert spark_split("a,,", ",", 0) == ["a", "", ""]
    assert ref_java_split("a,,", ",", 0) == ["a"]
    df = TorchSession(device="cpu").create_dataframe(pa.table({"s": ["a,,"]}))
    assert df.select(F.split("s", ",", 0).alias("w")).collect().column(
        "w").to_pylist() == [["a", "", ""]]


def test_gap_split_empty_pattern():
    """Spark splits a non-empty string on an empty pattern into its
    characters; the reference's re.split adds empty strings at both ends."""
    assert spark_split("abc", "", -1) == ["a", "b", "c"]
    assert spark_split("abc", "", 2) == ["a", "bc"]
    assert spark_split("", "", -1) == [""]
    assert ref_java_split("abc", "", -1) == ["", "a", "b", "c", ""]


def test_gap_split_capture_group_and_zero_width_start():
    """Java's String.split adds no capture group's text and makes no leading
    empty part for a zero-width match at index 0; the reference's re.split
    does both."""
    assert java_split("a1b2c", r"(\d)", -1) == ["a", "b", "c"]
    assert ref_java_split("a1b2c", r"(\d)", -1) == ["a", "1", "b", "2", "c"]
    assert java_split("abc", "(?=a)", -1) == ["abc"]
    assert ref_java_split("abc", "(?=a)", -1) == ["", "abc"]


def test_non_literal_pattern_refused(frames):
    port, _ = frames
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.expr.strings import StringSplit
    with pytest.raises(NotImplementedError):
        port.select(StringSplit(E.col("s"), E.col("s")).alias("w")
                    ).physical_plan()
