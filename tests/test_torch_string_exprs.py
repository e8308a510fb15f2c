"""The string expressions of the PyTorch port on the CPU, held against the
JAX package.

One numpy-seeded table (strings with nulls, the empty string, non-ASCII,
spaces, commas, JSON documents; ints) goes through ``TorchSession(device=
"cpu")`` and ``TpuSession``; each case builds the same expression in both
packages (through ``functions.py`` where the reference has the function,
else the ``expr/strings.py`` class of the same name) and the collected
columns must be equal. Tolerance: none (strings, ints and booleans are
compared exactly).

Then the places where the reference differs from Spark, each with the
reference's answer beside the port's (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.expr import core as JE
from spark_rapids_tpu.expr import strings as JS
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.session import TorchSession

WORDS = ["alpha", "Beta", "gamma", "", "déjà vu", "x" * 20, "  pad me  ",
         "a,b,c", "hello world foo", "Customer#000000042", "ab12cd34",
         '{"a": {"b": [1, 2.50, "z"]}, "c": true}', '{"a": 1}', "not json"]


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(15)
    n = 300
    s = [None if rng.random() < 0.1 else WORDS[k]
         for k in rng.integers(0, len(WORDS), n)]
    t2 = [None if rng.random() < 0.1 else WORDS[k]
          for k in rng.integers(0, 6, n)]
    t = pa.table({"s": pa.array(s, pa.string()),
                  "t": pa.array(t2, pa.string()),
                  "i": pa.array(rng.integers(-5, 30, n), pa.int32())})
    ref = TpuSession()
    port = TorchSession(device="cpu")
    return (port.create_dataframe(t, num_partitions=2),
            ref.create_dataframe(t, num_partitions=2))


def _lit(m, v):
    return m.Literal(v)


# one expression per case, made for either package from its (functions
# module, strings expr module, core module)
CASES = {
    "upper": lambda f, s, e: f.upper("s"),
    "lower": lambda f, s, e: f.lower("s"),
    "length": lambda f, s, e: f.length("s"),
    "trim": lambda f, s, e: f.trim("s"),
    "ltrim": lambda f, s, e: s.LTrim(e.col("s")),
    "rtrim": lambda f, s, e: s.RTrim(e.col("s")),
    "reverse": lambda f, s, e: s.Reverse(e.col("s")),
    "initcap": lambda f, s, e: s.InitCap(e.col("s")),
    "md5": lambda f, s, e: f.md5("s"),
    "substring": lambda f, s, e: f.substring("s", 2, 3),
    "startswith": lambda f, s, e: s.StartsWith(e.col("s"), e.Literal("a")),
    "endswith": lambda f, s, e: s.EndsWith(e.col("s"), e.Literal("a")),
    "contains": lambda f, s, e: s.Contains(e.col("s"), e.Literal("ll")),
    "like prefix": lambda f, s, e: f.like("s", "a%"),
    "like both ends": lambda f, s, e: f.like("s", "%er#%4%"),
    "like underscore": lambda f, s, e: f.like("s", "_e%"),
    "rlike": lambda f, s, e: s.RLike(e.col("s"), e.Literal("[0-9]+[a-z]")),
    "concat": lambda f, s, e: f.concat("s", "t"),
    "concat literal": lambda f, s, e: f.concat("s", e.Literal("!")),
    "concat_ws": lambda f, s, e: f.concat_ws("-", "s", "t"),
    "replace": lambda f, s, e: s.StringReplace(
        e.col("s"), e.Literal("a"), e.Literal("<A>")),
    "lpad": lambda f, s, e: f.lpad("s", 8, "*-"),
    "rpad": lambda f, s, e: f.rpad("s", 8, "*-"),
    "repeat": lambda f, s, e: f.repeat("s", 2),
    "locate": lambda f, s, e: f.locate("a", "s", 2),
    "instr": lambda f, s, e: f.instr("s", "l"),
    "substring_index": lambda f, s, e: f.substring_index("s", ",", 2),
    "substring_index back": lambda f, s, e: f.substring_index("s", " ", -1),
    "translate": lambda f, s, e: f.translate("s", "abc", "AB"),
    "find_in_set": lambda f, s, e: f.find_in_set("s", "alpha,gamma,,x"),
    "regexp_replace": lambda f, s, e: f.regexp_replace(
        "s", "([a-z])([0-9])", "$2$1"),
    "regexp_extract": lambda f, s, e: f.regexp_extract(
        "s", "([a-z]+)([0-9]+)", 2),
    "get_json_object": lambda f, s, e: f.get_json_object("s", "$.a.b[1]"),
    "get_json_object obj": lambda f, s, e: f.get_json_object("s", "$.a"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_string_expression_matches_reference(sessions, name):
    port_df, ref_df = sessions
    pe = CASES[name](F, S, E)
    re_ = CASES[name](JF, JS, JE)
    got = port_df.select(pe.alias("v")).collect()
    exp = ref_df.select(re_.alias("v")).collect()
    assert got.schema.field("v").type == exp.schema.field("v").type
    assert got.column("v").to_pylist() == exp.column("v").to_pylist()


def test_result_dictionaries_are_sorted_and_unique(sessions):
    """A string result is re-encoded: equal strings have one code and code
    order is string order, so a group-by over the result is exact."""
    port_df, _ = sessions
    out = port_df.group_by(F.lower("s").alias("k")).agg(
        F.count().alias("n")).collect().to_pylist()
    keys = [r["k"] for r in out]
    assert len(keys) == len(set(keys))


def test_like_to_regex_matches_reference_on_plain_patterns():
    from spark_rapids_tpu.ops import strings as JOS
    from spark_rapids_tpu_torch.ops import strings as OS
    import re
    for pat in ["a%", "%a", "%ta%", "_b_", "100\\%", "a\\_b%", "%", ""]:
        for s in ["a", "ab", "ba", "beta", "100%", "a_bc", "", "xtay"]:
            assert (re.match(OS.like_to_regex(pat), s) is not None) == (
                re.match(JOS.like_to_regex(pat), s) is not None), (pat, s)


# -- where the reference differs from Spark -----------------------------------

def _one(df_port, df_ref, pe, re_):
    return (df_port.select(pe.alias("v")).collect().column("v").to_pylist(),
            df_ref.select(re_.alias("v")).collect().column("v").to_pylist())


@pytest.fixture(scope="module")
def gap_frames():
    t = pa.table({"s": pa.array(["abc", "abc\n", "a\\b", "x"])})
    return (TorchSession(device="cpu").create_dataframe(t),
            TpuSession().create_dataframe(t))


def test_gap_like_does_not_skip_a_trailing_newline(gap_frames):
    """Spark matches the whole string: 'abc\\n' LIKE 'abc' is false. The
    reference's ``$`` lets a trailing newline through."""
    got, ref = _one(*gap_frames, F.like("s", "abc"), JF.like("s", "abc"))
    assert got == [True, False, False, False]
    assert ref == [True, True, False, False]


def test_gap_like_refuses_a_bad_escape(gap_frames):
    """Spark's analyzer refuses an escape before anything but ``_``, ``%``
    or the escape itself, and one that ends the pattern; the reference
    reads ``a\\b`` as ``ab`` and a trailing ``\\`` as a literal."""
    port_df, ref_df = gap_frames
    with pytest.raises(ValueError):
        port_df.select(F.like("s", "a\\b").alias("v")).collect()
    with pytest.raises(ValueError):
        port_df.select(F.like("s", "a\\").alias("v")).collect()
    assert ref_df.select(JF.like("s", "a\\b").alias("v")).collect().column(
        "v").to_pylist() == [False, False, False, False]
    # the escaped escape matches one backslash in both
    got, ref = _one(port_df, ref_df, F.like("s", "a\\\\b"),
                    JF.like("s", "a\\\\b"))
    assert got == ref == [False, False, True, False]


def test_gap_replace_with_an_empty_search(gap_frames):
    """Spark's replace(s, '', r) leaves s as it is; Python's str.replace,
    which the reference calls, puts r between every character."""
    got, ref = _one(*gap_frames,
                    S.StringReplace(E.col("s"), E.Literal(""),
                                    E.Literal("-")),
                    JS.StringReplace(JE.col("s"), JE.Literal(""),
                                     JE.Literal("-")))
    assert got == ["abc", "abc\n", "a\\b", "x"]
    assert ref[0] == "-a-b-c-"


def test_gap_pad_to_a_negative_length(gap_frames):
    """Spark's lpad/rpad to a length below 1 give ''; the reference slices
    ``s[:len]``, which keeps all but the last characters."""
    got, ref = _one(*gap_frames, F.lpad("s", -1, "*"), JF.lpad("s", -1, "*"))
    assert got == ["", "", "", ""]
    assert ref == ["ab", "abc", "a\\", ""]


# -- signed zeros through the value -> string transforms -----------------------

@pytest.mark.parametrize("arrow_type", [pa.float64(), pa.float32()])
def test_gap_cast_of_signed_zeros_to_string(arrow_type):
    """Spark prints -0.0 and 0.0 apart (Java's ``Double.toString`` and
    ``Float.toString``): '-0.0' and '0.0'. The reference's (and before, the
    port's) dictionary transform takes the unique values with one compare,
    under which -0.0 == 0.0, so every zero printed as the zero that sorts
    first. The port makes a float column unique by its bit pattern."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu_torch import types as T
    vals = [0.0, -0.0, 1.5, -0.0, None, 0.0]
    t = pa.table({"d": pa.array(vals, arrow_type)})
    got = TorchSession(device="cpu").create_dataframe(t).select(
        E.col("d").cast(T.STRING).alias("v")).collect().column("v")
    ref = TpuSession().create_dataframe(t).select(
        JE.col("d").cast(JT.STRING).alias("v")).collect().column("v")
    spark = ["0.0", "-0.0", "1.5", "-0.0", None, "0.0"]
    assert got.to_pylist() == spark
    zeros = {ref[i].as_py() for i in (0, 1, 3, 5)}
    assert len(zeros) == 1            # the reference merges the two zeros


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_value_transforms_keep_signed_zeros(dtype):
    """Both dictionary transforms see -0.0 and 0.0 as two values (their
    callers: the cast to string, ``from_unixtime``, ``date_format``)."""
    import math

    import torch

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr.core import Col
    from spark_rapids_tpu_torch.ops import strings as OS
    tdt = getattr(torch, dtype)
    col = Col(torch.tensor([0.0, -0.0, 2.0, -0.0, 0.0, 0.0, 0.0, 0.0],
                           dtype=tdt),
              torch.tensor([True] * 5 + [False] * 3), T.DOUBLE)
    s = OS.value_transform_to_string(col, lambda v: repr(float(v)))
    words = [s.dictionary[int(c)].as_py() if ok else None
             for c, ok in zip(s.values.tolist(), s.validity.tolist())]
    assert words == ["0.0", "-0.0", "2.0", "-0.0", "0.0", None, None, None]
    v = OS.value_transform_to_values(col, lambda x: math.copysign(1.0, x),
                                     T.DOUBLE)
    assert v.values.tolist()[:5] == [1.0, -1.0, 1.0, -1.0, 1.0]
