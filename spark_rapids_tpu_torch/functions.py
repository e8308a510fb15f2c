"""Column-function builders — the pyspark.sql.functions facade.

Counterpart of ``spark_rapids_tpu/functions.py``, with its names and
signatures: the aggregates (``sum`` ... ``var_pop``), the conditionals, the
string, math and date functions, ``hash`` and ``isin``, the window builders
(``row_number``, ``rank``, ``dense_rank``, ``lead``, ``lag`` and ``over``),
``alias``, ``scalar_subquery``, the context functions
(``spark_partition_id``, ``monotonically_increasing_id``,
``input_file_name``, ``input_file_block_start``/``_length``), and the
array, struct and map functions (``struct``, ``get_field``, ``array``,
``element_at0``, ``size``, ``element_at``, ``array_contains``, ``split``,
``collect_list``, ``collect_set``, ``create_map``, ``map_value``). Beyond the
reference it has pyspark's ``quarter``, ``hour``, ``minute``, ``second``,
``dayofweek``, ``dayofyear``, ``last_day``, ``datediff``, ``date_add``,
``nullif``, ``ltrim``/``rtrim``, ``reverse``, ``initcap``, ``rlike`` and the
unary math functions, over expressions the reference has. Not ported:
``rand`` and the UDF factories.

    w = F.over(F.row_number(), partition_by=["k"],
               order_by=[("ts", False, False)])
    df.window([F.alias(w, "rn")])
"""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import aggregates as _AG
from spark_rapids_tpu_torch.expr import arithmetic as _A
from spark_rapids_tpu_torch.expr import conditional as _C
from spark_rapids_tpu_torch.expr import datetime as _DT
from spark_rapids_tpu_torch.expr import mathexprs as _M
from spark_rapids_tpu_torch.expr import nullexprs as _N
from spark_rapids_tpu_torch.expr import misc as _MI
from spark_rapids_tpu_torch.expr import strings as _S
from spark_rapids_tpu_torch.expr import windows as _W
from spark_rapids_tpu_torch.expr.cast import Cast
from spark_rapids_tpu_torch.expr.core import Alias, Expression, Literal
from spark_rapids_tpu_torch.expr.core import col, lit  # noqa: F401


def _e(c):
    from spark_rapids_tpu_torch.session import _to_expr
    return _to_expr(c)


def sum(c):  # noqa: A001
    return _AG.Sum(_e(c))


def count(c=None):
    return _AG.Count(None if c is None else _e(c))


def min(c):  # noqa: A001
    return _AG.Min(_e(c))


def max(c):  # noqa: A001
    return _AG.Max(_e(c))


def avg(c):
    return _AG.Average(_e(c))


def first(c, ignore_nulls: bool = False):
    return _AG.First(_e(c), ignore_nulls)


def last(c, ignore_nulls: bool = False):
    return _AG.Last(_e(c), ignore_nulls)


def abs(c):  # noqa: A001
    return _A.Abs(_e(c))


# a value position takes a non-expression as a literal (the pyspark
# convention: only the first argument reads a string as a column name)
def when(cond, value):
    return _C.CaseWhen([(_e(cond), _C.as_value(value))])


def if_(cond, a, b):
    return _C.If(_e(cond), _C.as_value(a), _C.as_value(b))


def cast(c, to: T.DataType):
    return Cast(_e(c), to)


def _v(value):
    """A value position: a non-expression is a literal (pyspark's
    convention: only a first argument reads a string as a column name)."""
    return value if isinstance(value, Expression) else Literal(value)


def coalesce(*cs):
    return _N.Coalesce(*[_e(c) for c in cs])


def isnull(c):
    return _N.IsNull(_e(c))


def isnan(c):
    return _N.IsNaN(_e(c))


def nullif(a, b):
    """nullif(a, b): null where a = b, else a."""
    from spark_rapids_tpu_torch.expr.predicates import EqualTo
    x = _e(a)
    return _C.If(EqualTo(x, _v(b)), Literal(None, None), x)


def least(*cs):
    return _C.Least(*[_e(c) for c in cs])


def greatest(*cs):
    return _C.Greatest(*[_e(c) for c in cs])


def isin(c, values):
    from spark_rapids_tpu_torch.expr.predicates import InSet
    return InSet(_e(c), list(values))


# -- aggregates ----------------------------------------------------------------

def stddev(c):
    return _AG.StddevSamp(_e(c))


stddev_samp = stddev


def stddev_pop(c):
    return _AG.StddevPop(_e(c))


def variance(c):
    return _AG.VarianceSamp(_e(c))


var_samp = variance


def var_pop(c):
    return _AG.VariancePop(_e(c))


# -- strings -------------------------------------------------------------------

def upper(c):
    return _S.Upper(_e(c))


def lower(c):
    return _S.Lower(_e(c))


def length(c):
    return _S.Length(_e(c))


def trim(c):
    return _S.Trim(_e(c))


def ltrim(c):
    return _S.LTrim(_e(c))


def rtrim(c):
    return _S.RTrim(_e(c))


def reverse(c):
    return _S.Reverse(_e(c))


def initcap(c):
    return _S.InitCap(_e(c))


def substring(c, pos, length_):
    return _S.Substring(_e(c), _v(pos), _v(length_))


def concat(*cs):
    return _S.Concat(*[_e(c) for c in cs])


def like(c, pattern: str):
    return _S.Like(_e(c), lit(pattern))


def rlike(c, pattern: str):
    return _S.RLike(_e(c), lit(pattern))


def concat_ws(sep: str, *cs):
    return _S.ConcatWs(_v(sep), *[_e(c) for c in cs])


def lpad(c, ln: int, pad: str = " "):
    return _S.StringLPad(_e(c), _v(ln), _v(pad))


def rpad(c, ln: int, pad: str = " "):
    return _S.StringRPad(_e(c), _v(ln), _v(pad))


def repeat(c, n: int):
    return _S.StringRepeat(_e(c), _v(n))


def locate(substr: str, c, pos: int = 1):
    return _S.StringLocate(_v(substr), _e(c), _v(pos))


def instr(c, substr: str):
    return _S.StringLocate(_v(substr), _e(c), _v(1))


def substring_index(c, delim: str, count: int):
    return _S.SubstringIndex(_e(c), _v(delim), _v(count))


def translate(c, frm: str, to: str):
    return _S.StringTranslate(_e(c), _v(frm), _v(to))


def find_in_set(c, str_list: str):
    return _S.FindInSet(_e(c), _v(str_list))


def regexp_replace(c, pattern: str, replacement: str):
    return _S.RegExpReplace(_e(c), _v(pattern), _v(replacement))


def regexp_extract(c, pattern: str, idx: int = 1):
    return _S.RegExpExtract(_e(c), _v(pattern), _v(idx))


def md5(c):
    return _S.Md5(_e(c))


def get_json_object(c, path: str):
    return _S.GetJsonObject(_e(c), lit(path))


# -- math ----------------------------------------------------------------------

def sqrt(c):
    return _M.Sqrt(_e(c))


def pow(a, b):  # noqa: A001
    return _M.Pow(_e(a), _v(b))


def round(c, scale: int = 0):  # noqa: A001
    return _M.Round(_e(c), scale)


def bround(c, scale: int = 0):
    return _M.BRound(_e(c), scale)


def floor(c):
    return _M.Floor(_e(c))


def ceil(c):
    return _M.Ceil(_e(c))


def log(base, c=None):
    """log(x), the natural logarithm, or log(base, x) (pyspark's order)."""
    if c is None:
        return _M.Log(_e(base))
    return _M.Logarithm(_v(base), _e(c))


def log10(c):
    return _M.Log10(_e(c))


def log2(c):
    return _M.Log2(_e(c))


def log1p(c):
    return _M.Log1p(_e(c))


def atan2(a, b):
    return _M.Atan2(_e(a), _v(b))


def pmod(a, b):
    return _A.Pmod(_e(a), _v(b))


def bitwise_not(c):
    return _A.BitwiseNot(_e(c))


def shiftleft(c, n):
    return _A.ShiftLeft(_e(c), _v(n))


def shiftright(c, n):
    return _A.ShiftRight(_e(c), _v(n))


def shiftrightunsigned(c, n):
    return _A.ShiftRightUnsigned(_e(c), _v(n))


def _unary_math(name):
    cls = getattr(_M, name)
    return lambda c: cls(_e(c))


exp = _unary_math("Exp")
expm1 = _unary_math("Expm1")
sin = _unary_math("Sin")
cos = _unary_math("Cos")
tan = _unary_math("Tan")
asin = _unary_math("Asin")
acos = _unary_math("Acos")
atan = _unary_math("Atan")
sinh = _unary_math("Sinh")
cosh = _unary_math("Cosh")
tanh = _unary_math("Tanh")
asinh = _unary_math("Asinh")
acosh = _unary_math("Acosh")
atanh = _unary_math("Atanh")
cbrt = _unary_math("Cbrt")
signum = _unary_math("Signum")
degrees = _unary_math("ToDegrees")
radians = _unary_math("ToRadians")
rint = _unary_math("Rint")
cot = _unary_math("Cot")


# -- dates and times -----------------------------------------------------------

def _date_part(name):
    cls = getattr(_DT, name)
    return lambda c: cls(_e(c))


year = _date_part("Year")
quarter = _date_part("Quarter")
month = _date_part("Month")
dayofmonth = _date_part("DayOfMonth")
dayofweek = _date_part("DayOfWeek")
weekday = _date_part("WeekDay")
dayofyear = _date_part("DayOfYear")
hour = _date_part("Hour")
minute = _date_part("Minute")
second = _date_part("Second")
last_day = _date_part("LastDay")


def date_add(c, days):
    return _DT.DateAdd(_e(c), _v(days))


def date_sub(c, days):
    return _DT.DateSub(_e(c), _v(days))


def datediff(end, start):
    return _DT.DateDiff(_e(end), _e(start))


def add_months(c, n):
    return _DT.AddMonths(_e(c), _v(n))


def months_between(end, start, round_off: bool = True):
    return _DT.MonthsBetween(_e(end), _e(start), round_off)


def trunc(c, fmt: str):
    return _DT.TruncDate(_e(c), _v(fmt))


def unix_timestamp(c, fmt: str | None = None):
    return _DT.UnixTimestamp(_e(c), _v(fmt) if fmt is not None else None)


def to_unix_timestamp(c, fmt: str | None = None):
    return _DT.ToUnixTimestamp(_e(c), _v(fmt) if fmt is not None else None)


def from_unixtime(c, fmt: str | None = None):
    return _DT.FromUnixTime(_e(c), _v(fmt) if fmt is not None else None)


def date_format(c, fmt: str):
    return _DT.DateFormatClass(_e(c), _v(fmt))


def time_add(ts, interval_us):
    return _DT.TimeAdd(_e(ts), _v(interval_us))


def date_add_interval(d, days):
    return _DT.DateAddInterval(_e(d), _v(days))


# -- hashing -------------------------------------------------------------------

def hash(*cs):  # noqa: A001
    return _MI.Murmur3Hash(*[_e(c) for c in cs])


def rand(seed: int = 0):
    """Uniform doubles in [0, 1), the reference's stream for ``seed``."""
    return _MI.Rand(seed)


# -- windows ------------------------------------------------------------------

def row_number():
    return _W.RowNumber()


def rank():
    return _W.Rank()


def dense_rank():
    return _W.DenseRank()


def lead(c, offset: int = 1, default=None):
    return _W.Lead(_e(c), offset, default)


def lag(c, offset: int = 1, default=None):
    return _W.Lag(_e(c), offset, default)


def over(func, partition_by=(), order_by=(), frame=None):
    """``func OVER (PARTITION BY ... ORDER BY ... frame)``. An ``order_by``
    item is an expression (ascending, nulls first) or an ``(expr,
    ascending, nulls_first)`` tuple. Without a frame: Spark's RANGE
    UNBOUNDED PRECEDING to CURRENT ROW with an ORDER BY, the whole
    partition without one."""
    orders = []
    for o in order_by:
        if isinstance(o, tuple):
            e, asc, nf = o
            orders.append((_e(e), bool(asc), bool(nf)))
        else:
            orders.append((_e(o), True, True))
    if frame is None:
        frame = _W.DEFAULT_FRAME if orders else _W.FULL_FRAME
    spec = _W.WindowSpec(tuple(_e(p) for p in partition_by), tuple(orders),
                         frame)
    return _W.WindowExpression(func, spec)


def alias(e, name: str):
    return Alias(_e(e), name)


def scalar_subquery(df):
    """The one value of a one-column DataFrame, as an expression: its plan
    runs once, here, on its session's device. No row gives NULL; more than
    one raises, as in Spark."""
    return _MI.ScalarSubquery.from_dataframe(df)


# -- the task's context ---------------------------------------------------------

def spark_partition_id():
    return _MI.SparkPartitionID()


def monotonically_increasing_id():
    return _MI.MonotonicallyIncreasingID()


def input_file_name():
    return _MI.InputFileName()


def input_file_block_start():
    return _MI.InputFileBlockStart()


def input_file_block_length():
    return _MI.InputFileBlockLength()


# -- arrays, structs and maps ---------------------------------------------------

def struct(*name_value_pairs):
    """named_struct('a', col, 'b', col): alternating names and values."""
    from spark_rapids_tpu_torch.expr.complexexprs import CreateNamedStruct
    return CreateNamedStruct(*[
        _v(x) if i % 2 == 0 else _e(x)
        for i, x in enumerate(name_value_pairs)])


def get_field(struct_expr, name: str):
    from spark_rapids_tpu_torch.expr.complexexprs import GetStructField
    return GetStructField(_e(struct_expr), name)


def array(*cs):
    from spark_rapids_tpu_torch.expr.complexexprs import CreateArray
    return CreateArray(*[_e(c) for c in cs])


def element_at0(arr, idx):
    """0-based array element (Spark's GetArrayItem; element_at is
    1-based)."""
    from spark_rapids_tpu_torch.expr.complexexprs import GetArrayItem
    return GetArrayItem(_e(arr), _v(idx))


def size(c):
    from spark_rapids_tpu_torch.expr.complexexprs import Size
    return Size(_e(c))


def element_at(arr, i):
    from spark_rapids_tpu_torch.expr.complexexprs import ElementAt
    return ElementAt(_e(arr), _v(i))


def array_contains(arr, value):
    from spark_rapids_tpu_torch.expr.complexexprs import ArrayContains
    return ArrayContains(_e(arr), _v(value))


def split(c, pattern: str, limit: int = -1):
    return _S.StringSplit(_e(c), Literal(pattern),
                          Literal(limit) if limit != -1 else None)


def collect_list(c):
    return _AG.CollectList(_e(c))


def collect_set(c):
    return _AG.CollectSet(_e(c))


def create_map(*kvs):
    from spark_rapids_tpu_torch.expr.complexexprs import CreateMap
    return CreateMap(*[_e(x) for x in kvs])


def map_value(m, key):
    from spark_rapids_tpu_torch.expr.complexexprs import GetMapValue
    return GetMapValue(_e(m), _e(key))
