"""Date and time expressions — counterpart of
``spark_rapids_tpu/expr/datetime.py`` (reference
datetimeExpressions.scala: GpuYear, GpuMonth, GpuDayOfMonth, GpuHour,
GpuDateAdd, GpuDateDiff, GpuUnixTimestamp, GpuFromUnixTime,
GpuDateFormatClass, GpuMonthsBetween, GpuTimeAdd, ...).

A date is int32 days since 1970-01-01, a timestamp int64 microseconds since
the epoch in UTC (the session time zone is UTC, as in the reference). The
calendar parts are integer arithmetic on the device over Howard Hinnant's
``civil_from_days``/``days_from_civil``, exact over the whole int32 day
range. A date part of a timestamp reads its day (floor), a time part of a
date is 0 (Spark casts the date to a timestamp at midnight). Formatting
and parsing with a pattern run once per distinct value (or dictionary
entry) on the host, over Java's ``SimpleDateFormat`` subset
(``java_fmt_to_strftime``).

``months_between`` follows Spark: the time of day counts in the fraction
(seconds over 31 days) and the eight-digit round is HALF_UP (Java's
``Math.round``); the reference drops the time of day and rounds half to
even.
"""

from __future__ import annotations

import datetime as _dt

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
from spark_rapids_tpu_torch.expr.core import Col, Expression, Literal, valid_and

_MICROS_PER_DAY = 86_400_000_000


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z):
    """days since the epoch → (year, month, day), int32 each."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                                    # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                              # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                      # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                  # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y, m, d):
    """(year, month, day) → days since the epoch, int32."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9).to(torch.int64)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def _month_len(y, m):
    one = torch.ones_like(m)
    start = days_from_civil(y, m, one)
    y2 = torch.where(m == 12, y + 1, y)
    m2 = torch.where(m == 12, one, m + 1)
    return days_from_civil(y2, m2, one) - start


def _temporal(e: Expression, what: str) -> T.DataType:
    t = e.dtype
    if not isinstance(t, (T.DateType, T.TimestampType)):
        raise NotImplementedError(f"{what} of a {t} is not ported yet")
    return t


def _days(dtype, c: Col):
    """The day of a date or timestamp value (floor for a timestamp)."""
    if isinstance(dtype, T.TimestampType):
        return _fdiv(c.values, _MICROS_PER_DAY).to(torch.int32)
    return c.values


def _micros(dtype, c: Col):
    """A date or timestamp as epoch microseconds."""
    if isinstance(dtype, T.DateType):
        return c.values.to(torch.int64) * _MICROS_PER_DAY
    return c.values


def _integral(e: Expression, what: str):
    if not isinstance(e.dtype, T.IntegralType):
        raise NotImplementedError(f"{what} by a {e.dtype} is not ported yet")


class _DatePart(Expression):
    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        _temporal(self.children[0], type(self).__name__.lower())
        return T.INT

    def with_children(self, children):
        return type(self)(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        days = _days(self.children[0].dtype, c)
        y, m, d = civil_from_days(days)
        return Col(self.pick(y, m, d, days).to(torch.int32), c.validity,
                   T.INT).canonicalized()

    def pick(self, y, m, d, days):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.children[0]!r})"


class Year(_DatePart):
    def pick(self, y, m, d, days):
        return y


class Month(_DatePart):
    def pick(self, y, m, d, days):
        return m


class DayOfMonth(_DatePart):
    def pick(self, y, m, d, days):
        return d


class DayOfWeek(_DatePart):
    """dayofweek: 1 = Sunday ... 7 = Saturday (1970-01-01 was a Thursday)."""

    def pick(self, y, m, d, days):
        return torch.remainder(days.to(torch.int64) + 4, 7) + 1


class WeekDay(_DatePart):
    """weekday: 0 = Monday ... 6 = Sunday."""

    def pick(self, y, m, d, days):
        return torch.remainder(days.to(torch.int64) + 3, 7)


class DayOfYear(_DatePart):
    def pick(self, y, m, d, days):
        one = torch.ones_like(m)
        return days - days_from_civil(y, one, one) + 1


class Quarter(_DatePart):
    def pick(self, y, m, d, days):
        return _fdiv(m - 1, 3) + 1


class LastDay(Expression):
    """last_day(date): the last day of its month."""

    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        _temporal(self.children[0], "last_day")
        return T.DATE

    def with_children(self, children):
        return LastDay(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        days = _days(self.children[0].dtype, c)
        y, m, d = civil_from_days(days)
        out = days + (_month_len(y, m) - d)
        return Col(out.to(torch.int32), c.validity, T.DATE).canonicalized()

    def __repr__(self):
        return f"last_day({self.children[0]!r})"


class _TimePart(Expression):
    def __init__(self, child):
        self.children = [child]

    @property
    def dtype(self):
        _temporal(self.children[0], type(self).__name__.lower())
        return T.INT

    def with_children(self, children):
        return type(self)(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        us = _micros(self.children[0].dtype, c)
        mid = us - _fdiv(us, _MICROS_PER_DAY) * _MICROS_PER_DAY
        return Col(self.pick(mid).to(torch.int32), c.validity,
                   T.INT).canonicalized()

    def pick(self, mid):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.children[0]!r})"


class Hour(_TimePart):
    def pick(self, mid):
        return _fdiv(mid, 3_600_000_000)


class Minute(_TimePart):
    def pick(self, mid):
        return _fdiv(mid, 60_000_000) % 60


class Second(_TimePart):
    def pick(self, mid):
        return _fdiv(mid, 1_000_000) % 60


class DateAdd(Expression):
    """date_add(d, n): a date n days on (a timestamp reads its day)."""

    def __init__(self, date, delta):
        self.children = [date, delta]

    @property
    def dtype(self):
        _temporal(self.children[0], type(self).__name__.lower())
        _integral(self.children[1], type(self).__name__.lower())
        return T.DATE

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        d = self.children[0].eval(ctx)
        n = _cast_col(self.children[1].eval(ctx), T.INT)
        days = _days(self.children[0].dtype, d)
        return Col(self.op(days, n.values), valid_and(d.validity, n.validity),
                   T.DATE).canonicalized()

    def op(self, days, n):
        return days + n

    def __repr__(self):
        return (f"{type(self).__name__.lower()}({self.children[0]!r}, "
                f"{self.children[1]!r})")


class DateSub(DateAdd):
    def op(self, days, n):
        return days - n


class DateAddInterval(DateAdd):
    """date + a whole number of days (reference GpuDateAddInterval; the SQL
    lowering emits it for day and week intervals)."""

    def __repr__(self):
        return (f"dateaddinterval({self.children[0]!r}, "
                f"{self.children[1]!r})")


class DateDiff(Expression):
    """datediff(end, start): days from start to end."""

    def __init__(self, end, start):
        self.children = [end, start]

    @property
    def dtype(self):
        for c in self.children:
            _temporal(c, "datediff")
        return T.INT

    def with_children(self, children):
        return DateDiff(children[0], children[1])

    def eval(self, ctx):
        e = self.children[0].eval(ctx)
        s = self.children[1].eval(ctx)
        ed = _days(self.children[0].dtype, e)
        sd = _days(self.children[1].dtype, s)
        return Col(ed - sd, valid_and(e.validity, s.validity),
                   T.INT).canonicalized()

    def __repr__(self):
        return f"datediff({self.children[0]!r}, {self.children[1]!r})"


class AddMonths(Expression):
    """add_months(date, n): calendar month add, the day clamped to the
    target month's last day (Spark: 2020-01-31 + 1 month = 2020-02-29)."""

    def __init__(self, date, months):
        self.children = [date, months]

    @property
    def dtype(self):
        _temporal(self.children[0], "add_months")
        _integral(self.children[1], "add_months")
        return T.DATE

    def with_children(self, children):
        return AddMonths(children[0], children[1])

    def eval(self, ctx):
        d = self.children[0].eval(ctx)
        n = _cast_col(self.children[1].eval(ctx), T.INT)
        y, m, dom = civil_from_days(_days(self.children[0].dtype, d))
        total = y.to(torch.int64) * 12 + (m - 1) + n.values
        ny = _fdiv(total, 12)
        nm = total - ny * 12 + 1
        nd = torch.minimum(dom.to(torch.int64), _month_len(ny, nm))
        out = days_from_civil(ny, nm, nd)
        return Col(out, valid_and(d.validity, n.validity),
                   T.DATE).canonicalized()

    def __repr__(self):
        return f"add_months({self.children[0]!r}, {self.children[1]!r})"


class MonthsBetween(Expression):
    """months_between(end, start[, roundOff]) (Spark's
    ``DateTimeUtils.monthsBetween``): whole months, plus, unless both days of
    month are equal or both are month ends, the difference in seconds over
    31 days; rounded to 8 digits HALF_UP when roundOff."""

    def __init__(self, end, start, round_off: bool = True):
        self.children = [end, start]
        self.round_off = round_off

    @property
    def dtype(self):
        for c in self.children:
            _temporal(c, "months_between")
        return T.DOUBLE

    def with_children(self, children):
        return MonthsBetween(children[0], children[1], self.round_off)

    def eval(self, ctx):
        e = self.children[0].eval(ctx)
        s = self.children[1].eval(ctx)
        eu = _micros(self.children[0].dtype, e)
        su = _micros(self.children[1].dtype, s)
        ed, sd = _fdiv(eu, _MICROS_PER_DAY), _fdiv(su, _MICROS_PER_DAY)
        ey, em, edom = civil_from_days(ed)
        sy, sm, sdom = civil_from_days(sd)
        months = ((ey - sy).to(torch.int64) * 12 + (em - sm)).to(
            torch.float64)
        same = (edom == sdom) | ((edom == _month_len(ey, em))
                                 & (sdom == _month_len(sy, sm)))
        esec = _fdiv(eu - ed * _MICROS_PER_DAY, 1_000_000)
        ssec = _fdiv(su - sd * _MICROS_PER_DAY, 1_000_000)
        secs = (edom - sdom).to(torch.int64) * 86_400 + esec - ssec
        out = months + secs.to(torch.float64) / (31 * 86_400.0)
        out = torch.where(same, months, out)
        if self.round_off:
            out = torch.floor(out * 1e8 + 0.5) / 1e8
        return Col(out, valid_and(e.validity, s.validity),
                   T.DOUBLE).canonicalized()

    def __repr__(self):
        return (f"months_between({self.children[0]!r}, "
                f"{self.children[1]!r})")


class TruncDate(Expression):
    """trunc(date, 'year'|'quarter'|'month'|'week'): the date at the start
    of that unit; any other format is null."""

    def __init__(self, date, fmt):
        self.children = [date, fmt]

    @property
    def dtype(self):
        _temporal(self.children[0], "trunc")
        _literal_str(self.children[1], "trunc")
        return T.DATE

    def with_children(self, children):
        return TruncDate(children[0], children[1])

    def eval(self, ctx):
        lvl = (self.children[1].value or "").lower()
        d = self.children[0].eval(ctx)
        days = _days(self.children[0].dtype, d)
        y, m, _ = civil_from_days(days)
        one = torch.ones_like(m)
        if lvl in ("year", "yyyy", "yy"):
            out = days_from_civil(y, one, one)
        elif lvl in ("month", "mon", "mm"):
            out = days_from_civil(y, m, one)
        elif lvl == "quarter":
            out = days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
        elif lvl == "week":     # Monday; day 0 was a Thursday
            out = days - torch.remainder(days.to(torch.int64) + 3, 7)
        else:
            z = torch.zeros_like(days)
            return Col(z, torch.zeros_like(d.validity), T.DATE)
        return Col(out.to(torch.int32), d.validity, T.DATE).canonicalized()

    def __repr__(self):
        return f"trunc({self.children[0]!r}, {self.children[1]!r})"


class TimeAdd(Expression):
    """timestamp + an interval of microseconds (reference GpuTimeAdd; an
    interval with months is refused, as there)."""

    def __init__(self, ts, interval_us):
        self.children = [ts, interval_us]

    @property
    def dtype(self):
        if not isinstance(self.children[0].dtype, T.TimestampType):
            raise NotImplementedError(
                f"time_add of a {self.children[0].dtype} is not ported yet")
        _integral(self.children[1], "time_add")
        return T.TIMESTAMP

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        t = self.children[0].eval(ctx)
        us = _cast_col(self.children[1].eval(ctx), T.LONG)
        return Col(t.values + us.values, valid_and(t.validity, us.validity),
                   T.TIMESTAMP).canonicalized()

    def __repr__(self):
        return f"timeadd({self.children[0]!r}, {self.children[1]!r})"


# -- formatting and parsing ---------------------------------------------------

_JAVA_FMT = [  # longest match first: SimpleDateFormat → strftime
    ("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"),
    ("mm", "%M"), ("ss", "%S"), ("EEEE", "%A"), ("EEE", "%a"), ("a", "%p"),
    ("DDD", "%j"), ("hh", "%I"),
]

DEFAULT_TS_FMT = "yyyy-MM-dd HH:mm:ss"


def java_fmt_to_strftime(fmt: str) -> str:
    """The common subset of Java's ``SimpleDateFormat`` patterns as a
    strftime format; a token outside it raises ``NotImplementedError`` (so
    planning refuses it)."""
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "'":            # Java's literal quoting
            j = fmt.index("'", i + 1) if "'" in fmt[i + 1:] else len(fmt)
            out.append(fmt[i + 1:j].replace("%", "%%"))
            i = j + 1
            continue
        for tok, rep in _JAVA_FMT:
            if fmt.startswith(tok, i):
                out.append(rep)
                i += len(tok)
                break
        else:
            ch = fmt[i]
            if ch.isalpha():
                raise NotImplementedError(
                    f"the datetime pattern letter {ch!r} is not ported yet")
            out.append("%%" if ch == "%" else ch)
            i += 1
    return "".join(out)


def _literal_str(e: Expression, what: str) -> str:
    if not (isinstance(e, Literal) and isinstance(e.value, str)):
        raise NotImplementedError(
            f"{what} with a non-literal format is not ported yet")
    return e.value


def _epoch_dt(micros: int):
    return _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=int(micros))


class _ToUnixSeconds(Expression):
    """unix_timestamp / to_unix_timestamp of a timestamp, a date, or a
    string parsed with a literal pattern (an unparsable string is null)."""

    def __init__(self, child, fmt=None):
        self.children = [child, fmt if fmt is not None
                         else Literal(DEFAULT_TS_FMT, T.STRING)]

    @property
    def dtype(self):
        src = self.children[0].dtype
        if not isinstance(src, (T.DateType, T.TimestampType, T.StringType)):
            raise NotImplementedError(
                f"unix_timestamp of a {src} is not ported yet")
        java_fmt_to_strftime(_literal_str(self.children[1],
                                          "unix_timestamp"))
        return T.LONG

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.ops.strings import dict_transform_to_values
        c = self.children[0].eval(ctx)
        src = self.children[0].dtype
        if not isinstance(src, T.StringType):
            return Col(_fdiv(_micros(src, c), 1_000_000), c.validity,
                       T.LONG).canonicalized()
        pyfmt = java_fmt_to_strftime(self.children[1].value)

        def parse(s):
            try:
                d = _dt.datetime.strptime(s, pyfmt)
            except (ValueError, TypeError):
                return None
            return (d - _dt.datetime(1970, 1, 1)) // _dt.timedelta(seconds=1)
        return dict_transform_to_values(c, parse, T.LONG)

    def __repr__(self):
        return (f"{type(self).__name__.lower()}({self.children[0]!r}, "
                f"{self.children[1]!r})")


class UnixTimestamp(_ToUnixSeconds):
    pass


class ToUnixTimestamp(_ToUnixSeconds):
    pass


class UnixTimestampSeconds(_ToUnixSeconds):
    """unix_timestamp(ts): the seconds of a timestamp (floor)."""

    def __init__(self, child):
        super().__init__(child)

    def with_children(self, children):
        return UnixTimestampSeconds(children[0])


class FromUnixTime(Expression):
    """from_unixtime(seconds, fmt): the UTC time formatted."""

    def __init__(self, child, fmt=None):
        self.children = [child, fmt if fmt is not None
                         else Literal(DEFAULT_TS_FMT, T.STRING)]

    @property
    def dtype(self):
        _integral(self.children[0], "from_unixtime")
        java_fmt_to_strftime(_literal_str(self.children[1], "from_unixtime"))
        return T.STRING

    def with_children(self, children):
        return FromUnixTime(children[0], children[1])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.ops.strings import value_transform_to_string
        pyfmt = java_fmt_to_strftime(self.children[1].value)
        c = _cast_col(self.children[0].eval(ctx), T.LONG)
        return value_transform_to_string(
            c, lambda sec: _epoch_dt(int(sec) * 1_000_000).strftime(pyfmt))

    def __repr__(self):
        return f"from_unixtime({self.children[0]!r}, {self.children[1]!r})"


class DateFormatClass(Expression):
    """date_format(ts or date, fmt) → string, once per distinct value."""

    def __init__(self, child, fmt):
        self.children = [child, fmt]

    @property
    def dtype(self):
        _temporal(self.children[0], "date_format")
        java_fmt_to_strftime(_literal_str(self.children[1], "date_format"))
        return T.STRING

    def with_children(self, children):
        return DateFormatClass(children[0], children[1])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.ops.strings import value_transform_to_string
        pyfmt = java_fmt_to_strftime(self.children[1].value)
        c = self.children[0].eval(ctx)
        if isinstance(self.children[0].dtype, T.DateType):
            def fmt(d):
                return (_dt.date(1970, 1, 1)
                        + _dt.timedelta(days=int(d))).strftime(pyfmt)
        else:
            def fmt(us):
                return _epoch_dt(us).strftime(pyfmt)
        return value_transform_to_string(c, fmt)

    def __repr__(self):
        return f"date_format({self.children[0]!r}, {self.children[1]!r})"
