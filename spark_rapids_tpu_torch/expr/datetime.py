"""Date arithmetic — the part of ``spark_rapids_tpu/expr/datetime.py`` that
the SQL lowering emits for ``date ± INTERVAL`` (``sql/lower._date_interval``):
``DateAddInterval`` (day and week intervals, ``:554``) and ``AddMonths``
(month and year intervals, ``:406``, with Spark's end-of-month clamp), over
the civil-calendar helpers ``civil_from_days`` and ``days_from_civil``
(Howard Hinnant's algorithms, exact over the whole int32 day range).

A date is int32 days since 1970-01-01. Both expressions are null where an
operand is null. The other date functions are not ported yet.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.arithmetic import _cast_col
from spark_rapids_tpu_torch.expr.core import Col, Expression, valid_and


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


def _date_result(children) -> T.DataType:
    """DATE; raises on operand types the port cannot add (timestamps are
    not ported), so planning refuses them."""
    date, n = children
    if not isinstance(date.dtype, T.DateType) or not isinstance(
            n.dtype, T.IntegralType):
        raise NotImplementedError(
            f"date arithmetic on {date.dtype} and {n.dtype} is not ported yet")
    return T.DATE


class AddMonths(Expression):
    """add_months(date, n): calendar month add, the day clamped to the
    target month's last day (Spark: 2020-01-31 + 1 month = 2020-02-29)."""

    def __init__(self, date, months):
        self.children = [date, months]

    @property
    def dtype(self):
        return _date_result(self.children)

    def with_children(self, children):
        return AddMonths(children[0], children[1])

    def eval(self, ctx):
        d = self.children[0].eval(ctx)
        n = _cast_col(self.children[1].eval(ctx), T.INT)
        y, m, dom = civil_from_days(d.values)
        total = y.to(torch.int64) * 12 + (m - 1) + n.values
        ny = _fdiv(total, 12)
        nm = total - ny * 12 + 1
        one = torch.ones_like(nm)
        month_start = days_from_civil(ny, nm, one)
        ny2 = torch.where(nm == 12, ny + 1, ny)
        nm2 = torch.where(nm == 12, one, nm + 1)
        month_len = days_from_civil(ny2, nm2, one) - month_start
        nd = torch.minimum(dom, month_len)
        out = days_from_civil(ny, nm, nd)
        return Col(out, valid_and(d.validity, n.validity),
                   T.DATE).canonicalized()

    def __repr__(self):
        return f"add_months({self.children[0]!r}, {self.children[1]!r})"


class DateAddInterval(Expression):
    """date + a whole number of days (reference GpuDateAddInterval)."""

    def __init__(self, date, days):
        self.children = [date, days]

    @property
    def dtype(self):
        return _date_result(self.children)

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        d = self.children[0].eval(ctx)
        n = _cast_col(self.children[1].eval(ctx), T.INT)
        return Col(d.values + n.values, valid_and(d.validity, n.validity),
                   T.DATE).canonicalized()

    def __repr__(self):
        return (f"dateaddinterval({self.children[0]!r}, "
                f"{self.children[1]!r})")
