"""``.dt`` / ``.str`` / ``.num`` expression namespaces.

Reference: python/pathway/internals/expressions/{date_time,string,numerical}.py.
Each method builds a MethodCallExpression whose function the engine maps over
row batches (numeric ones vectorise through numpy in the batch evaluator).
"""

from __future__ import annotations

import datetime
import math

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    MethodCallExpression,
    smart_coerce,
)


class _Namespace:
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def _method(self, name, fun, return_type, *extra):
        return MethodCallExpression(name, (self._expr, *extra), fun, return_type)


class StringNamespace(_Namespace):
    def lower(self):
        return self._method("lower", lambda s: s.lower(), dt.STR)

    def upper(self):
        return self._method("upper", lambda s: s.upper(), dt.STR)

    def reversed(self):
        return self._method("reversed", lambda s: s[::-1], dt.STR)

    def strip(self, chars=None):
        return self._method("strip", lambda s, c: s.strip(c), dt.STR, smart_coerce(chars))

    def rstrip(self, chars=None):
        return self._method("rstrip", lambda s, c: s.rstrip(c), dt.STR, smart_coerce(chars))

    def lstrip(self, chars=None):
        return self._method("lstrip", lambda s, c: s.lstrip(c), dt.STR, smart_coerce(chars))

    def len(self):
        return self._method("len", lambda s: len(s), dt.INT)

    def count(self, sub, start=None, end=None):
        return self._method(
            "count",
            lambda s, su, st, e: s.count(su, st, e),
            dt.INT,
            smart_coerce(sub),
            smart_coerce(start),
            smart_coerce(end),
        )

    def find(self, sub, start=None, end=None):
        return self._method(
            "find",
            lambda s, su, st, e: s.find(su, st, e),
            dt.INT,
            smart_coerce(sub),
            smart_coerce(start),
            smart_coerce(end),
        )

    def rfind(self, sub, start=None, end=None):
        return self._method(
            "rfind",
            lambda s, su, st, e: s.rfind(su, st, e),
            dt.INT,
            smart_coerce(sub),
            smart_coerce(start),
            smart_coerce(end),
        )

    def startswith(self, prefix):
        return self._method(
            "startswith", lambda s, p: s.startswith(p), dt.BOOL, smart_coerce(prefix)
        )

    def endswith(self, suffix):
        return self._method(
            "endswith", lambda s, p: s.endswith(p), dt.BOOL, smart_coerce(suffix)
        )

    def swapcase(self):
        return self._method("swapcase", lambda s: s.swapcase(), dt.STR)

    def title(self):
        return self._method("title", lambda s: s.title(), dt.STR)

    def replace(self, old, new, count=-1):
        return self._method(
            "replace",
            lambda s, o, n, c: s.replace(o, n, c),
            dt.STR,
            smart_coerce(old),
            smart_coerce(new),
            smart_coerce(count),
        )

    def split(self, sep=None, maxsplit=-1):
        return self._method(
            "split",
            lambda s, se, m: tuple(s.split(se, m)),
            dt.List(dt.STR),
            smart_coerce(sep),
            smart_coerce(maxsplit),
        )

    def slice(self, start, end):
        return self._method(
            "slice",
            lambda s, a, b: s[a:b],
            dt.STR,
            smart_coerce(start),
            smart_coerce(end),
        )

    def parse_int(self, optional=False):
        fun = (lambda s: _safe(int, s)) if optional else (lambda s: int(s))
        return self._method("parse_int", fun, dt.Optional(dt.INT) if optional else dt.INT)

    def parse_float(self, optional=False):
        fun = (lambda s: _safe(float, s)) if optional else (lambda s: float(s))
        return self._method(
            "parse_float", fun, dt.Optional(dt.FLOAT) if optional else dt.FLOAT
        )

    def parse_bool(self, true_values=("on", "true", "yes", "1"), false_values=("off", "false", "no", "0"), optional=False):
        def fun(s):
            low = s.lower()
            if low in true_values:
                return True
            if low in false_values:
                return False
            if optional:
                return None
            raise ValueError(f"cannot parse {s!r} as bool")

        return self._method(
            "parse_bool", fun, dt.Optional(dt.BOOL) if optional else dt.BOOL
        )


def _safe(fun, *args):
    try:
        return fun(*args)
    except (ValueError, TypeError):
        return None


class NumericalNamespace(_Namespace):
    def abs(self):
        return self._method("abs", abs, self._expr._dtype)

    def round(self, decimals=0):
        return self._method(
            "round", lambda x, d: round(x, d), self._expr._dtype, smart_coerce(decimals)
        )

    def fill_na(self, default_value):
        def fun(x, d):
            if x is None:
                return d
            if isinstance(x, float) and math.isnan(x):
                return d
            return x

        # propagate_none=False: this method's JOB is receiving the None
        # (reference: expressions/numerical.py fill_na replaces
        # None/NaN with the default)
        return MethodCallExpression(
            "fill_na",
            (self._expr, smart_coerce(default_value)),
            fun,
            dt.unoptionalize(self._expr._dtype),
            propagate_none=False,
        )


_EPOCH_NAIVE = datetime.datetime(1970, 1, 1)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _strptime(s, fmt):
    return datetime.datetime.strptime(s, fmt)


class DateTimeNamespace(_Namespace):
    def nanosecond(self):
        return self._method("nanosecond", lambda d: d.microsecond * 1000, dt.INT)

    def microsecond(self):
        return self._method("microsecond", lambda d: d.microsecond, dt.INT)

    def millisecond(self):
        return self._method("millisecond", lambda d: d.microsecond // 1000, dt.INT)

    def second(self):
        return self._method("second", lambda d: d.second, dt.INT)

    def minute(self):
        return self._method("minute", lambda d: d.minute, dt.INT)

    def hour(self):
        return self._method("hour", lambda d: d.hour, dt.INT)

    def day(self):
        return self._method("day", lambda d: d.day, dt.INT)

    def month(self):
        return self._method("month", lambda d: d.month, dt.INT)

    def year(self):
        return self._method("year", lambda d: d.year, dt.INT)

    def timestamp(self, unit=None):
        """Epoch offset (reference: expressions/date_time.py:384 —
        float for explicit units; exact int nanoseconds for unit=None,
        the deprecated legacy default). Computed from exact integer
        nanoseconds either way: total_seconds() alone loses precision
        beyond ~104 days."""
        if unit is not None and unit not in ("ns", "us", "ms", "s"):
            raise ValueError(
                f"unit has to be one of 's', 'ms', 'us', 'ns' but is {unit!r}"
            )
        div = {None: 1, "ns": 1, "us": 10**3, "ms": 10**6, "s": 10**9}[unit]

        def fun(d):
            epoch = _EPOCH_UTC if d.tzinfo is not None else _EPOCH_NAIVE
            td = d - epoch
            ns = (
                (td.days * 86400 + td.seconds) * 10**9
                + td.microseconds * 10**3
            )
            if unit is None:
                return ns
            return ns / div

        return self._method(
            "timestamp", fun, dt.INT if unit is None else dt.FLOAT
        )

    def strftime(self, fmt):
        return self._method(
            "strftime", lambda d, f: d.strftime(f), dt.STR, smart_coerce(fmt)
        )

    def strptime(self, fmt, contains_timezone=False):
        return self._method(
            "strptime",
            lambda s, f: _strptime(s, f),
            dt.DATE_TIME_UTC if contains_timezone else dt.DATE_TIME_NAIVE,
            smart_coerce(fmt),
        )

    def to_utc(self, from_timezone):
        import zoneinfo

        def fun(d, tz):
            return d.replace(tzinfo=zoneinfo.ZoneInfo(tz)).astimezone(
                datetime.timezone.utc
            )

        return self._method("to_utc", fun, dt.DATE_TIME_UTC, smart_coerce(from_timezone))

    def to_naive_in_timezone(self, timezone):
        import zoneinfo

        def fun(d, tz):
            return d.astimezone(zoneinfo.ZoneInfo(tz)).replace(tzinfo=None)

        return self._method(
            "to_naive_in_timezone", fun, dt.DATE_TIME_NAIVE, smart_coerce(timezone)
        )

    def round(self, duration):
        def fun(d, dur):
            epoch = _EPOCH_UTC if d.tzinfo is not None else _EPOCH_NAIVE
            total = (d - epoch).total_seconds()
            step = dur.total_seconds()
            return epoch + datetime.timedelta(seconds=round(total / step) * step)

        return self._method("round", fun, self._expr._dtype, smart_coerce(duration))

    def floor(self, duration):
        def fun(d, dur):
            epoch = _EPOCH_UTC if d.tzinfo is not None else _EPOCH_NAIVE
            total = (d - epoch).total_seconds()
            step = dur.total_seconds()
            return epoch + datetime.timedelta(seconds=math.floor(total / step) * step)

        return self._method("floor", fun, self._expr._dtype, smart_coerce(duration))

    def nanoseconds(self):
        return self._method(
            "nanoseconds", lambda td: int(td.total_seconds() * 1e9), dt.INT
        )

    def microseconds(self):
        return self._method(
            "microseconds", lambda td: int(td.total_seconds() * 1e6), dt.INT
        )

    def milliseconds(self):
        return self._method(
            "milliseconds", lambda td: int(td.total_seconds() * 1e3), dt.INT
        )

    def seconds(self):
        return self._method("seconds", lambda td: int(td.total_seconds()), dt.INT)

    def minutes(self):
        return self._method("minutes", lambda td: int(td.total_seconds() // 60), dt.INT)

    def hours(self):
        return self._method("hours", lambda td: int(td.total_seconds() // 3600), dt.INT)

    def days(self):
        return self._method("days", lambda td: td.days, dt.INT)

    def weeks(self):
        return self._method("weeks", lambda td: td.days // 7, dt.INT)

    def from_timestamp(self, unit="s"):
        mult = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}[unit]

        def fun(x):
            return _EPOCH_NAIVE + datetime.timedelta(seconds=x * mult)

        return self._method("from_timestamp", fun, dt.DATE_TIME_NAIVE)

    def utc_from_timestamp(self, unit="s"):
        mult = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}[unit]

        def fun(x):
            return _EPOCH_UTC + datetime.timedelta(seconds=x * mult)

        return self._method("utc_from_timestamp", fun, dt.DATE_TIME_UTC)

    def weekday(self):
        return self._method("weekday", lambda d: d.weekday(), dt.INT)
