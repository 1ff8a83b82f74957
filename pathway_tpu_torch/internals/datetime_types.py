"""User-facing datetime types (reference:
python/pathway/internals/datetime_types.py — DateTimeNaive/DateTimeUtc/
Duration extend the pandas timestamp family, usable BOTH as schema
annotations and as constructors: ``pw.Duration(days=1)``)."""

from __future__ import annotations

import pandas as pd


class DateTimeNaive(pd.Timestamp):
    """Datetime without timezone information (extends pandas.Timestamp)."""


class DateTimeUtc(pd.Timestamp):
    """Datetime with a timezone (extends pandas.Timestamp)."""


class Duration(pd.Timedelta):
    """A span of time (extends pandas.Timedelta)."""
