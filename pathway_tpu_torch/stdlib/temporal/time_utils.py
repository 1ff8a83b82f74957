"""Time utilities (reference:
python/pathway/stdlib/temporal/time_utils.py:125 — inactivity_detection,
utc_now)."""

from __future__ import annotations

import datetime
import time
from typing import Any


def utc_now(refresh_rate: datetime.timedelta | None = None):
    """A stream of the current UTC time, refreshed every `refresh_rate`
    (reference: time_utils.py utc_now)."""
    import pathway_tpu_torch as pw

    refresh_s = (
        refresh_rate.total_seconds() if refresh_rate is not None else 1.0
    )

    class _NowSubject(pw.io.python.ConnectorSubject):
        def run(self):
            while True:
                self.next(
                    timestamp_utc=datetime.datetime.now(datetime.timezone.utc)
                )
                self.commit()
                time.sleep(refresh_s)

    class _S(pw.Schema):
        timestamp_utc: Any

    return pw.io.python.read(
        _NowSubject(), schema=_S, autocommit_duration_ms=None
    )


def inactivity_detection(
    event_time_column,
    allowed_inactivity_period,
    refresh_rate: datetime.timedelta | None = None,
    instance=None,
):
    """Detect periods with no events: returns (inactivities, resumed) —
    rows appear in `inactivities` when no event arrived for
    `allowed_inactivity_period`, and in `resumed` when activity returns
    (reference: time_utils.py:125)."""
    import pathway_tpu_torch as pw

    events = event_time_column.table
    latest = events.reduce(latest_t=pw.reducers.max(event_time_column))
    now = utc_now(refresh_rate=refresh_rate)
    now_latest = now.reduce(now_t=pw.reducers.max(now.timestamp_utc))

    joined = latest.join(now_latest, id=latest.id).select(
        latest_t=latest.latest_t, now_t=now_latest.now_t
    )
    inactivities = joined.filter(
        joined.now_t - joined.latest_t > allowed_inactivity_period
    ).select(inactive_since=joined.latest_t)
    resumed = joined.filter(
        joined.now_t - joined.latest_t <= allowed_inactivity_period
    ).select(resumed_at=joined.latest_t)
    return inactivities, resumed
