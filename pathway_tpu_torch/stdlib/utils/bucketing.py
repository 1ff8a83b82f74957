"""Time-bucketing helpers (reference surface:
python/pathway/stdlib/utils/bucketing.py)."""

from __future__ import annotations

from datetime import datetime


def truncate_to_minutes(time: datetime) -> datetime:
    """Floor a timestamp to its minute (drops seconds and fractions)."""
    return time.replace(second=0, microsecond=0)
