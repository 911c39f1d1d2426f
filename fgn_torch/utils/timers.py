"""Wall-clock helpers (reference: cp_utils/cp_time.py:16-56)."""

from __future__ import annotations

from datetime import datetime


def datetime_now() -> datetime:
    return datetime.now()


def time_log_fancy(dt: datetime | None = None) -> str:
    """Filename-safe time string HH-MM-SS.ffffff."""
    dt = dt or datetime.now()
    return dt.strftime("%H-%M-%S.%f")


def datetime_log_fancy(dt: datetime | None = None) -> str:
    """Filename-safe datetime string YYYY-MM-DD@HH-MM-SS."""
    dt = dt or datetime.now()
    return dt.strftime("%Y-%m-%d@%H-%M-%S")


def datetime_diff(start: datetime, end: datetime | None = None) -> str:
    end = end or datetime.now()
    return str(end - start)


def datetime_diff_ms(start: datetime, end: datetime | None = None) -> float:
    end = end or datetime.now()
    return (end - start).total_seconds() * 1000.0
