"""Time-quantum views: per-unit view naming and minimal range covers.

Frames with a time quantum write each bit into one generated view per
quantum unit (``<view>_2006``, ``<view>_200601``, ...), and ``Range``
queries union the minimal set of coarse+fine views covering
``[start, end)`` — walking up from small units to aligned boundaries,
then down (reference: time.go:28-167).
"""

from __future__ import annotations

from datetime import datetime, timedelta

VALID_QUANTUMS = frozenset(
    ["Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""]
)

_UNIT_FORMATS = {
    "Y": "%Y",
    "M": "%Y%m",
    "D": "%Y%m%d",
    "H": "%Y%m%d%H",
}


class InvalidTimeQuantumError(ValueError):
    pass


def parse_time_quantum(v: str) -> str:
    q = v.upper()
    if q not in VALID_QUANTUMS:
        raise InvalidTimeQuantumError(f"invalid time quantum: {v!r}")
    return q


def view_by_time_unit(name: str, t: datetime, unit: str) -> str:
    """reference: time.go:66-79"""
    fmt = _UNIT_FORMATS.get(unit)
    if fmt is None:
        return ""
    return f"{name}_{t.strftime(fmt)}"


def views_by_time(name: str, t: datetime, quantum: str) -> list[str]:
    """One view per quantum unit, for writes (reference: time.go:82-92)."""
    return [
        view_by_time_unit(name, t, unit)
        for unit in quantum
        if unit in _UNIT_FORMATS
    ]


def _go_add_date(t: datetime, years: int, months: int, days: int) -> datetime:
    """Date arithmetic with Go's time.AddDate normalization (overflowing
    days roll forward: Jan 31 + 1 month = Mar 2/3)."""
    y = t.year + years
    m = t.month + months
    y += (m - 1) // 12
    m = (m - 1) % 12 + 1
    base = datetime(y, m, 1, t.hour, t.minute, t.second, t.microsecond)
    return base + timedelta(days=t.day - 1 + days)


def _add_unit(t: datetime, unit: str) -> datetime:
    if unit == "Y":
        return _go_add_date(t, 1, 0, 0)
    if unit == "M":
        return _go_add_date(t, 0, 1, 0)
    if unit == "D":
        return t + timedelta(days=1)
    return t + timedelta(hours=1)


def _next_unit_gte(t: datetime, end: datetime, unit: str) -> bool:
    """True when ``end`` reaches the unit period after ``t`` (reference:
    time.go:168-194 nextYearGTE/nextMonthGTE/nextDayGTE): t+1unit lands in
    the same unit as end, or end is strictly after t+1unit."""
    nxt = _add_unit(t, unit)
    if unit == "Y":
        same = nxt.year == end.year
    elif unit == "M":
        same = (nxt.year, nxt.month) == (end.year, end.month)
    else:  # D
        same = (nxt.year, nxt.month, nxt.day) == (end.year, end.month, end.day)
    return same or end > nxt


_SUFFIX_UNITS = {4: "Y", 6: "M", 8: "D", 10: "H"}


def parse_time_view(name: str) -> tuple[str, datetime, str] | None:
    """Inverse of :func:`view_by_time_unit`: ``<base>_<stamp>`` ->
    ``(base, period_start, unit)``, or None when ``name`` is not a
    generated time view.  The tier retention sweep uses this to decide
    which sub-views have aged past their quantum."""
    base, sep, stamp = name.rpartition("_")
    if not sep or not base or not stamp.isdigit():
        return None
    unit = _SUFFIX_UNITS.get(len(stamp))
    if unit is None:
        return None
    try:
        t = datetime.strptime(stamp, _UNIT_FORMATS[unit])
    except ValueError:
        return None
    return base, t, unit


def view_period_end(t: datetime, unit: str) -> datetime:
    """First instant AFTER the view's quantum period — the moment its
    retention clock starts."""
    return _add_unit(t, unit)


def views_by_time_range(name: str, start: datetime, end: datetime, quantum: str) -> list[str]:
    """Minimal view cover of [start, end) (reference: time.go:95-167)."""
    has = {u: (u in quantum) for u in "YMDH"}
    t = start
    results: list[str] = []

    # Walk up small -> large until aligned on a larger-unit boundary.
    if has["H"] or has["D"] or has["M"]:
        while t < end:
            if has["H"]:
                if not _next_unit_gte(t, end, "D"):
                    break
                if t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t = _add_unit(t, "H")
                    continue
            if has["D"]:
                if not _next_unit_gte(t, end, "M"):
                    break
                if t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t = _add_unit(t, "D")
                    continue
            if has["M"]:
                if not _next_unit_gte(t, end, "Y"):
                    break
                if t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_unit(t, "M")
                    continue
            break

    # Walk down large -> small to cover the rest.
    while t < end:
        if has["Y"] and _next_unit_gte(t, end, "Y"):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_unit(t, "Y")
        elif has["M"] and _next_unit_gte(t, end, "M"):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_unit(t, "M")
        elif has["D"] and _next_unit_gte(t, end, "D"):
            results.append(view_by_time_unit(name, t, "D"))
            t = _add_unit(t, "D")
        elif has["H"]:
            results.append(view_by_time_unit(name, t, "H"))
            t = _add_unit(t, "H")
        else:
            break

    return results
