"""Timestamp formatting (reference ``utils/util.py:297-302``)."""


def timestamp2str(ts) -> str:
    """Render a CSV timestamp to the submap filename stem.

    Oxford/benchmark CSVs store integer microsecond timestamps; files
    are named by the plain integer string.
    """
    if isinstance(ts, float) and ts.is_integer():
        ts = int(ts)
    return str(ts)
