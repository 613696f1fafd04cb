"""Statistics the metric readers share."""
from __future__ import annotations


def done(rec):
    """The requests of a run that answered."""
    return [r for r in rec["requests"] if r["end"] is not None]
