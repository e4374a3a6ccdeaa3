"""Requests per frontend batch (one ``route_batch`` call) over the
window's batches."""

from vsrbench.readers import window_or_all
from vsrbench.stats import mean


def read(run):
    return mean(len(b.indices) for b in window_or_all(run))
