"""The 50th percentile, over every request due in the window, of the time
from its due time to its answer; a blocked request counts, a failed one
counts as infinite."""

from vsrbench.stats import percentile


def read(run):
    lat = [r.latency_s for r in run.in_window()]
    return percentile(lat, 50) * 1e3 if lat else None
