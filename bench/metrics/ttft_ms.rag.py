"""Time to first token in the member's lane (submit to the lane until its
first token, ``vsr_ttft_ms``), the mean over the window's served
requests (in a traced run, those answered before the profiler's stop)."""

from vsrbench.readers import served, window_requests
from vsrbench.stats import mean


def read(run):
    return mean(r.usage["vsr_ttft_ms"]
                        for r in served(window_requests(run)))
