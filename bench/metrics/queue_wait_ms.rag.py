"""The mean, over the window's answered requests, of the client's latency
(from the due time) less the request's own pipeline span (the root
``request`` span of its outcome trace): the time it waited for a batch
and for the batch's other requests.
In a traced run, the requests answered before the profiler's stop."""

from vsrbench.readers import window_requests
from vsrbench.stats import mean


def _span_ms(rec):
    return next((s["ms"] for s in rec.trace if s["span"] == "request"), None)


def read(run):
    return mean(rec.latency_s * 1e3 - _span_ms(rec)
                        for rec in window_requests(run)
                        if rec.answered and _span_ms(rec) is not None)
