"""Time per output token of the member's lane: over the window's served
requests, the sum of (service - time to first token) over the sum of
(generated tokens - 1), from each answer's ``vsr_service_ms`` and
``vsr_ttft_ms``.
In a traced run, the requests answered before the profiler's stop."""

from vsrbench.readers import served, window_requests


def read(run):
    recs = served(window_requests(run))
    num = sum(r.usage["vsr_service_ms"] - r.usage["vsr_ttft_ms"]
              for r in recs)
    den = sum(r.usage["completion_tokens"] - 1 for r in recs)
    return num / den if den > 0 else None
