"""Signal extraction time per request: the ``stage:signals`` spans of the
window's batches (the encoder's forward, kernel 6, the heuristics),
summed and divided by the requests of those batches."""

from vsrbench.readers import stage_ms_per_request


def read(run):
    return stage_ms_per_request(run, include=("stage:signals",))
