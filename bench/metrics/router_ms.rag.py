"""Router time per request: every ``stage:*`` span of the window's batches
except ``stage:dispatch`` (the member's serving), summed and divided by
the requests of those batches."""

from vsrbench.readers import stage_ms_per_request


def read(run):
    return stage_ms_per_request(run, exclude=("stage:dispatch",))
