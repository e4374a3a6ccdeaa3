"""Share of the traced window in which no kernel, copy or memset ran on
the device (``torch.profiler``)."""

from vsrbench.readers import idle_pct


def read(run):
    return idle_pct(run)
