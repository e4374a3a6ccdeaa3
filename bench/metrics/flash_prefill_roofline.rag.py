"""Kernel 1 (flash-attention prefill) against its roofline: the sum over
the traced window's launches of each launch's least time, over their
device time (``torch.profiler``, by the names in
``roofline/kernel_flash_prefill.py``).  Each launch's work is counted at
the query rows its grid covers (the kernel runs on the padded prompt)."""

from roofline import bound_s
from roofline.kernel_flash_prefill import NAMES, launch_work
from vsrbench.readers import kernel_seconds


def read(run):
    t = run.trace
    if t is None:
        return None
    ev = t.kernels(NAMES)
    secs = kernel_seconds(ev)
    if not ev or secs <= 0 or any(e.grid is None for e in ev):
        return None
    cfg = run.config
    least = sum(bound_s(*launch_work(e.grid, cfg["multi_query_group_num"],
                                     cfg["kv_channels"])) for e in ev)
    return 100.0 * least / secs
