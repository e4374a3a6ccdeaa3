"""The traced window's model FLOPs over (window x the bf16 peak): every
served request of the traced batches at its real prompt and answer
lengths, by the benchmark's own arithmetic (``roofline/<family>.py``),
not the padded widths nor the dropless expert slots the program runs."""

from vsrbench.readers import mfu_pct


def read(run):
    return mfu_pct(run)
