"""The benchmark's yardstick for work: the chip's published peaks
(``h100.json``), each family's model FLOPs per request (``<family>.py``)
and each kernel's operations and bytes (``kernel_<name>.py``).  Each input
byte is counted read once and each output byte written once; the bound of
a piece of work is max(bytes / HBM bandwidth, FLOPs / peak rate)."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "h100.json").read_text())


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for the work (bf16 peak)."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["bf16_flops_per_s"])
