"""Kernel 4 of the port, the paged MLA decode
(``kernels/csrc/paged_mla_decode.cu``): its name in a device trace and its
work.

One launch per MLA layer and decode step, over every slot of the lane
(``rows``): each row reads its absorbed query (H x r) and rope query (H x
rh), the latents and rope keys of its live keys once ((r + rh) a key), its
block-table row and length, and writes its context (H x r).  FLOPs: per
live key and head, 2 (r + rh) for the score and 2 r for the context.  A
freed slot is masked to one key of the trash block."""

NAMES = ("paged_mla_kernel",)


def fixed_work(rows: int, heads: int, r: int, rh: int, max_blocks: int,
               esz: int = 2):
    """(FLOPs, bytes) of one launch apart from its keys."""
    nbytes = esz * rows * heads * (2 * r + rh) + 4 * rows * (max_blocks + 1)
    return 0.0, float(nbytes)


def key_work(keys: int, heads: int, r: int, rh: int, esz: int = 2):
    """(FLOPs, bytes) of ``keys`` (row, key) pairs read by launches."""
    return (float(keys) * heads * (4 * r + 2 * rh),
            float(keys) * esz * (r + rh))
