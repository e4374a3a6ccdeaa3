"""Kernel 1 of the port, the flash-attention prefill
(``kernels/csrc/flash_attention.cu``): its name in a device trace and the
work of one launch.

A launch's grid is (ceil(S / 64), query heads, rows), so the trace gives
each launch's query rows rounded up to a tile of 64; the work is counted at
that width (the kernel's inputs are right-padded, and it sees no lengths).
Causal: query row i attends to keys 0..i.  Bytes: q, k, v read once and the
output written once, bf16."""

NAMES = ("flash_attention_tc_kernel",)
TILE_Q = 64


def launch_work(grid, kv_heads: int, head_dim: int, esz: int = 2):
    """(FLOPs, bytes) of one causal launch with ``grid`` = (tiles, query
    heads, rows)."""
    tiles, hq, rows = (int(g) for g in grid)
    s = tiles * TILE_Q
    keys = s * (s + 1) // 2
    flops = 4.0 * head_dim * hq * rows * keys
    nbytes = esz * rows * s * head_dim * (2 * hq + 2 * kv_heads)
    return flops, nbytes
