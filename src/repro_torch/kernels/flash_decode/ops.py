"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

``paged_flash_decode`` launches ``csrc/paged_decode.cu`` for CUDA tensors
(the port of the Pallas kernel ``paged_flash_decode``) and runs
``paged_flash_decode_plain`` for CPU tensors; any other device raises.
The kernel streams each row's live blocks straight out of the pool through
the block table; only the plain version builds the gathered view.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import sdpa

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
SMEM_LIMIT = 232_448          # bytes of shared memory a Hopper block may use


def gather_kv(pool, tbl):
    """Materialize per-row contiguous KV views from a paged pool.

    pool: (num_blocks, block_tokens, Hkv, hd) physical blocks;
    tbl: (B, max_blocks) int block table (0 = trash block).
    Returns (B, max_blocks * block_tokens, Hkv, hd).  The plain path's
    gather; the kernel never builds this tensor."""
    nb, blk = pool.shape[:2]
    flat = pool.reshape((nb * blk,) + tuple(pool.shape[2:]))
    idx = tbl.long()[:, :, None] * blk + \
        torch.arange(blk, device=pool.device)[None, None]
    return flat[idx.reshape(tbl.shape[0], -1)]


def paged_flash_decode_plain(q, kpool, vpool, tbl, kv_len):
    """The same function in plain PyTorch: gather, then ``layers.sdpa``
    with ``kv_len`` masking — exactly the model's ``decode_impl="xla"``
    program, so the two decode paths agree bitwise on the CPU.  Rows with
    ``kv_len == 0`` are zeros, as from the kernel."""
    out = sdpa(q[:, None], gather_kv(kpool, tbl), gather_kv(vpool, tbl),
               causal=False, kv_len=kv_len)[:, 0]
    return torch.where((kv_len > 0).to(out.device)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _check(q, kpool, vpool, tbl, kv_len):
    if q.dim() != 3 or kpool.dim() != 4 or kpool.shape != vpool.shape:
        raise ValueError(f"paged_flash_decode: q (B,Hq,hd), pools (nb,blk,"
                         f"Hkv,hd) expected, got {tuple(q.shape)}, "
                         f"{tuple(kpool.shape)}, {tuple(vpool.shape)}")
    B, Hq, hd = q.shape
    nb, blk, Hkv, hd_k = kpool.shape
    if hd_k != hd or Hq % Hkv:
        raise ValueError("paged_flash_decode: head_dim mismatch or Hq not a "
                         "multiple of Hkv")
    if hd > 128:
        raise ValueError(f"paged_flash_decode: head_dim {hd} > 128")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise TypeError(f"paged_flash_decode: float32 or bfloat16 q/pools of "
                        f"one dtype expected, got {q.dtype}/{kpool.dtype}/"
                        f"{vpool.dtype}")
    if tbl.dim() != 2 or tbl.shape[0] != B or tbl.dtype != torch.int32 or \
            kv_len.shape != (B,) or kv_len.dtype != torch.int32:
        raise ValueError("paged_flash_decode: tbl (B, max_blocks) and kv_len "
                         "(B,) must be int32")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                    ("tbl", tbl), ("kv_len", kv_len)):
        if t.device != q.device:
            raise ValueError(f"paged_flash_decode: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_flash_decode: {name} must be contiguous")


def paged_flash_decode(q, kpool, vpool, tbl, kv_len):
    """Block-table decode attention, no gather: stream each row's live
    physical blocks straight out of the pool.

    q: (B, Hq, hd); kpool/vpool: (num_blocks, block_tokens, Hkv, hd);
    tbl: (B, max_blocks) int32; kv_len: (B,) int32.  Returns (B, Hq, hd).
    CUDA tensors launch the hand-written kernel (``decode_impl=
    "flash_paged"`` selects this path in the model); CPU tensors take
    ``paged_flash_decode_plain``."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, kpool, vpool, tbl, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    _check(q, kpool, vpool, tbl, kv_len)
    B, Hq, hd = q.shape
    nb, blk, Hkv, _ = kpool.shape
    max_blocks = tbl.shape[1]
    smem = (Hq // Hkv) * (hd + max_blocks * blk) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_flash_decode: {smem} B of scores exceed the "
                         f"{SMEM_LIMIT} B of shared memory a block may use "
                         f"(max_seq {max_blocks * blk} too long)")
    out = torch.empty_like(q)
    fn = _build.c_function("paged_decode", "paged_decode_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                tbl.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, hd, nb, blk, max_blocks,
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"paged_flash_decode kernel launch failed: CUDA "
                           f"error {rc}")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
