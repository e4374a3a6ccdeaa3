"""Paged decode attention: the CUDA kernels' wrappers and plain versions.

``paged_flash_decode`` launches ``csrc/paged_decode.cu`` (the port of the
Pallas kernel ``paged_flash_decode``, GQA) and ``paged_flash_decode_mla``
launches ``csrc/paged_mla_decode.cu`` (the port of
``paged_flash_decode_mla``, absorbed-latent MLA) for CUDA tensors; each
runs its ``*_plain`` version for CPU tensors, and any other device raises.
The kernels stream each row's live blocks straight out of the pool through
the block table; only the plain versions build the gathered view.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import mla_latent_core, sdpa

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_MLA_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 +
                 [ctypes.c_float, ctypes.c_void_p])
MLA_HEAD_TILE = 16            # query heads per thread block (paged_mla_decode.cu)
MLA_MAX_R, MLA_MAX_RH = 512, 128
SMEM_LIMIT = 232_448          # bytes of shared memory a Hopper block may use


def gather_kv(pool, tbl):
    """Materialize per-row contiguous KV views from a paged pool.

    pool: (num_blocks, block_tokens, ...) physical blocks (GQA K/V
    ``(Hkv, hd)`` or MLA latents ``(r,)`` per token); tbl: (B, max_blocks)
    int block table (0 = trash block).  Returns (B, max_blocks *
    block_tokens, ...).  The plain path's gather; the kernels never build
    this tensor."""
    nb, blk = pool.shape[:2]
    flat = pool.reshape((nb * blk,) + tuple(pool.shape[2:]))
    idx = tbl.long()[:, :, None] * blk + \
        torch.arange(blk, device=pool.device)[None, None]
    return flat[idx.reshape(tbl.shape[0], -1)]


def _zero_dead_rows(out, kv_len):
    return torch.where((kv_len > 0).to(out.device)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def paged_flash_decode_plain(q, kpool, vpool, tbl, kv_len):
    """The same function in plain PyTorch: gather, then ``layers.sdpa``
    with ``kv_len`` masking — exactly the model's ``decode_impl="xla"``
    program, so the two decode paths agree bitwise on the CPU.  Rows with
    ``kv_len == 0`` are zeros, as from the kernel."""
    out = sdpa(q[:, None], gather_kv(kpool, tbl), gather_kv(vpool, tbl),
               causal=False, kv_len=kv_len)[:, 0]
    return _zero_dead_rows(out, kv_len)


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


# ---------------------------------------------------------------------------
# absorbed-latent MLA decode
# ---------------------------------------------------------------------------

def paged_flash_decode_mla_plain(q_lat, q_rope, ckv_pool, krope_pool, tbl,
                                 kv_len, *, scale):
    """The same function in plain PyTorch: gather the latent views, then
    ``layers.mla_latent_core`` with ``kv_len`` masking — the core of the
    model's ``decode_impl="xla"`` MLA program, so the two decode paths
    agree bitwise on the CPU.  Rows with ``kv_len == 0`` are zeros, as
    from the kernel."""
    ctx = mla_latent_core(q_lat[:, None], q_rope[:, None],
                          gather_kv(ckv_pool, tbl), gather_kv(krope_pool, tbl),
                          scale=scale, causal=False, kv_len=kv_len)[:, 0]
    return _zero_dead_rows(ctx, kv_len)


def mla_smem_bytes(r: int, rh: int, max_seq: int) -> int:
    """Shared memory one block of the MLA kernel needs: its head tile's
    float32 queries and float32 scores over the whole table."""
    return MLA_HEAD_TILE * (r + rh + max_seq) * 4


def _check_mla(q_lat, q_rope, ckv_pool, krope_pool, tbl, kv_len):
    name = "paged_flash_decode_mla"
    if q_lat.dim() != 3 or q_rope.dim() != 3 or ckv_pool.dim() != 3 or \
            krope_pool.dim() != 3:
        raise ValueError(f"{name}: q_lat (B,H,r), q_rope (B,H,rh), pools "
                         f"(nb,blk,r|rh) expected, got {tuple(q_lat.shape)}, "
                         f"{tuple(q_rope.shape)}, {tuple(ckv_pool.shape)}, "
                         f"{tuple(krope_pool.shape)}")
    B, H, r = q_lat.shape
    rh = q_rope.shape[2]
    if q_rope.shape[:2] != (B, H) or ckv_pool.shape[2] != r or \
            krope_pool.shape[2] != rh or \
            krope_pool.shape[:2] != ckv_pool.shape[:2]:
        raise ValueError(f"{name}: shapes disagree: q_lat {tuple(q_lat.shape)}"
                         f", q_rope {tuple(q_rope.shape)}, ckv_pool "
                         f"{tuple(ckv_pool.shape)}, krope_pool "
                         f"{tuple(krope_pool.shape)}")
    if r > MLA_MAX_R or rh > MLA_MAX_RH:
        raise ValueError(f"{name}: latent rank {r} > {MLA_MAX_R} or rope "
                         f"width {rh} > {MLA_MAX_RH}")
    dts = {q_lat.dtype, q_rope.dtype, ckv_pool.dtype, krope_pool.dtype}
    if len(dts) != 1 or q_lat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: float32 or bfloat16 queries/pools of one "
                        f"dtype expected, got {sorted(map(str, dts))}")
    if tbl.dim() != 2 or tbl.shape[0] != B or tbl.dtype != torch.int32 or \
            kv_len.shape != (B,) or kv_len.dtype != torch.int32:
        raise ValueError(f"{name}: tbl (B, max_blocks) and kv_len (B,) must "
                         f"be int32")
    for arg, t in (("q_lat", q_lat), ("q_rope", q_rope),
                   ("ckv_pool", ckv_pool), ("krope_pool", krope_pool),
                   ("tbl", tbl), ("kv_len", kv_len)):
        if t.device != q_lat.device:
            raise ValueError(f"{name}: {arg} on {t.device}, q_lat on "
                             f"{q_lat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def paged_flash_decode_mla(q_lat, q_rope, ckv_pool, krope_pool, tbl, kv_len,
                           *, scale):
    """Absorbed-latent MLA decode over the paged compressed cache, no
    gather.

    q_lat: (B, H, r) latent queries (q_nope @ Wk_b); q_rope: (B, H, rh);
    ckv_pool: (num_blocks, block_tokens, r); krope_pool: (num_blocks,
    block_tokens, rh); tbl: (B, max_blocks) int32; kv_len: (B,) int32.
    Returns the latent context ctx = softmax(scores) @ ckv, (B, H, r), in
    ``q_lat.dtype`` — the caller applies Wv_b and wo.  ``scale`` is
    1/sqrt(nope_hd + rope_hd).  CUDA tensors launch the hand-written
    kernel (``decode_impl="flash_paged"`` selects this path for MLA
    layers); CPU tensors take ``paged_flash_decode_mla_plain``."""
    if q_lat.device.type == "cpu":
        return paged_flash_decode_mla_plain(q_lat, q_rope, ckv_pool,
                                            krope_pool, tbl, kv_len,
                                            scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_mla: unsupported device "
                         f"{q_lat.device}")
    _check_mla(q_lat, q_rope, ckv_pool, krope_pool, tbl, kv_len)
    B, H, r = q_lat.shape
    rh = q_rope.shape[2]
    nb, blk = ckv_pool.shape[:2]
    max_blocks = tbl.shape[1]
    smem = mla_smem_bytes(r, rh, max_blocks * blk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_flash_decode_mla: {smem} B of queries and "
                         f"scores exceed the {SMEM_LIMIT} B of shared memory "
                         f"a block may use (max_seq {max_blocks * blk} too "
                         f"long)")
    out = torch.empty_like(q_lat)
    fn = _build.c_function("paged_mla_decode", "paged_mla_decode_fwd",
                           _MLA_ARGTYPES)
    with torch.cuda.device(q_lat.device):
        stream = torch.cuda.current_stream(q_lat.device).cuda_stream
        rc = fn(q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
                krope_pool.data_ptr(), tbl.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), B, H, r, rh, nb, blk, max_blocks,
                int(q_lat.dtype == torch.bfloat16), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"paged_flash_decode_mla kernel launch failed: "
                           f"CUDA error {rc}")
    paged_flash_decode_mla.launches += 1
    return out


paged_flash_decode_mla.launches = 0
