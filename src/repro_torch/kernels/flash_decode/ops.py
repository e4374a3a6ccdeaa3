"""Paged decode and speculative-verify attention: the CUDA kernels'
wrappers and plain versions.

``flash_decode`` is contiguous-cache decode: a thin wrapper over the
flash-attention kernel (``csrc/flash_attention.cu``) with one query
position per row, as the reference's ``flash_decode`` is the Sq = G case
of its folded flash-attention kernel.

``paged_flash_decode`` and ``paged_flash_verify`` launch
``csrc/paged_decode.cu`` (the port of the Pallas kernels
``paged_flash_decode`` and ``paged_flash_verify``, GQA: one kernel body,
decode is its W = 1 case); ``paged_flash_decode_mla`` and
``paged_flash_verify_mla`` launch ``csrc/paged_mla_decode.cu`` (the port of
``paged_flash_decode_mla`` and ``paged_flash_verify_mla``, absorbed-latent
MLA) for CUDA tensors.  Each runs its ``*_plain`` version for CPU tensors,
and any other device raises.  Each wrapper counts its own ``launches``.
The kernels stream each row's live blocks straight out of the pool through
the block table; only the plain versions build the gathered view.  The GQA
kernel splits each (row, KV head) over a thread-block cluster whose size
and spans ``paged_geometry`` computes from the table width alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.models.layers import mla_latent_core, sdpa

_ATTN_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 +
                  [ctypes.c_void_p])
_MLA_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 +
                 [ctypes.c_float, ctypes.c_void_p])
MLA_HEAD_TILE = 16            # query heads per thread block (paged_mla_decode.cu)
MLA_MAX_R, MLA_MAX_RH = 512, 128
SMEM_LIMIT = 232_448          # bytes of shared memory a Hopper block may use
PAGED_MAX_CLUSTER = 8         # the portable thread-block cluster size
PAGED_CHUNK = 32              # tokens per cp.async ring stage (paged_decode.cu CH)
PAGED_STAGES = 4              # ring stages (paged_decode.cu STAGES)


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


def _zero_dead_positions(out, kv_len):
    """Verify outputs (B, W, H, d): zeros where position t's frontier
    ``kv_len - W + t + 1`` is <= 0, as from the kernels."""
    W = out.shape[1]
    frontier = kv_len.long().to(out.device)[:, None] - W + 1 + \
        torch.arange(W, device=out.device)[None]
    return torch.where((frontier > 0)[:, :, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# contiguous-cache decode (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

def flash_decode_plain(q, k, v, kv_len):
    """The same function in plain PyTorch (``flash_attention_plain`` with
    one query position: ``layers.sdpa``'s op order, ``kv_len`` masking),
    the CPU path and the kernel's yardstick; ``ref.decode_reference`` is
    its float32 oracle.  A row with ``kv_len == 0`` gets the mean of V
    here and zeros from the kernel."""
    return flash_attention_plain(q[:, None], k, v, kv_len)[:, 0]


def flash_decode(q, k, v, kv_len):
    """Single-token GQA decode over a contiguous cache.

    q: (B, Hq, hd); k/v: (B, Skv, Hkv, hd); kv_len: (B,) int32 valid
    prefix.  Returns (B, Hq, hd).  CUDA tensors launch the flash-attention
    kernel (non-causal, Sq = 1, ``lens=kv_len``; its launch is counted on
    ``flash_attention.launches``); CPU tensors take
    ``flash_decode_plain``."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.dim() != 3:
        raise ValueError(f"flash_decode: q (B,Hq,hd) expected, got "
                         f"{tuple(q.shape)}")
    return flash_attention(q[:, None].contiguous(), k, v, kv_len)[:, 0]


# ---------------------------------------------------------------------------
# GQA decode and speculative verify (one kernel: csrc/paged_decode.cu)
# ---------------------------------------------------------------------------

def paged_flash_decode_plain(q, kpool, vpool, tbl, kv_len):
    """The same function in plain PyTorch: gather, then ``layers.sdpa``
    with ``kv_len`` masking — exactly the model's ``decode_impl="xla"``
    program, so the two decode paths agree bitwise on the CPU.  Rows with
    ``kv_len == 0`` are zeros, as from the kernel."""
    out = sdpa(q[:, None], gather_kv(kpool, tbl), gather_kv(vpool, tbl),
               causal=False, kv_len=kv_len)[:, 0]
    return _zero_dead_rows(out, kv_len)


def paged_flash_verify_plain(q, kpool, vpool, tbl, kv_len):
    """The verify in plain PyTorch: gather, then ``layers.sdpa`` with
    ``causal=True, q_offset=kv_len - W, kv_len=kv_len`` — exactly the
    model's ``decode_impl="xla"`` verify program, so the two verify paths
    agree bitwise on the CPU.  Position t's mask is a decode step's at
    ``kv_len - W + t + 1``; positions whose frontier is <= 0 are zeros, as
    from the kernel."""
    W = q.shape[1]
    out = sdpa(q, gather_kv(kpool, tbl), gather_kv(vpool, tbl), causal=True,
               q_offset=kv_len - W, kv_len=kv_len)
    return _zero_dead_positions(out, kv_len)


class PagedGeometry(NamedTuple):
    cluster: int        # C: CTAs of one (row, KV head) cluster
    span_blocks: int    # P: table blocks per CTA; rank c owns [c*P, (c+1)*P)
    smem_bytes: int     # dynamic shared memory of one CTA


def _up(x: int, a: int) -> int:
    return -(-x // a) * a


def paged_geometry(max_blocks: int, block_tokens: int, rows: int, hd: int,
                   esz: int) -> PagedGeometry:
    """Launch geometry of ``csrc/paged_decode.cu`` for a (B, max_blocks)
    table of ``block_tokens``-token blocks, ``rows`` = W x G query rows of
    head_dim ``hd`` in an ``esz``-byte dtype.

    The cluster size and the span come from the table width alone, never
    from W or kv_len: a decode at frontier f and a verify position at
    frontier f then run the same spans in the same order, which keeps them
    equal bitwise.  The shared memory is the kernel's carve (``carve`` in
    the source, which refuses a launch given less): query rows padded to
    16 (later the float32 partial P.V), float32 scores over the span, a
    ring of PAGED_STAGES chunks of PAGED_CHUNK tokens, every rank's row
    maxima and sums, every rank's partial of this CTA's output slice, the
    span's table entries."""
    cluster = min(PAGED_MAX_CLUSTER, max_blocks)
    span_blocks = -(-max_blocks // cluster)
    stride = _up(hd, 16) + 16 // esz
    span = span_blocks * block_tokens
    smem = (max(_up(_up(rows, 16) * stride * esz, 16), _up(rows * hd * 4, 16))
            + _up(rows * (_up(span, PAGED_CHUNK) + 4) * 4, 16)
            + _up(PAGED_STAGES * PAGED_CHUNK * stride * esz, 16)
            + _up(2 * PAGED_MAX_CLUSTER * rows * 4, 16)
            + _up((rows * hd + PAGED_MAX_CLUSTER) * 4, 16)
            + _up(span_blocks * 4, 16))
    return PagedGeometry(cluster, span_blocks, smem)


def _check(name, q, kpool, vpool, tbl, kv_len):
    """q: (B, W, Hq, hd) — decode passes its (B, Hq, hd) query as W = 1."""
    if q.dim() != 4 or kpool.dim() != 4 or kpool.shape != vpool.shape:
        raise ValueError(f"{name}: q (B,[W,]Hq,hd), pools (nb,blk,Hkv,hd) "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(kpool.shape)}, {tuple(vpool.shape)}")
    B, W, Hq, hd = q.shape
    nb, blk, Hkv, hd_k = kpool.shape
    if hd_k != hd or Hq % Hkv:
        raise ValueError(f"{name}: head_dim mismatch or Hq not a multiple of "
                         f"Hkv")
    if hd > 128:
        raise ValueError(f"{name}: head_dim {hd} > 128")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise TypeError(f"{name}: float32 or bfloat16 q/pools of one dtype "
                        f"expected, got {q.dtype}/{kpool.dtype}/"
                        f"{vpool.dtype}")
    if tbl.dim() != 2 or tbl.shape[0] != B or tbl.dtype != torch.int32 or \
            kv_len.shape != (B,) or kv_len.dtype != torch.int32:
        raise ValueError(f"{name}: tbl (B, max_blocks) and kv_len (B,) must "
                         f"be int32")
    for arg, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                   ("tbl", tbl), ("kv_len", kv_len)):
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    geo = paged_geometry(tbl.shape[1], blk, W * (Hq // Hkv), hd,
                         q.element_size())
    if geo.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: {geo.smem_bytes} B of queries, scores and "
                         f"K/V ring exceed the {SMEM_LIMIT} B of shared memory "
                         f"a block may use (W {W}, max_seq "
                         f"{tbl.shape[1] * blk} too long)")
    return geo


def _launch_attn(name, q, kpool, vpool, tbl, kv_len):
    """Check and launch ``csrc/paged_decode.cu`` on q (B, W, Hq, hd);
    returns the (B, W, Hq, hd) output."""
    geo = _check(name, q, kpool, vpool, tbl, kv_len)
    B, W, Hq, hd = q.shape
    nb, blk, Hkv, _ = kpool.shape
    out = torch.empty_like(q)
    fn = _build.c_function("paged_decode", "paged_attn_fwd", _ATTN_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                tbl.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                B, W, Hq, Hkv, hd, nb, blk, tbl.shape[1],
                int(q.dtype == torch.bfloat16), *geo, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


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
    if q.dim() != 3:
        raise ValueError(f"paged_flash_decode: q (B,Hq,hd) expected, got "
                         f"{tuple(q.shape)}")
    out = _launch_attn("paged_flash_decode", q[:, None], kpool, vpool, tbl,
                       kv_len)[:, 0]
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def paged_flash_verify(q, kpool, vpool, tbl, kv_len):
    """Speculative-verify attention over the paged pool, no gather.

    q: (B, W, Hq, hd) — W = 1 + k positions per row (the pending token and
    k draft proposals), whose K/V the caller has already written at
    ``kv_len - W .. kv_len - 1``; kpool/vpool: (num_blocks, block_tokens,
    Hkv, hd); tbl: (B, max_blocks) int32; kv_len: (B,) int32, the TOTAL
    length including the W new entries.  Returns (B, W, Hq, hd); position
    t equals ``paged_flash_decode`` at ``kv_len - W + t + 1``.  CUDA
    tensors launch the hand-written kernel (the decode kernel's body with
    W query positions in its tile); CPU tensors take
    ``paged_flash_verify_plain``."""
    if q.device.type == "cpu":
        return paged_flash_verify_plain(q, kpool, vpool, tbl, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_verify: unsupported device {q.device}")
    out = _launch_attn("paged_flash_verify", q, kpool, vpool, tbl, kv_len)
    paged_flash_verify.launches += 1
    return out


paged_flash_verify.launches = 0


# ---------------------------------------------------------------------------
# absorbed-latent MLA decode and speculative verify (one kernel:
# csrc/paged_mla_decode.cu)
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


def paged_flash_verify_mla_plain(q_lat, q_rope, ckv_pool, krope_pool, tbl,
                                 kv_len, *, scale):
    """The MLA verify in plain PyTorch: gather the latent views, then
    ``layers.mla_latent_core`` with ``causal=True, q_offset=kv_len - W,
    kv_len=kv_len`` — the core of the model's ``decode_impl="xla"`` MLA
    verify program.  Positions whose frontier is <= 0 are zeros, as from
    the kernel."""
    W = q_lat.shape[1]
    ctx = mla_latent_core(q_lat, q_rope, gather_kv(ckv_pool, tbl),
                          gather_kv(krope_pool, tbl), scale=scale, causal=True,
                          q_offset=kv_len - W, kv_len=kv_len)
    return _zero_dead_positions(ctx, kv_len)


def mla_smem_bytes(r: int, rh: int, max_seq: int) -> int:
    """Shared memory one block of the MLA kernel needs: its head tile's
    float32 queries and float32 scores over the whole table (whatever W:
    each block serves one position)."""
    return MLA_HEAD_TILE * (r + rh + max_seq) * 4


def _check_mla(name, q_lat, q_rope, ckv_pool, krope_pool, tbl, kv_len):
    """q_lat: (B, W, H, r); q_rope: (B, W, H, rh) — decode passes W = 1."""
    if q_lat.dim() != 4 or q_rope.dim() != 4 or ckv_pool.dim() != 3 or \
            krope_pool.dim() != 3:
        raise ValueError(f"{name}: q_lat (B,[W,]H,r), q_rope (B,[W,]H,rh), "
                         f"pools (nb,blk,r|rh) expected, got "
                         f"{tuple(q_lat.shape)}, {tuple(q_rope.shape)}, "
                         f"{tuple(ckv_pool.shape)}, "
                         f"{tuple(krope_pool.shape)}")
    B, W, H, r = q_lat.shape
    rh = q_rope.shape[3]
    if q_rope.shape[:3] != (B, W, H) or ckv_pool.shape[2] != r or \
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
    smem = mla_smem_bytes(r, rh, tbl.shape[1] * ckv_pool.shape[1])
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} B of queries and scores exceed the "
                         f"{SMEM_LIMIT} B of shared memory a block may use "
                         f"(max_seq {tbl.shape[1] * ckv_pool.shape[1]} too "
                         f"long)")


def _launch_mla(name, q_lat, q_rope, ckv_pool, krope_pool, tbl, kv_len,
                scale):
    """Check and launch ``csrc/paged_mla_decode.cu`` on (B, W, H, r|rh)
    queries; returns the (B, W, H, r) latent context."""
    _check_mla(name, q_lat, q_rope, ckv_pool, krope_pool, tbl, kv_len)
    B, W, H, r = q_lat.shape
    rh = q_rope.shape[3]
    nb, blk = ckv_pool.shape[:2]
    out = torch.empty_like(q_lat)
    fn = _build.c_function("paged_mla_decode", "paged_mla_fwd",
                           _MLA_ARGTYPES)
    with torch.cuda.device(q_lat.device):
        rc = fn(q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
                krope_pool.data_ptr(), tbl.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), B, W, H, r, rh, nb, blk, tbl.shape[1],
                int(q_lat.dtype == torch.bfloat16), float(scale),
                _stream(q_lat.device))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


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
    if q_lat.dim() != 3 or q_rope.dim() != 3:
        raise ValueError(f"paged_flash_decode_mla: q_lat (B,H,r), q_rope "
                         f"(B,H,rh) expected, got {tuple(q_lat.shape)}, "
                         f"{tuple(q_rope.shape)}")
    out = _launch_mla("paged_flash_decode_mla", q_lat[:, None],
                      q_rope[:, None], ckv_pool, krope_pool, tbl, kv_len,
                      scale)[:, 0]
    paged_flash_decode_mla.launches += 1
    return out


paged_flash_decode_mla.launches = 0


def paged_flash_verify_mla(q_lat, q_rope, ckv_pool, krope_pool, tbl, kv_len,
                           *, scale):
    """Absorbed-latent MLA speculative verify over the paged pool, no
    gather.

    q_lat: (B, W, H, r); q_rope: (B, W, H, rh); pools/tbl as in
    ``paged_flash_decode_mla``; kv_len: (B,) int32, the TOTAL length
    including the W freshly written latents.  Returns the latent context
    (B, W, H, r); position t equals ``paged_flash_decode_mla`` at
    ``kv_len - W + t + 1``.  CUDA tensors launch the hand-written kernel
    (the decode kernel's body, one block per row, position and head tile);
    CPU tensors take ``paged_flash_verify_mla_plain``."""
    if q_lat.device.type == "cpu":
        return paged_flash_verify_mla_plain(q_lat, q_rope, ckv_pool,
                                            krope_pool, tbl, kv_len,
                                            scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"paged_flash_verify_mla: unsupported device "
                         f"{q_lat.device}")
    out = _launch_mla("paged_flash_verify_mla", q_lat, q_rope, ckv_pool,
                      krope_pool, tbl, kv_len, scale)
    paged_flash_verify_mla.launches += 1
    return out


paged_flash_verify_mla.launches = 0
