"""Flash attention: the CUDA kernel's wrapper and its plain version.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
(the port of the Pallas kernel ``flash_attention_folded``) and runs
``flash_attention_plain`` for CPU tensors; any other device raises.  There
is no fallback: a CUDA tensor gets the kernel or an error.  The layout is
the reference wrapper's (B, S, H, hd); the kernel reads it directly, so no
head folding is materialized.  ``flash_geometry`` gives the launch's
padded head_dim and dynamic shared memory (the bf16 body's Q tile and K/V
ring).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, host_values, observed, refuse_grad
from repro_torch.models.layers import sdpa

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
SMEM_LIMIT = 232_448          # bytes of shared memory a Hopper block may use
FLASH_BLOCK_Q = 64            # query rows per CTA (flash_attention.cu TQ)
FLASH_STAGE_KEYS = 128        # keys per ring stage (SK: 2 warps x 64)
FLASH_ROW_PAD = 8             # bf16 padding per shared-memory row (PAD)


class FlashGeometry(NamedTuple):
    head_pad: int       # head_dim rounded up to the instantiated width
    stages: int         # K/V ring stages (0: the float32 body has no ring)
    smem_bytes: int     # dynamic shared memory of one CTA


def flash_geometry(hd: int, esz: int) -> FlashGeometry:
    """Launch geometry of ``csrc/flash_attention.cu`` for head_dim ``hd``
    in an ``esz``-byte dtype.

    bf16 (esz 2): head_dim padded to 32, 64 or 128; a ring of 5 stages
    where head_dim <= 64 (the fleet's longest prefill in flight at once),
    3 at 128; the CTA's dynamic shared memory is the kernel's carve
    (``tc_smem``, which refuses a launch given less): the Q tile of
    FLASH_BLOCK_Q rows, then the K ring and the V ring of FLASH_STAGE_KEYS
    keys a stage, each row ``head_pad + FLASH_ROW_PAD`` elements.  float32
    (esz 4): the FMA body pads to 64 or 128 and uses static shared memory
    only (at most 41 216 B, under the 48 KB static limit), so its dynamic
    size is 0."""
    if esz == 4:
        return FlashGeometry(64 if hd <= 64 else 128, 0, 0)
    head_pad = 32 if hd <= 32 else 64 if hd <= 64 else 128
    stages = 5 if head_pad <= 64 else 3
    rows = FLASH_BLOCK_Q + 2 * stages * FLASH_STAGE_KEYS
    return FlashGeometry(head_pad, stages,
                         rows * (head_pad + FLASH_ROW_PAD) * esz)


def flash_attention_plain(q, k, v, lens: Optional[torch.Tensor] = None, *,
                          causal: bool = False, sliding_window: int = 0,
                          q_offset: int = 0):
    """The same function in plain PyTorch, with the op order of
    ``layers.sdpa`` (the CPU path, and the kernel's yardstick on the card).

    One difference from the kernel: a query row that sees no key at all
    (possible only with ``lens`` or a window) gets the mean of V here and
    zeros from the kernel, as from the TPU kernel."""
    return sdpa(q, k, v, causal=causal, sliding_window=sliding_window,
                q_offset=q_offset, kv_len=lens)


def _check(q, k, v, lens, q_offset):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,Sq,Hq,hd), k/v (B,Skv,Hkv,hd)"
                         f" expected, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    B, _, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % k.shape[2]:
        raise ValueError("flash_attention: batch/head_dim mismatch or Hq not "
                         "a multiple of Hkv")
    if hd > 128:
        raise ValueError(f"flash_attention: head_dim {hd} > 128")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 q/k/v of one "
                        f"dtype expected, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if lens is not None:
        if lens.dtype != torch.int32 or lens.shape != (B,) or \
                lens.device != q.device or not lens.is_contiguous():
            raise ValueError("flash_attention: lens must be a contiguous (B,) "
                             "int32 tensor on q's device")
    if int(q_offset) < 0:
        raise ValueError("flash_attention: q_offset must be >= 0")


def _key_range(B: int, Sq: int, Skv: int, *, causal: bool,
               sliding_window: int, q_offset: int, lens):
    """(lo, hi): (B, Sq) int64 bounds of the keys each query position sees
    under the kernel's masks (causal at ``q_offset + i``, the sliding
    window, ``lens`` per row, host values)."""
    a = torch.arange(Sq, dtype=torch.int64) + int(q_offset)       # (Sq,)
    hi = torch.full((B, Sq), Skv, dtype=torch.int64)
    if causal:
        hi = torch.minimum(hi, (a + 1)[None])
    if lens is not None:
        hi = torch.minimum(hi, lens.long()[:, None])
    lo = torch.zeros((B, Sq), dtype=torch.int64)
    if sliding_window > 0:
        lo = (a - sliding_window + 1).clamp(min=0)[None].expand(B, Sq)
    return lo, hi


def flash_attention_cost(q, k, v, lens: Optional[torch.Tensor] = None, *,
                         causal: bool = False, sliding_window: int = 0,
                         q_offset: int = 0, values=None):
    """``(flops, bytes, dtype)`` of a ``flash_attention`` call: q and out
    once, K and V of each row's live keys (from the first key its first
    query sees to the last its last query sees) once, ``lens`` once; QK^T
    and PV over each query position's frontier, 4 hd FLOPs a (query head,
    key) pair."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    lo, hi = _key_range(B, Sq, Skv, causal=causal,
                        sliding_window=sliding_window, q_offset=q_offset,
                        lens=None if lens is None else
                        host_values(lens, values))
    live = int((hi[:, -1] - lo[:, 0]).clamp(min=0).sum())
    esz = q.element_size()
    nbytes = (2 * B * Sq * Hq * hd + 2 * live * Hkv * hd) * esz + \
        (0 if lens is None else B * 4)
    flops = 4 * hd * Hq * int((hi - lo).clamp(min=0).sum())
    return flops, nbytes, str(q.dtype).split(".")[-1]


@observed("flash_attention", flash_attention_cost)
def flash_attention(q, k, v, lens: Optional[torch.Tensor] = None, *,
                    causal: bool = False, sliding_window: int = 0,
                    q_offset: int = 0):
    """q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd); lens: (B,) int32 valid
    KV length or None.  Returns (B, Sq, Hq, hd) in q.dtype.

    CUDA tensors launch the hand-written kernel (``attn_impl="pallas"``
    selects this path in the model, after the reference's name for its TPU
    kernel); CPU tensors take ``flash_attention_plain``; meta tensors get
    an empty output (a dry run's shapes).  Inputs that require grad raise
    ``NotImplementedError`` under autograd."""
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lens, causal=causal,
                                     sliding_window=sliding_window,
                                     q_offset=q_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, lens, q_offset)
    if q.device.type == "meta":
        return torch.empty_like(q)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    geo = flash_geometry(hd, q.element_size())
    out = torch.empty_like(q)
    fn = _build.c_function("flash_attention", "flash_attention_fwd",
                           _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if lens is None else lens.data_ptr(), out.data_ptr(),
                B, Sq, Skv, Hq, Hkv, hd, int(causal), int(sliding_window),
                int(q_offset), int(q.dtype == torch.bfloat16),
                geo.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
