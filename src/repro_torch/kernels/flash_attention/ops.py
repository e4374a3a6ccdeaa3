"""Flash attention: the CUDA kernel's wrapper and its plain version.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
(the port of the Pallas kernel ``flash_attention_folded``) and runs
``flash_attention_plain`` for CPU tensors; any other device raises.  There
is no fallback: a CUDA tensor gets the kernel or an error.  The layout is
the reference wrapper's (B, S, H, hd); the kernel reads it directly, so no
head folding is materialized.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import sdpa

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


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


def flash_attention(q, k, v, lens: Optional[torch.Tensor] = None, *,
                    causal: bool = False, sliding_window: int = 0,
                    q_offset: int = 0):
    """q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd); lens: (B,) int32 valid
    KV length or None.  Returns (B, Sq, Hq, hd) in q.dtype.

    CUDA tensors launch the hand-written kernel (``attn_impl="pallas"``
    selects this path in the model, after the reference's name for its TPU
    kernel); CPU tensors take ``flash_attention_plain``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lens, causal=causal,
                                     sliding_window=sliding_window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, lens, q_offset)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _build.c_function("flash_attention", "flash_attention_fwd",
                           _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if lens is None else lens.data_ptr(), out.data_ptr(),
                B, Sq, Skv, Hq, Hkv, hd, int(causal), int(sliding_window),
                int(q_offset), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
