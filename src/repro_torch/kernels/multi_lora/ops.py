"""Batched multi-adapter LoRA (Punica/S-LoRA BGMV): the CUDA kernel's
wrapper and its plain version.

``multi_lora`` launches ``csrc/multi_lora.cu`` (the port of the Pallas
kernel ``multi_lora_pallas``) for CUDA tensors and runs
``multi_lora_plain`` for CPU tensors; any other device raises.  There is
no fallback: a CUDA tensor gets the kernel or an error.  The optional base
product ``x @ w`` stays ``torch.matmul``, outside the kernel, as the
reference computes it outside its ``pallas_call``.  ``lora_geometry``
gives the launch's padded rank, ring stages and dynamic shared memory.

The launch count is exact when the signal engine's thread pool launches
from several threads: a lock guards it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 +
             [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
MAX_RANK = 64                 # adapter ranks the kernel takes (csrc/multi_lora.cu)
LORA_BLOCK_ROWS = 128         # rows per CTA tile (BM: 8 warps x 16)
LORA_CHUNK_BYTES = 128        # bytes of each x row per shrink stage
LORA_N_CHUNK = 64             # dout columns per expand stage (NC)
# dynamic shared memory per CTA that keeps two CTAs on one SM
# (csrc/multi_lora.cu SMEM_TWO_CTAS)
LORA_SMEM_TWO_CTAS = 114_688
_count_lock = threading.Lock()


class LoraGeometry(NamedTuple):
    rank_pad: int       # rank rounded up to the instantiated width
    stages: int         # cp.async ring stages
    smem_bytes: int     # dynamic shared memory of one CTA


def lora_geometry(r: int, esz: int) -> LoraGeometry:
    """Launch geometry of ``csrc/multi_lora.cu`` for rank ``r`` in an
    ``esz``-byte dtype: the kernel's own carve (``smem_need``), which
    refuses a launch given less.

    The rank is padded to 8, 16, 32 or 64.  A ring stage holds the larger
    of a shrink job (LORA_CHUNK_BYTES of each of LORA_BLOCK_ROWS rows of
    x, rows padded by 16 bytes, plus as many rows of A with a row stride
    of ``rank_pad`` or ``rank_pad + 8`` elements, whichever keeps fragment
    reads on distinct banks) and an expand job (``rank_pad`` rows of
    LORA_N_CHUNK columns of B, padded by 16 bytes), rounded up to 128
    bytes.  After the ring, each of the 8 warps has a 16 x
    (LORA_N_CHUNK + 8) output staging tile.  The ring takes the most
    stages, 2 to 4, that keep the CTA within LORA_SMEM_TWO_CTAS."""
    rank_pad = 8 if r <= 8 else 16 if r <= 16 else 32 if r <= 32 else 64
    pad = 16 // esz
    kc = LORA_CHUNK_BYTES // esz
    a_stride = rank_pad if rank_pad % 16 == 8 else rank_pad + 8
    shrink = (LORA_BLOCK_ROWS * (kc + pad) + kc * a_stride) * esz
    expand = rank_pad * (LORA_N_CHUNK + pad) * esz
    stage = -(-max(shrink, expand) // 128) * 128
    staging = 8 * 16 * (LORA_N_CHUNK + 8) * esz
    stages = 4
    while stages > 2 and stages * stage + staging > LORA_SMEM_TWO_CTAS:
        stages -= 1
    return LoraGeometry(rank_pad, stages, stages * stage + staging)


def multi_lora_plain(x, a, b, task_ids, *, scale: float = 1.0):
    """The per-row adapter delta in plain PyTorch with the Pallas kernel's
    op order (``multi_lora.py:_kernel``): for each task t, ``h = x·A[t]``
    and ``y = h·B[t]`` over every row in float32 (h is not rounded to the
    input dtype in between), ``acc += y · mask[:, t]``; then ``acc·scale``
    cast to ``x.dtype``.  A row whose id is outside [0, T) gets exact
    zeros, as the Pallas wrapper's all-zero one-hot row gives.

    x: (N, din); a: (T, din, r); b: (T, r, dout); task_ids: (N,) int.
    Returns (N, dout) in x.dtype."""
    N = x.shape[0]
    T, dout = a.shape[0], b.shape[2]
    xf = x.float()
    acc = torch.zeros((N, dout), dtype=torch.float32, device=x.device)
    for t in range(T):
        mask = (task_ids == t).to(torch.float32)[:, None]
        h = xf @ a[t].float()
        y = h @ b[t].float()
        acc += y * mask
    return (acc * scale).to(x.dtype)


def _check(x, a, b, task_ids):
    if x.dim() != 2 or a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"multi_lora: x (N,din), a (T,din,r), b (T,r,dout) "
                         f"expected, got {tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    N, din = x.shape
    T, din_a, r = a.shape
    if din_a != din or b.shape[0] != T or b.shape[1] != r:
        raise ValueError(f"multi_lora: shapes disagree: x {tuple(x.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"multi_lora: rank {r} outside [1, {MAX_RANK}]")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            a.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"multi_lora: float32 or bfloat16 x/a/b of one dtype "
                        f"expected, got {x.dtype}/{a.dtype}/{b.dtype}")
    if task_ids.shape != (N,) or task_ids.dtype != torch.int32:
        raise ValueError(f"multi_lora: task_ids must be (N,) int32, got "
                         f"{tuple(task_ids.shape)} {task_ids.dtype}")
    for name, t in (("x", x), ("a", a), ("b", b), ("task_ids", task_ids)):
        if t.device != x.device:
            raise ValueError(f"multi_lora: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"multi_lora: {name} must be contiguous")


def _delta(x, a, b, task_ids, scale):
    if x.device.type == "cpu":
        return multi_lora_plain(x, a, b, task_ids, scale=scale)
    if x.device.type != "cuda":
        raise ValueError(f"multi_lora: unsupported device {x.device}")
    _check(x, a, b, task_ids)
    N, din = x.shape
    T, _, r = a.shape
    dout = b.shape[2]
    out = torch.empty((N, dout), dtype=x.dtype, device=x.device)
    if N == 0 or dout == 0:
        return out
    geo = lora_geometry(r, x.element_size())
    fn = _build.c_function("multi_lora", "multi_lora_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), task_ids.data_ptr(),
                out.data_ptr(), N, din, dout, T, r, float(scale),
                int(x.dtype == torch.bfloat16), geo.smem_bytes,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"multi_lora kernel launch failed: CUDA error {rc}")
    with _count_lock:
        multi_lora.launches += 1
    return out


def multi_lora(x, a, b, task_ids, w: Optional[torch.Tensor] = None, *,
               scale: float = 1.0):
    """x: (N, din); a: (T, din, r); b: (T, r, dout); task_ids: (N,) int32.

    Returns (N, dout) = [x @ w +] scale * B[t] (A[t] x)  per row, in
    x.dtype; rows whose id is outside [0, T) get a zero delta.  CUDA
    tensors launch the hand-written kernel (float32 or bfloat16, float32
    accumulation, any row order, rank up to 64); CPU tensors take
    ``multi_lora_plain``."""
    delta = _delta(x, a, b, task_ids, scale)
    if w is not None:
        return x @ w + delta
    return delta


multi_lora.launches = 0
