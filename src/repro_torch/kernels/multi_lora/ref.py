"""Float32 oracle for batched multi-adapter LoRA (BGMV), the port of
``repro.kernels.multi_lora.ref``.

The reference gathers each row's adapter (``a[task_ids]``, an (N, din, r)
tensor: ~3 GB at the encoder path's 30 720 rows); this oracle computes the
same function one task at a time over that task's own rows instead."""

from __future__ import annotations

import torch


def multi_lora_reference(x, a, b, task_ids, scale: float = 1.0):
    """x: (N, din); a: (T, din, r); b: (T, r, dout); task_ids: (N,) int.

    Returns (N, dout): y[n] = scale * x[n] @ a[t[n]] @ b[t[n]]; rows whose
    id is outside [0, T) get zeros."""
    N = x.shape[0]
    T, dout = a.shape[0], b.shape[2]
    y = torch.zeros((N, dout), dtype=torch.float32, device=x.device)
    for t in range(T):
        rows = (task_ids == t).nonzero()[:, 0]
        if rows.numel():
            h = x[rows].float() @ a[t].float()
            y[rows] = h @ b[t].float()
    return (scale * y).to(x.dtype)
