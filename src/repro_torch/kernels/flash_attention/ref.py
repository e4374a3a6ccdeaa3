"""Float32 oracle for the flash-attention kernel (GQA + causal + sliding
window + length masking), the port of ``repro.kernels.flash_attention.ref``.
O(S^2) memory — test-scale only."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal: bool = False,
                        sliding_window: int = 0,
                        kv_len: Optional[torch.Tensor] = None,
                        q_offset: int = 0):
    """q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd); Hq = G * Hkv.

    sliding_window w: position i attends to (i-w, i].  kv_len masks the
    valid KV prefix (decode against a partially-filled cache)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(hd)

    iq = torch.arange(Sq, device=q.device)[:, None] + q_offset
    ik = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ik <= iq
    if sliding_window > 0:
        mask &= ik > iq - sliding_window
    mask = mask[None].expand(B, Sq, Skv)
    if kv_len is not None:
        mask = mask & (ik[None] < kv_len.reshape(B, 1, 1).to(q.device))
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)
