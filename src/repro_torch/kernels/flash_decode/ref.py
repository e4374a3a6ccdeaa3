"""Float32 oracles for decode attention over a KV cache (GQA and
absorbed-latent MLA), the port of ``repro.kernels.flash_decode.ref``, plus
oracles for the W-wide speculative verify (the reference holds its verify
kernels against W decode steps instead)."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_reference(q, k, v, kv_len):
    """q: (B, Hq, hd); k/v: (B, Skv, Hkv, hd); kv_len: (B,) valid prefix.

    Returns (B, Hq, hd)."""
    B, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, hd)
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    logits = logits / math.sqrt(hd)
    mask = torch.arange(Skv, device=q.device)[None] < kv_len.to(q.device)[:, None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v.float())
    return out.reshape(B, Hq, hd).to(q.dtype)


def _gather(pool, tbl):
    nb, blk = pool.shape[:2]
    flat = pool.reshape((nb * blk,) + tuple(pool.shape[2:]))
    idx = tbl.long()[:, :, None] * blk + torch.arange(blk, device=pool.device)
    return flat[idx.reshape(tbl.shape[0], -1)]


def paged_decode_reference(q, kpool, vpool, tbl, kv_len):
    """Oracle for block-table decode: gather per-row KV views from the
    physical pool (kpool/vpool: (num_blocks, block_tokens, Hkv, hd);
    tbl: (B, max_blocks) int), then standard masked decode attention."""
    return decode_reference(q, _gather(kpool, tbl), _gather(vpool, tbl),
                            kv_len)


def paged_mla_decode_reference(q_lat, q_rope, ckv_pool, krope_pool, tbl,
                               kv_len, *, scale):
    """Oracle for absorbed-latent MLA block-table decode.

    q_lat: (B, H, r); q_rope: (B, H, rh); pools: (num_blocks, blk, r|rh);
    returns the latent context ctx = softmax(scores) @ ckv, (B, H, r)."""
    ckv = _gather(ckv_pool, tbl).float()                 # (B, S, r)
    kr = _gather(krope_pool, tbl).float()                # (B, S, rh)
    s = torch.einsum("bhr,bkr->bhk", q_lat.float(), ckv)
    s = s + torch.einsum("bhr,bkr->bhk", q_rope.float(), kr)
    s = s * scale
    mask = torch.arange(ckv.shape[1], device=ckv.device)[None] < \
        kv_len.to(ckv.device)[:, None]                   # (B, S)
    s = torch.where(mask[:, None], s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkr->bhr", probs, ckv).to(q_lat.dtype)


def _verify_mask(kv_len, W: int, S: int, device):
    """(B, W, S): position t sees keys < kv_len - W + t + 1."""
    frontier = kv_len.long().to(device)[:, None] - W + 1 + \
        torch.arange(W, device=device)[None]
    return torch.arange(S, device=device)[None, None] < frontier[:, :, None]


def paged_verify_reference(q, kpool, vpool, tbl, kv_len):
    """Oracle for block-table speculative verify: q (B, W, Hq, hd) against
    the gathered views; position t masks to its own frontier
    ``kv_len - W + t + 1`` (``kv_len`` counts the W new entries).  Returns
    (B, W, Hq, hd)."""
    B, W, Hq, hd = q.shape
    k = _gather(kpool, tbl).float()
    v = _gather(vpool, tbl).float()
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, W, Hkv, G, hd)
    logits = torch.einsum("bwhgd,bkhd->bhgwk", qf, k) / math.sqrt(hd)
    mask = _verify_mask(kv_len, W, Skv, q.device)[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgwk,bkhd->bwhgd", probs, v)
    return out.reshape(B, W, Hq, hd).to(q.dtype)


def paged_mla_verify_reference(q_lat, q_rope, ckv_pool, krope_pool, tbl,
                               kv_len, *, scale):
    """Oracle for absorbed-latent MLA speculative verify: q_lat (B, W, H,
    r), q_rope (B, W, H, rh); position t masks to ``kv_len - W + t + 1``.
    Returns the latent context (B, W, H, r)."""
    W = q_lat.shape[1]
    ckv = _gather(ckv_pool, tbl).float()                 # (B, S, r)
    kr = _gather(krope_pool, tbl).float()                # (B, S, rh)
    s = torch.einsum("bwhr,bkr->bwhk", q_lat.float(), ckv)
    s = s + torch.einsum("bwhr,bkr->bwhk", q_rope.float(), kr)
    s = s * scale
    mask = _verify_mask(kv_len, W, ckv.shape[1], ckv.device)[:, :, None]
    s = torch.where(mask, s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    return torch.einsum("bwhk,bkr->bwhr", probs, ckv).to(q_lat.dtype)
