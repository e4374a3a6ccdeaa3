"""Split-KV decode over the model axis (``repro.models.smdec``' twin).

The contiguous cache of a sharded member under ``decode_impl="shardmap"``
holds a sequence shard per model rank: rank j keeps positions
``[j * S_loc, (j + 1) * S_loc)`` of every KV head (of the MLA latents).
Each decode step, every rank

  1. writes the new token into its local shard only if the position falls
     in its range (a 1-token local write),
  2. computes attention over its local rows with global masking,
  3. combines across ranks with online-softmax statistics: the global max
     by an all-reduce MAX, then all-reduce SUMs of the rescaled ``l`` and
     ``acc`` — a few KB per layer instead of gathering the cache.

Where the reference's ``shard_map`` takes the global arrays and a scalar
``pos``, these take the rank's local shard (the port keeps the cache
local) and ``pos`` a scalar or a (B,) vector of per-row positions (the
fleet's contiguous rows).  The batch is whole on every rank.  With no
rank mesh installed (``sharding.ctx``) they return None and the caller
takes the plain path, as the reference does without a mesh.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.ctx import current_mesh

NEG_INF = -1e30


def _mesh_ok():
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return None
    return mesh


def _local_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 s_loc: int, j: int) -> None:
    """1-token conditional write of ``new`` (B, 1, ...) into the local
    sequence shard ``cache`` (B, S_loc, ...), IN PLACE."""
    lp = pos.long() - j * s_loc
    in_range = (lp >= 0) & (lp < s_loc)
    lp_c = lp.clamp(0, s_loc - 1)
    val = new[:, 0].to(cache.dtype)
    tail = (1,) * (val.dim() - 1)
    if lp.dim() == 0:
        old = cache[:, lp_c]
        cache[:, lp_c] = torch.where(in_range, val, old)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    old = cache[rows, lp_c]
    cache[rows, lp_c] = torch.where(in_range.reshape((-1,) + tail), val, old)


def _mask(pos: torch.Tensor, s_loc: int, j: int, dev) -> torch.Tensor:
    """(S_loc,) for a scalar ``pos``, (B, S_loc) for per-row positions."""
    ik = j * s_loc + torch.arange(s_loc, device=dev)
    if pos.dim() == 0:
        return ik < pos + 1
    return ik[None, :] < pos.long()[:, None] + 1


def gqa_decode_sm(cfg: ModelConfig, q, k_new, v_new, kc, vc, pos):
    """q: (B,1,Hq,hd); k_new/v_new: (B,1,Hkv,hd); kc/vc: the local shard
    (B,S_loc,Hkv,hd).  Returns (out (B,1,Hq,hd), kc, vc) with the caches
    written in place, or None without a mesh."""
    mesh = _mesh_ok()
    if mesh is None:
        return None
    B, _, Hq, hd = q.shape
    s_loc, Hkv = kc.shape[1], kc.shape[2]
    G = Hq // Hkv
    j = mesh.coords["model"]
    scale = 1.0 / math.sqrt(hd)
    _local_write(kc, k_new, pos, s_loc, j)
    _local_write(vc, v_new, pos, s_loc, j)
    qg = q.reshape(B, Hkv, G, hd).float()
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, kc.float()) * scale
    mask = _mask(pos, s_loc, j, q.device)
    mask = mask[None, None, None] if mask.dim() == 1 else \
        mask[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m_g = mesh.all_reduce(logits.amax(-1), "model", op="max")
    p = torch.exp(logits - m_g[..., None])
    p = torch.where(mask, p, 0.0)
    l_g = mesh.all_reduce(p.sum(-1), "model")
    acc = torch.einsum("bhgk,bkhd->bhgd", p, vc.float())
    acc = mesh.all_reduce(acc, "model")
    out = acc / torch.clamp(l_g, min=1e-30)[..., None]
    return out.reshape(B, 1, Hq, hd).to(q.dtype), kc, vc


def mla_decode_sm(cfg: ModelConfig, q_lat, q_rope, ckv_new, krope_new,
                  ckv, krope, pos):
    """Absorbed-MLA split-KV decode.

    q_lat: (B,1,H,r) (q_nope absorbed through ``wk_b``); q_rope:
    (B,1,H,rh); ckv_new: (B,1,r); krope_new: (B,1,rh); ``ckv`` (B,S_loc,r)
    / ``krope`` (B,S_loc,rh) the local shards.  Returns (ctx latent
    (B,1,H,r), ckv, krope) with the caches written in place, or None
    without a mesh."""
    mesh = _mesh_ok()
    if mesh is None:
        return None
    s_loc = ckv.shape[1]
    j = mesh.coords["model"]
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    _local_write(ckv, ckv_new, pos, s_loc, j)
    _local_write(krope, krope_new, pos, s_loc, j)
    ql = q_lat[:, 0].float()                     # (B,H,r)
    qr = q_rope[:, 0].float()                    # (B,H,rh)
    s = (torch.einsum("bhr,bkr->bhk", ql, ckv.float())
         + torch.einsum("bhr,bkr->bhk", qr, krope.float())) * scale
    mask = _mask(pos, s_loc, j, ql.device)
    mask = mask[None, None] if mask.dim() == 1 else mask[:, None, :]
    s = torch.where(mask, s, NEG_INF)
    m_g = mesh.all_reduce(s.amax(-1), "model", op="max")
    p = torch.exp(s - m_g[..., None])
    p = torch.where(mask, p, 0.0)
    l_g = mesh.all_reduce(p.sum(-1), "model")
    ctx = torch.einsum("bhk,bkr->bhr", p, ckv.float())
    ctx = mesh.all_reduce(ctx, "model")
    ctx = ctx / torch.clamp(l_g, min=1e-30)[..., None]
    return ctx[:, None].to(q_lat.dtype), ckv, krope
