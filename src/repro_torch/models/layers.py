"""Layer primitives of the port (attention, KV-blocked attention, MLA and
FFN subset of ``repro.models.layers``).

Plain functions on tensors.  Parameters come in as mappings
(``nn.ParameterDict``) keyed like the reference's pytree.  Matmuls run in
the config dtype; norms, rope and softmax run in float32, as in the
reference, and each function keeps the reference's op order so the two
packages agree to rounding.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
IntOrTensor = Union[int, Tensor]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_tables(positions: Tensor, dim: int, theta: float
                ) -> Tuple[Tensor, Tensor]:
    """positions: int (...,) -> cos/sin tables (..., dim//2) in fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=positions.device) / dim))
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd//2) or (B, S, hd//2)."""
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    if cos.dim() == 2:  # (S, hd//2) -> broadcast over batch, heads
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:               # (B, S, hd//2)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------

def _is_vec(x) -> bool:
    return isinstance(x, Tensor) and x.dim() > 0


def _attn_mask(B: int, Sq: int, Skv: int, *, causal: bool,
               sliding_window: int = 0, q_offset: IntOrTensor = 0,
               kv_len: Optional[IntOrTensor] = None,
               device: Optional[torch.device] = None):
    """Attention mask shared by ``sdpa`` and the plain kernel versions.

    ``q_offset`` / ``kv_len`` may be ints (uniform across the batch) or
    (B,) tensors (per-row positions, continuous-batching decode).  Returns
    ``(mask, per_row)``: ``mask`` is (Sq, Skv) when ``per_row`` is False
    and (B, Sq, Skv) when True — the caller inserts its own head axes.
    """
    per_row = _is_vec(q_offset) or (kv_len is not None and _is_vec(kv_len))
    ar_q = torch.arange(Sq, device=device)
    ar_k = torch.arange(Skv, device=device)
    if per_row:
        off = torch.as_tensor(q_offset, device=device).long().expand(B)
        iq = off[:, None, None] + ar_q[None, :, None]            # (B,Sq,1)
        ik = ar_k[None, None, :]                                 # (1,1,Skv)
        mask = torch.ones((B, Sq, Skv), dtype=torch.bool, device=device)
    else:
        iq = ar_q[:, None] + int(q_offset)                       # (Sq, 1)
        ik = ar_k[None, :]                                       # (1, Skv)
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= ik <= iq
    if sliding_window > 0:
        mask &= ik > iq - sliding_window
    if kv_len is not None:
        if per_row:
            kl = torch.as_tensor(kv_len, device=device).long().expand(B)
            mask &= ik < kl[:, None, None]
        else:
            mask &= ik < int(kv_len)
    return mask, per_row


def sdpa_blocked(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                 sliding_window: int = 0, q_offset: int = 0,
                 kv_len: Optional[int] = None, block: int = 512) -> Tensor:
    """Flash-form attention in plain tensor ops: a loop over KV blocks of
    ``block`` keys with online softmax (float32 running max ``m``, sum
    ``l`` and accumulator ``acc``), the reference's op order.  Never
    materialises (Sq, Skv) probabilities.  When ``Skv % block`` is nonzero
    it is ``sdpa``.  ``q_offset`` and ``kv_len`` are uniform over the
    batch (ints)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if Skv % block != 0:
        return sdpa(q, k, v, causal=causal, sliding_window=sliding_window,
                    q_offset=q_offset, kv_len=kv_len)
    nb = Skv // block
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    iq = torch.arange(Sq, device=dev) + int(q_offset)            # (Sq,)
    hv = v.shape[-1]
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, hv), dtype=torch.float32, device=dev)
    for bi in range(nb):
        kc = k[:, bi * block:(bi + 1) * block]
        vc = v[:, bi * block:(bi + 1) * block]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.float()) * scale
        ik = bi * block + torch.arange(block, device=dev)         # (block,)
        mask = torch.ones((Sq, block), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (ik[None, :] <= iq[:, None])
        if sliding_window > 0:
            mask = mask & (ik[None, :] > iq[:, None] - sliding_window)
        if kv_len is not None:
            mask = mask & (ik[None, :] < int(kv_len))
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vc.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hv).to(q.dtype)


def sdpa(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
         sliding_window: int = 0, q_offset: IntOrTensor = 0,
         kv_len: Optional[IntOrTensor] = None,
         logit_dtype: torch.dtype = torch.float32) -> Tensor:
    """Grouped-query attention, the reference's op order.

    q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd); Hq = G * Hkv.  Logits are
    taken in ``logit_dtype`` (float32: bf16 inputs are widened exactly, so
    this is the reference's ``preferred_element_type``), masked with
    ``NEG_INF``, soft-maxed in float32, and the probabilities are cast to
    ``v.dtype`` before the PV product.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)

    qg = q.reshape(B, Sq, Hkv, G, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(logit_dtype),
                          k.to(logit_dtype)) * scale

    mask, per_row = _attn_mask(B, Sq, Skv, causal=causal,
                               sliding_window=sliding_window,
                               q_offset=q_offset, kv_len=kv_len,
                               device=q.device)
    mask = mask[:, None, None] if per_row else mask[None, None, None]
    logits = torch.where(mask, logits, NEG_INF)

    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, v.shape[-1])


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def attn_qkv(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
             kv_x: Tensor, rope: Optional[Tuple[Tensor, Tensor]],
             kv_rope: Optional[Tuple[Tensor, Tensor]]):
    B, Sq, d = x.shape
    Skv = kv_x.shape[1]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, Sq, H, hd)
    k = (kv_x @ p["wk"]).reshape(B, Skv, Hkv, hd)
    v = (kv_x @ p["wv"]).reshape(B, Skv, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope is not None:
        q = apply_rope(q, *rope)
    if kv_rope is not None:
        k = apply_rope(k, *kv_rope)
    return q, k, v


def attn_out(p: Mapping[str, Tensor], out: Tensor) -> Tensor:
    B, S, H, hd = out.shape
    return out.reshape(B, S, H * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_q(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor, rope):
    B, S, _ = x.shape
    H, nh, rh = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, H, nh + rh)
    q_nope, q_rope = q[..., :nh], q[..., nh:]
    return q_nope, apply_rope(q_rope, *rope)


def mla_kv_latent(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor, rope):
    """Compressed KV: returns (c_kv (B,S,r), k_rope (B,S,rh)) — the cache."""
    kv = x @ p["wkv_a"]
    c_kv = rms_norm(kv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = kv[..., cfg.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], *rope)[:, :, 0, :]
    return c_kv, k_rope


def mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)


def mla_latent_core(q_lat: Tensor, q_rope: Tensor, c_kv: Tensor,
                    k_rope: Tensor, *, scale: float, causal: bool,
                    q_offset: IntOrTensor = 0,
                    kv_len: Optional[IntOrTensor] = None) -> Tensor:
    """Latent attention context, the reference's op order: float32 scores
    ``(q_lat·c_kv + q_rope·k_rope) * scale``, the ``NEG_INF`` mask, a
    float32 softmax, probabilities cast to ``c_kv.dtype``, ``ctx =
    probs·c_kv``.

    q_lat: (B,Sq,H,r); q_rope: (B,Sq,H,rh); c_kv: (B,Skv,r); k_rope:
    (B,Skv,rh).  Returns ctx (B,Sq,H,r).  ``mla_attention`` and the plain
    version of the paged MLA decode kernel both call it."""
    B, Sq = q_lat.shape[:2]
    Skv = c_kv.shape[1]
    s_lat = torch.einsum("bqhr,bkr->bhqk", q_lat.float(), c_kv.float())
    s_rope = torch.einsum("bqhr,bkr->bhqk", q_rope.float(), k_rope.float())
    logits = (s_lat + s_rope) * scale
    mask, per_row = _attn_mask(B, Sq, Skv, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, device=q_lat.device)
    mask = mask[:, None] if per_row else mask[None, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(c_kv.dtype)
    return torch.einsum("bhqk,bkr->bqhr", probs, c_kv)


def mla_absorb_q(p: Mapping[str, Tensor], q_nope: Tensor) -> Tensor:
    """q_nope (B,Sq,H,nh) -> latent queries q_nope·Wk_b (B,Sq,H,r)."""
    return torch.einsum("bqhn,hrn->bqhr", q_nope, p["wk_b"])


def mla_out(p: Mapping[str, Tensor], cfg: ModelConfig, ctx: Tensor) -> Tensor:
    """Latent context (B,Sq,H,r) -> ctx·Wv_b, then the output projection."""
    B, Sq, H, _ = ctx.shape
    out = torch.einsum("bqhr,hrv->bqhv", ctx, p["wv_b"])
    return out.reshape(B, Sq, H * cfg.v_head_dim) @ p["wo"]


def mla_attention(p: Mapping[str, Tensor], cfg: ModelConfig, q_nope, q_rope,
                  c_kv, k_rope, *, causal: bool, q_offset: IntOrTensor = 0,
                  kv_len: Optional[IntOrTensor] = None) -> Tensor:
    """Absorbed-latent attention.

    q_nope: (B,Sq,H,nh); q_rope: (B,Sq,H,rh); c_kv: (B,Skv,r); k_rope:
    (B,Skv,rh).  score[h] = (q_nope[h] @ Wk_b[h]) . c_kv + q_rope . k_rope;
    out[h] = (attn @ c_kv) @ Wv_b[h], then ``wo``."""
    ctx = mla_latent_core(mla_absorb_q(p, q_nope), q_rope, c_kv, k_rope,
                          scale=mla_scale(cfg), causal=causal,
                          q_offset=q_offset, kv_len=kv_len)
    return mla_out(p, cfg, ctx)


# ---------------------------------------------------------------------------
# dense SwiGLU FFN
# ---------------------------------------------------------------------------

def ffn_apply(p: Mapping[str, Tensor], x: Tensor) -> Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
