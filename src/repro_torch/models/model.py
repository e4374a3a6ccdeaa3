"""Fleet-model stack of the port: init / paged prefill / decode for the
attention + dense-FFN architectures (``repro.models.model``'s twin).

The reference scans each layer group with ``lax.scan``; here the model is
an ``nn.Module`` whose ``blocks`` ``ModuleList`` unrolls every group's
repeats, and the stack is a Python loop.  Parameters keep the reference's
names and (d_in, d_out) layout, so ``bridge.params_from_jax`` maps one onto
the other leaf for leaf.

The serving cache is paged: ``init_paged_cache`` returns the reference's
pytree as a dict of tensors (``cache["g{i}"]["b{j}"]["k"]`` is
``(repeats, num_blocks, block_tokens, Hkv, hd)``).  Where the reference
donates the cache to a jitted step and gets a new one back, the port
writes the pools IN PLACE and returns the same dict.

Contiguous caches, cross-attention, MLA, MoE, SSM blocks and speculative
``verify`` are later slices: configs that need them raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import paged_flash_decode
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

ATTN_IMPLS = ("einsum", "pallas")
DECODE_IMPLS = ("xla", "flash_paged")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    for g in cfg.groups:
        for s in g.period:
            if s.mixer != "attn" or s.ffn != "dense":
                raise NotImplementedError(
                    f"{cfg.name}: block {s.mixer}/{s.ffn} is not ported yet "
                    f"(the port serves attn + dense FFN)")
    if cfg.encoder_groups or cfg.cross_ctx_len:
        raise NotImplementedError(f"{cfg.name}: encoder / cross-attention "
                                  f"is not ported yet")
    if cfg.attn_impl not in ATTN_IMPLS:
        raise NotImplementedError(f"attn_impl {cfg.attn_impl!r} is not "
                                  f"ported; the port has {ATTN_IMPLS}")
    if cfg.decode_impl not in DECODE_IMPLS:
        raise NotImplementedError(f"decode_impl {cfg.decode_impl!r} is not "
                                  f"ported; the port has {DECODE_IMPLS}")


# ===========================================================================
# parameters
# ===========================================================================

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One attn + dense-FFN block; keys mirror the reference's
    ``{"norm1", "attn": {...}, "norm2", "ffn": {...}}``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.norm1 = _param((d,), dtype, device)
        attn = {"wq": _param((d, H * hd), dtype, device),
                "wk": _param((d, Hkv * hd), dtype, device),
                "wv": _param((d, Hkv * hd), dtype, device),
                "wo": _param((H * hd, d), dtype, device)}
        if cfg.qk_norm:
            attn["q_norm"] = _param((hd,), dtype, device)
            attn["k_norm"] = _param((hd,), dtype, device)
        self.attn = nn.ParameterDict(attn)
        self.norm2 = _param((d,), dtype, device)
        self.ffn = nn.ParameterDict({
            "w_gate": _param((d, cfg.d_ff), dtype, device),
            "w_up": _param((d, cfg.d_ff), dtype, device),
            "w_down": _param((cfg.d_ff, d), dtype, device)})


class Model(nn.Module):
    """Embedding, the unrolled block stack, final norm (tied or separate
    LM head)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda"):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.d_model), dtype, dev)
        self.final_norm = _param((cfg.d_model,), dtype, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_size), dtype, dev)
        self.blocks = nn.ModuleList(
            Block(cfg, dtype, dev)
            for g in cfg.groups for _ in range(g.repeats * len(g.period)))


def _dense_init(p: nn.Parameter, gen: torch.Generator, scale=None):
    fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(p.shape), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    p.copy_(w.to(p.dtype))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Model:
    """Random weights with the reference's scheme (normal / sqrt(fan_in),
    embedding 0.02, norms 1), drawn from ``generator`` — the draws differ
    from ``jax.random``'s; tests that compare the packages bridge the
    reference's weights instead (``bridge.params_from_jax``)."""
    model = Model(cfg, device)
    _dense_init(model.embed, generator, scale=0.02)
    model.final_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        _dense_init(model.lm_head, generator)
    for blk in model.blocks:
        blk.norm1.fill_(1.0)
        blk.norm2.fill_(1.0)
        for name, p in blk.attn.items():
            if name.endswith("_norm"):
                p.fill_(1.0)
            else:
                _dense_init(p, generator)
        for p in blk.ffn.values():
            _dense_init(p, generator)
    return model


# ===========================================================================
# paged (block) KV cache
# ===========================================================================

def paged_supported(cfg: ModelConfig) -> bool:
    """Paged KV works for pure attention/MLA stacks: recurrent (SSM)
    state is per-slot, not per-position, and cross-attention context is
    per-request — neither pages."""
    return (not cfg.cross_ctx_len and not cfg.encoder_groups and
            all(s.mixer in ("attn", "mla")
                for g in cfg.groups for s in g.period))


def init_paged_cache(cfg: ModelConfig, slots: int, max_seq: int,
                     num_blocks: int, block_tokens: int,
                     device: DeviceLike = "cuda") -> dict:
    """Paged serving cache: KV leaves are physical block pools
    ``(repeats, num_blocks, block_tokens, Hkv, hd)`` shared by every slot;
    ``cache["tbl"]`` (slots, max_seq // block_tokens) int32 maps each
    slot's logical blocks to physical ones (0 = the reserved trash
    block); ``cache["pos"]`` (slots,) int32 holds each slot's depth."""
    check_supported(cfg)
    if max_seq % block_tokens:
        raise ValueError("max_seq must be a multiple of block_tokens")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    cache = {"pos": torch.zeros((slots,), dtype=torch.int32, device=dev),
             "tbl": torch.zeros((slots, max_seq // block_tokens),
                                dtype=torch.int32, device=dev)}
    for i, g in enumerate(cfg.groups):
        kv = (g.repeats, num_blocks, block_tokens, cfg.n_kv_heads,
              cfg.head_dim)
        cache[f"g{i}"] = {
            f"b{j}": {"k": torch.zeros(kv, dtype=dtype, device=dev),
                      "v": torch.zeros(kv, dtype=dtype, device=dev)}
            for j in range(len(g.period))}
    return cache


def _paged_write(pool: Tensor, val: Tensor, tbl: Tensor, pos) -> None:
    """Scatter ``val`` (B, T, ...) into the physical block pool
    ``(num_blocks, block_tokens, ...)`` at each row's absolute positions
    ``pos .. pos+T`` through its block-table row ``tbl`` (B, max_blocks).
    Positions past the table (or rows whose table maps to 0) land in the
    reserved trash block 0.  Writes IN PLACE (the reference returns a new
    pool from a donated one)."""
    nb, blk = pool.shape[:2]
    B, T = val.shape[:2]
    pos = torch.as_tensor(pos, device=pool.device).long().expand(B)
    positions = pos[:, None] + torch.arange(T, device=pool.device)[None, :]
    bi = positions // blk
    phys = torch.gather(tbl.long(), 1, bi.clamp(0, tbl.shape[1] - 1))
    phys = torch.where(bi >= tbl.shape[1], 0, phys)
    idx = phys * blk + positions % blk                          # (B, T) flat
    flat = pool.view((nb * blk,) + tuple(pool.shape[2:]))
    flat[idx.reshape(-1)] = val.to(pool.dtype).reshape(
        (B * T,) + tuple(val.shape[2:]))


def _paged_view(pool: Tensor, tbl: Tensor) -> Tensor:
    """Gather each row's contiguous-layout KV view (B, max_blocks*blk, ...)
    from the physical pool through its block table (the plain path)."""
    nb, blk = pool.shape[:2]
    flat = pool.view((nb * blk,) + tuple(pool.shape[2:]))
    idx = tbl.long()[:, :, None] * blk + \
        torch.arange(blk, device=pool.device)[None, None]
    return flat[idx.reshape(tbl.shape[0], -1)]


# ===========================================================================
# block application
# ===========================================================================

def _sdpa_impl(cfg: ModelConfig, q, k, v, *, causal: bool,
               sliding_window: int):
    """Fresh-prefill attention: the CUDA flash kernel under ``attn_impl=
    "pallas"`` (its plain version on the CPU), else ``layers.sdpa``."""
    if cfg.attn_impl == "pallas" and q.shape[1] > 1:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               None, causal=causal,
                               sliding_window=sliding_window)
    return L.sdpa(q, k, v, causal=causal, sliding_window=sliding_window)


def _self_attn(cfg, p: Block, h, rope, mode, bcache, pos, tbl,
               paged_fresh=False):
    """Paged self-attention in prefill or decode mode.  ``bcache`` is
    ``{"k": pool, "v": pool}`` for this layer; pools are written in place.

    ``paged_fresh`` marks a from-scratch prefill (no cached prefix):
    attention then runs on the local K/V — right-padded rows rely on
    causality alone, so no ``lens`` reaches the kernel — and only the
    writes go through the table.  A suffix prefill (``pos`` = per-row
    start offsets) attends over the gathered view so cached prefix blocks
    are read, never recomputed."""
    x = L.rms_norm(h, p.norm1, cfg.norm_eps)
    q, k, v = L.attn_qkv(p.attn, cfg, x, x, rope, rope)
    kpool, vpool = bcache["k"], bcache["v"]
    _paged_write(kpool, k, tbl, pos)
    _paged_write(vpool, v, tbl, pos)
    if mode == "prefill":
        if paged_fresh:
            out = _sdpa_impl(cfg, q, k, v, causal=True,
                             sliding_window=cfg.sliding_window)
        else:
            out = L.sdpa(q, _paged_view(kpool, tbl), _paged_view(vpool, tbl),
                         causal=True, sliding_window=cfg.sliding_window,
                         q_offset=pos)
    else:  # decode: pos (B,) per-row positions
        kv_len = (pos + 1).to(torch.int32)
        if cfg.decode_impl == "flash_paged":
            out = paged_flash_decode(q[:, 0].contiguous(), kpool, vpool,
                                     tbl, kv_len)[:, None]
        else:
            out = L.sdpa(q, _paged_view(kpool, tbl), _paged_view(vpool, tbl),
                         causal=False, q_offset=pos, kv_len=kv_len,
                         sliding_window=0)
    return h + L.attn_out(p.attn, out)


def _apply_block(cfg: ModelConfig, p: Block, h: Tensor, *, rope, mode: str,
                 bcache, pos, tbl, paged_fresh=False) -> Tensor:
    h = _self_attn(cfg, p, h, rope, mode, bcache, pos, tbl,
                   paged_fresh=paged_fresh)
    x = L.rms_norm(h, p.norm2, cfg.norm_eps)
    return h + L.ffn_apply(p.ffn, x)


def _run_groups(cfg: ModelConfig, params: Model, h: Tensor, *, rope, mode,
                cache, pos, tbl, paged_fresh=False) -> Tensor:
    """The stack, unrolled: group i, repeat r, period slot j is block
    ``n``; its KV pools are ``cache["g{i}"]["b{j}"][leaf][r]`` (views,
    written in place)."""
    n = 0
    for i, g in enumerate(cfg.groups):
        gc = cache[f"g{i}"]
        for r in range(g.repeats):
            for j in range(len(g.period)):
                bc = {leaf: pool[r] for leaf, pool in gc[f"b{j}"].items()}
                h = _apply_block(cfg, params.blocks[n], h, rope=rope,
                                 mode=mode, bcache=bc, pos=pos, tbl=tbl,
                                 paged_fresh=paged_fresh)
                n += 1
    return h


def _logits(cfg: ModelConfig, params: Model, h: Tensor) -> Tensor:
    h = L.rms_norm(h, params.final_norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params.embed.T
    return h @ params.lm_head


# ===========================================================================
# public API
# ===========================================================================

@torch.no_grad()
def prefill(cfg: ModelConfig, params: Model, tokens: Tensor, cache: dict,
            *, lens: Optional[Tensor] = None, start: Optional[Tensor] = None,
            tbl: Optional[Tensor] = None,
            paged_fresh: bool = False) -> Tuple[Tensor, dict]:
    """Paged prefill: returns (last-token logits (B,V), cache).

    ``tbl`` (B, max_blocks) routes each row's KV writes into the shared
    block pool.  ``lens`` (B,) gives each row's real prompt length when
    rows are right-padded: logits are taken at ``lens - 1``.  ``start``
    (B,) is the absolute position of ``tokens[:, 0]`` — for a prefix-cache
    hit only the unmatched suffix is passed in and attention reads the
    cached prefix blocks through the table (``paged_fresh=True`` marks a
    no-prefix prefill).  The reference's ``cross_ctx`` and ``moe_impl``
    arguments arrive with the slices that port cross-attention and MoE."""
    check_supported(cfg)
    if tbl is None:
        raise NotImplementedError("the contiguous cache is not ported yet: "
                                  "pass a block table (paged prefill)")
    dev = tokens.device
    B, Sq = tokens.shape
    h = params.embed[tokens.long()]
    pos = (torch.zeros((B,), dtype=torch.long, device=dev) if start is None
           else torch.as_tensor(start, device=dev).long())
    positions = pos[:, None] + torch.arange(Sq, device=dev)[None, :]
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    h = _run_groups(cfg, params, h, rope=rope, mode="prefill", cache=cache,
                    pos=pos, tbl=tbl, paged_fresh=paged_fresh)
    if lens is None:
        h_last = h[:, -1:, :]
    else:
        idx = torch.as_tensor(lens, device=dev).long() - 1
        h_last = torch.gather(h, 1, idx[:, None, None].expand(B, 1, h.shape[2]))
    return _logits(cfg, params, h_last)[:, 0, :], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Model, tokens: Tensor,
                cache: dict) -> Tuple[Tensor, dict]:
    """One decode step: tokens (B,1) + paged cache -> (logits (B,V), cache).

    ``cache["pos"]`` (B,) holds per-row positions: each row writes, rotates
    and attends at its own depth; the KV pools are written in place and
    ``cache["pos"]`` comes back advanced by one."""
    check_supported(cfg)
    if "tbl" not in cache:
        raise NotImplementedError("the contiguous cache is not ported yet")
    pos = cache["pos"]
    tbl = cache["tbl"]
    h = params.embed[tokens.long()]
    rope = L.rope_tables(pos.long()[:, None], cfg.head_dim, cfg.rope_theta)
    h = _run_groups(cfg, params, h, rope=rope, mode="decode", cache=cache,
                    pos=pos.long(), tbl=tbl)
    cache["pos"] = pos + 1
    return _logits(cfg, params, h)[:, 0, :], cache
