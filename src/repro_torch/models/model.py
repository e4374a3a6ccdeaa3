"""Model stack of the port: init / training forward and loss / prefill /
decode / verify for every mixer of the configs — attention (causal,
bidirectional, cross), MLA, Mamba, mLSTM and sLSTM — with dense, MoE or
no FFN, and the whisper encoder (``repro.models.model``'s twin).

Modes
  full     training forward (``forward``, ``loss_fn``), no cache
  prefill  full-sequence forward that also writes the serving cache
  decode   one-token step against the cache
  verify   W tokens per row against the paged cache (speculative decoding)

The reference scans each layer group with ``lax.scan``; here the model is
an ``nn.Module`` whose ``blocks`` ``ModuleList`` unrolls every group's
repeats (the encoder's in ``enc_blocks``), and the stack is a Python loop.
Parameters keep the reference's names and (d_in, d_out) layout, so
``bridge.params_from_jax`` / ``params_to_jax`` map one onto the other leaf
for leaf.  They are made with ``requires_grad=False``: the serving entry
points run under ``torch.no_grad``, and training (``training.train_lib``)
turns gradients on for its step.  ``remat=True`` recomputes each group
period's activations in the backward pass
(``torch.utils.checkpoint``), the granularity of the reference's
``jax.checkpoint`` of its scan body.

Two serving caches, both the reference's pytree as a dict of tensors
stacked over each group's repeats:

* paged (``init_paged_cache``): KV leaves are physical block pools
  ``(repeats, num_blocks, block_tokens, Hkv, hd)`` (MLA: ``ckv``,
  ``krope``) shared by every slot through ``cache["tbl"]``;
* contiguous (``init_cache``): one slot row per batch index — attention
  ``k``/``v`` ``(repeats, B, max_seq, Hkv, hd)``, cross-attention
  ``ck``/``cv`` ``(repeats, B, cross_ctx_len, Hkv, hd)``, MLA latents,
  and the recurrent state of the SSM mixers.  Configs with SSM state or
  cross-attention context serve only from it (``paged_supported``).

Where the reference donates the cache to a jitted step and gets a new one
back, the port writes the cache tensors IN PLACE and returns the same
dict.  ``verify`` is the speculative-decoding forward over the paged
cache: W tokens per row through one wide pass, logits at every position,
each equal to a decode step's.

Sharded members (``mesh=`` a rank mesh of ``launch.mesh``, installed for
the serving steps with ``sharding.ctx.sharding_rules``): every parameter
is the rank's block under ``sharding.rules.param_specs`` (carrying
``_spec``); attention and FFN are tensor-parallel over ``"model"`` where
the rules split heads or ``d_ff`` (``layers.W`` / ``row_parallel_sum``),
MLA computes the whole query and latent and keeps its heads, the MoE is
expert-parallel (``moe.moe_ep``), and the embedding and LM head are
vocab-parallel (the logits come back as the rank's vocab shard;
``serve_lib.greedy`` reduces them).  Cache tensors are the rank's block
over ``"model"``: KV heads when they divide it, else a sequence shard,
which ``decode_impl="shardmap"`` always takes (``smdec``); paged pools
split heads, hold the one KV head of the rank's query heads (query heads
that split over KV heads that do not: ``kv_layout``), or stay whole; the
batch stays whole on every rank.  Mamba is channel-parallel (``ssm``:
the rank's channels of its leaves and of its state), the mLSTM and sLSTM
run whole on every rank (their state too), cross-attention splits heads
as self-attention does and keeps ``ck``/``cv`` whole (the rules' cache
spec: the rank's heads are all-gathered once, at prefill), and the
whisper encoder runs on every rank over the same frames.  Refused
(``check_shardable``): GQA members whose KV heads neither divide the
axis nor are a divisor of it, and MLA members whose heads and ``wo``
rows split differently; no registry member on the repo's meshes.

Training over ranks (``training.train_lib.build_train_step``): the batch
is split over ``"data"`` (``sharding.ctx.row_axes``), the collectives are
the mesh's differentiable ones (``layers.enter`` where a replicated value
enters a split branch), and ``loss_fn`` reduces the vocab shards and the
rows' sums to the reference's global mean.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import (paged_flash_decode,
                                                  paged_flash_decode_mla,
                                                  paged_flash_verify,
                                                  paged_flash_verify_mla)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import smdec
from repro_torch.models import ssm as S
from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig
from repro_torch.sharding import rules as R
from repro_torch.sharding.ctx import (capture, current_mesh, installed,
                                      row_axes)

Tensor = torch.Tensor

ATTN_IMPLS = ("einsum", "blocked", "pallas")
DECODE_IMPLS = ("xla", "flash_paged", "shardmap")


SSM_MIXERS = ("mamba", "mlstm", "slstm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for an attention lowering or decode
    path the port does not have; every one of the reference's is ported
    (``decode_impl="shardmap"`` is the split-KV decode of a sharded
    member's contiguous cache, the plain path without a mesh)."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise NotImplementedError(f"attn_impl {cfg.attn_impl!r} is not "
                                  f"ported; the port has {ATTN_IMPLS}")
    if cfg.decode_impl not in DECODE_IMPLS:
        raise NotImplementedError(f"decode_impl {cfg.decode_impl!r} is not "
                                  f"ported; the port has {DECODE_IMPLS}")


# ===========================================================================
# parameters
# ===========================================================================

def _device(device: DeviceLike) -> torch.device:
    """``resolve_device``, and ``"meta"`` for shapes without storage."""
    if str(device) == "meta":
        return torch.device("meta")
    return resolve_device(device)


def param_shapes(cfg: ModelConfig) -> dict:
    """The port's parameter names -> full shapes, without storage."""
    return {n: tuple(p.shape)
            for n, p in Model(cfg, "meta").named_parameters()}


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _mla_leaves(cfg: ModelConfig, dtype, device) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    nh, rh, vh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = _param((d, cfg.q_lora_rank), dtype, device)
        p["q_norm"] = _param((cfg.q_lora_rank,), dtype, device)
        p["wq_b"] = _param((cfg.q_lora_rank, H * (nh + rh)), dtype, device)
    else:
        p["wq"] = _param((d, H * (nh + rh)), dtype, device)
    p["wkv_a"] = _param((d, cfg.kv_lora_rank + rh), dtype, device)
    p["kv_norm"] = _param((cfg.kv_lora_rank,), dtype, device)
    # up-projections, stored head-major for the absorbed decode path
    p["wk_b"] = _param((H, cfg.kv_lora_rank, nh), dtype, device)
    p["wv_b"] = _param((H, cfg.kv_lora_rank, vh), dtype, device)
    p["wo"] = _param((H * vh, d), dtype, device)
    return p


def _moe_leaves(cfg: ModelConfig, dtype, device) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {"router": _param((d, E), torch.float32, device),   # float32 always
         "w_gate": _param((E, d, f), dtype, device),
         "w_up": _param((E, d, f), dtype, device),
         "w_down": _param((E, f, d), dtype, device)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["shared"] = nn.ParameterDict({
            "w_gate": _param((d, fs), dtype, device),
            "w_up": _param((d, fs), dtype, device),
            "w_down": _param((fs, d), dtype, device)})
    return p


def _ssm_dict(leaves: dict, device) -> nn.ParameterDict:
    """``ssm.ssm_leaves`` -> nested ``ParameterDict`` of empty leaves."""
    return nn.ParameterDict({
        k: (_ssm_dict(v, device) if isinstance(v, dict)
            else _param(v[0], v[1], device))
        for k, v in leaves.items()})


class Block(nn.Module):
    """One block built from its ``BlockSpec``; keys mirror the reference's
    ``{"norm1", "attn" | "mla" | "mamba" | "mlstm" | "slstm": {...},
    "norm2", "ffn" | "moe": {...}}`` (no ``norm2`` under ``ffn="none"``;
    self, bidirectional and cross-attention all hold ``attn``)."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, dtype, device):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.spec = spec
        self.norm1 = _param((d,), dtype, device)
        if spec.mixer == "mla":
            self.mla = nn.ParameterDict(_mla_leaves(cfg, dtype, device))
        elif spec.mixer in SSM_MIXERS:
            setattr(self, spec.mixer,
                    _ssm_dict(S.ssm_leaves(cfg, spec.mixer, dtype), device))
        else:
            attn = {"wq": _param((d, H * hd), dtype, device),
                    "wk": _param((d, Hkv * hd), dtype, device),
                    "wv": _param((d, Hkv * hd), dtype, device),
                    "wo": _param((H * hd, d), dtype, device)}
            if cfg.qk_norm:
                attn["q_norm"] = _param((hd,), dtype, device)
                attn["k_norm"] = _param((hd,), dtype, device)
            self.attn = nn.ParameterDict(attn)
        if spec.ffn != "none":
            self.norm2 = _param((d,), dtype, device)
        if spec.ffn == "moe":
            self.moe = nn.ParameterDict(_moe_leaves(cfg, dtype, device))
        elif spec.ffn == "dense":
            self.ffn = nn.ParameterDict({
                "w_gate": _param((d, cfg.d_ff), dtype, device),
                "w_up": _param((d, cfg.d_ff), dtype, device),
                "w_down": _param((cfg.d_ff, d), dtype, device)})


def _unrolled(cfg: ModelConfig, groups: Sequence[LayerGroup], dtype, dev):
    return nn.ModuleList(
        Block(cfg, spec, dtype, dev)
        for g in groups for _ in range(g.repeats) for spec in g.period)


def model_split(mesh) -> int:
    """Ranks of the mesh's ``"model"`` axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get("model", 1)


def check_shardable(cfg: ModelConfig, mesh) -> None:
    """Raise ``NotImplementedError`` for a member the port cannot shard
    over ``mesh``'s ``"model"`` ranks: query heads that divide the axis
    while the KV heads neither divide it nor are a divisor of it (a
    rank's query heads would straddle two KV heads), or MLA heads and
    ``wo``'s rows that split differently.  Every other member is served,
    SSM, cross-attention and encoder members included: query heads that
    split while the KV heads stay whole and divide the axis lie under one
    KV head a rank (``_rank_kv``)."""
    M_ = model_split(mesh)
    if M_ == 1:
        return
    mixers = {s.mixer for g in cfg.groups + cfg.encoder_groups
              for s in g.period}
    if "mla" in mixers and (cfg.n_heads % M_ == 0) != \
            (cfg.n_heads * cfg.v_head_dim % M_ == 0):
        raise NotImplementedError(
            f"{cfg.name}: MLA heads and wo's rows split differently over "
            f"model axis {M_}")
    if mixers & {"attn", "bidir_attn", "cross_attn"} \
            and cfg.n_heads % M_ == 0 \
            and cfg.n_kv_heads % M_ != 0 and M_ % cfg.n_kv_heads != 0:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_heads} query heads split over model axis "
            f"{M_} but {cfg.n_kv_heads} KV heads neither divide it nor "
            f"are a divisor of it")


class Model(nn.Module):
    """Embedding, the unrolled block stack, final norm (tied or separate
    LM head); an encoder-decoder config (whisper) adds the unrolled
    encoder ``enc_blocks`` and its ``enc_final_norm``.  With ``mesh`` (a
    rank mesh) every parameter is this rank's block, carrying its spec
    (``_spec``), full shape (``_full``) and slices (``_block``)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda",
                 mesh=None):
        super().__init__()
        check_supported(cfg)
        check_shardable(cfg, mesh)
        dev = _device(device)
        if mesh is not None:
            dev, local = torch.device("meta"), dev
        dtype = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.d_model), dtype, dev)
        self.final_norm = _param((cfg.d_model,), dtype, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_size), dtype, dev)
        self.blocks = _unrolled(cfg, cfg.groups, dtype, dev)
        if cfg.encoder_groups:
            self.enc_blocks = _unrolled(cfg, cfg.encoder_groups, dtype, dev)
            self.enc_final_norm = _param((cfg.d_model,), dtype, dev)
        if mesh is not None:
            self._to_blocks(mesh, local)

    def _to_blocks(self, mesh, dev):
        """Replace every (meta) parameter by this rank's block on ``dev``."""
        for name, p in list(self.named_parameters()):
            spec = R.param_spec(self.cfg, name, p.shape, mesh)
            local = _param(R.block_shape(p.shape, spec, mesh), p.dtype, dev)
            local._spec = spec
            local._full = tuple(p.shape)
            local._block = R.block_slices(p.shape, spec, mesh, mesh.coords)
            owner, _, leaf = name.rpartition(".")
            (self.get_submodule(owner) if owner else self) \
                .register_parameter(leaf, local)


def _dense_init(p: nn.Parameter, gen: torch.Generator, scale=None):
    """Draw the whole leaf (its ``_full`` shape) and keep the block ``p``
    holds."""
    full = getattr(p, "_full", tuple(p.shape))
    fan_in = full[-2] if len(full) >= 2 else full[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(full, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    block = getattr(p, "_block", None)
    p.copy_((w if block is None else w[block]).to(p.dtype))


def _ssm_init(cfg: ModelConfig, pd: nn.ParameterDict, leaves: dict,
              gen: torch.Generator):
    """Fill an SSM block's leaves by ``ssm.ssm_leaves``' rules."""
    for name, spec in leaves.items():
        p = pd[name]
        if isinstance(spec, dict):
            _ssm_init(cfg, p, spec, gen)
            continue
        rule = spec[2]
        if rule == "dense":
            _dense_init(p, gen)
        elif rule == "zeros":
            p.zero_()
        elif rule == "ones":
            p.fill_(1.0)
        elif isinstance(rule, tuple):
            _dense_init(p, gen, scale=rule[1])
        else:
            w, block = rule(cfg), getattr(p, "_block", None)
            p.copy_((w if block is None else w[block]).to(p.dtype))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda", mesh=None) -> Model:
    """Random weights with the reference's scheme (normal / sqrt(fan_in)
    with fan_in = ``shape[-2]``, embedding and router 0.02, norms 1, the
    SSM leaves by ``ssm.ssm_leaves``' rules), drawn on ``generator``'s
    device in registration order — the draws differ from ``jax.random``'s;
    tests that compare the packages bridge the reference's weights instead
    (``bridge.params_from_jax``).

    ``mesh``: the model holds this rank's blocks; each leaf is drawn whole
    from the one stream and cut, so a sharded draw gives the unsharded
    draw's weights, and a rank's peak is one whole leaf (float32) over its
    blocks."""
    model = Model(cfg, device, mesh)
    _dense_init(model.embed, generator, scale=0.02)
    model.final_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        _dense_init(model.lm_head, generator)
    if cfg.encoder_groups:
        model.enc_final_norm.fill_(1.0)
    for blk in list(model.blocks) + list(getattr(model, "enc_blocks", [])):
        mixer = blk.spec.mixer
        if mixer in SSM_MIXERS:
            _ssm_init(cfg, getattr(blk, mixer),
                      S.ssm_leaves(cfg, mixer, None), generator)
        for name, p in blk.named_parameters():
            if name.startswith(mixer + ".") and mixer in SSM_MIXERS:
                continue
            leaf = name.rsplit(".", 1)[-1]
            if "norm" in leaf:
                p.fill_(1.0)
            elif leaf == "router":
                _dense_init(p, generator, scale=0.02)
            else:
                _dense_init(p, generator)
    return model


# ===========================================================================
# contiguous cache
# ===========================================================================

def kv_layout(cfg: ModelConfig, mesh, max_seq: int, paged: bool) -> str:
    """How a sharded member's KV leaves split over ``"model"``: "heads"
    (the rank's KV heads), "group" (the one KV head the rank's query heads
    read, where the query heads split and the KV heads, fewer than the
    ranks, do not: ``model // n_kv_heads`` ranks hold each head), "seq" (a
    sequence shard of every head, decoded by ``smdec``) or "full" (whole
    on every rank).  The contiguous cache follows
    ``sharding.rules.cache_specs`` — heads when they divide the axis, else
    the sequence — except that ``decode_impl="shardmap"`` always takes the
    sequence (the layout the reference's ``shard_map`` reshards its cache
    into each step); MLA latents have no heads.  A paged pool splits
    heads, holds the rank's group's head, or stays whole (block tables
    index the whole sequence)."""
    M_ = model_split(mesh)
    if M_ == 1:
        return "full"
    heads = not cfg.is_mla and cfg.n_kv_heads % M_ == 0
    if paged:
        if heads:
            return "heads"
        group = not cfg.is_mla and cfg.n_heads % M_ == 0
        return "group" if group else "full"
    if cfg.decode_impl == "shardmap" and max_seq % M_ == 0:
        return "seq"
    if heads:
        return "heads"
    return "seq" if max_seq % M_ == 0 else "full"


def _block_cache(cfg: ModelConfig, spec: BlockSpec, repeats: int, batch: int,
                 max_seq: int, dtype, dev, mesh=None) -> dict:
    lead = (repeats, batch)
    layout = kv_layout(cfg, mesh, max_seq, paged=False)
    M_ = model_split(mesh)
    S_ = max_seq // M_ if layout == "seq" else max_seq

    def z(shape, dt=dtype, seq=layout == "seq"):
        t = torch.zeros(lead + shape, dtype=dt, device=dev)
        t._seq_split = seq
        return t

    if spec.mixer in ("attn", "bidir_attn"):
        hk = cfg.n_kv_heads // (M_ if layout == "heads" else 1)
        kv = (S_, hk, cfg.head_dim)
        return {"k": z(kv), "v": z(kv)}
    if spec.mixer == "cross_attn":
        kv = (cfg.cross_ctx_len, cfg.n_kv_heads, cfg.head_dim)
        return {"ck": z(kv, seq=False), "cv": z(kv, seq=False)}
    if spec.mixer == "mla":
        return {"ckv": z((S_, cfg.kv_lora_rank)),
                "krope": z((S_, cfg.rope_head_dim))}
    # mamba: the rank's channels, as its leaves split (the rules'
    # ``conv`` / ``h`` specs); the mLSTM's conv state stays whole, though
    # the rules' ``conv`` spec would split it: its mixer runs whole on
    # every rank and reads all of it
    split = M_ if spec.mixer == "mamba" and \
        S.mamba_dims(cfg)[0] % M_ == 0 else 1
    st = S.zero_state(cfg, spec.mixer, batch, dtype, dev, model=split)
    return {k: v[None].repeat((repeats,) + (1,) * v.dim())
            for k, v in st.items()}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = "cuda", mesh=None) -> dict:
    """Contiguous serving cache: ``cache["g{i}"]["b{j}"]`` holds block j's
    state for ``batch`` rows stacked over group i's repeats — attention
    ``k``/``v`` ``(repeats, batch, max_seq, Hkv, hd)``, cross-attention
    ``ck``/``cv`` over ``cross_ctx_len`` context tokens, MLA ``ckv``/
    ``krope``, or the SSM mixer's recurrent state (``ssm.zero_state``);
    ``cache["pos"]`` is the current length (a scalar int32; the scheduler
    replaces it with a (batch,) vector of per-row positions).  With
    ``mesh``: the rank's block of each KV leaf (``kv_layout``; a sequence
    shard carries ``_seq_split``) and of a mamba state (its channels);
    ``ck``/``cv`` and the xLSTM states whole."""
    check_supported(cfg)
    check_shardable(cfg, mesh)
    dev = _device(device)
    dtype = torch_dtype(cfg.dtype)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    for i, g in enumerate(cfg.groups):
        cache[f"g{i}"] = {
            f"b{j}": _block_cache(cfg, spec, g.repeats, batch, max_seq,
                                  dtype, dev, mesh)
            for j, spec in enumerate(g.period)}
    return cache


def _cache_write(buf: Tensor, val: Tensor, pos) -> None:
    """Write ``val`` (B, T, ...) into ``buf`` (B, S, ...) IN PLACE at
    sequence position ``pos``: an int (uniform across the batch) or a (B,)
    tensor of per-row positions (continuous-batching decode, T = 1).  The
    start is clamped so the write fits, as ``dynamic_update_slice``'s."""
    val = val.to(buf.dtype)
    S, T = buf.shape[1], val.shape[1]
    if not isinstance(pos, Tensor) or pos.dim() == 0:
        p = min(max(int(pos), 0), S - T)
        buf[:, p:p + T] = val
        return
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, pos.long().clamp(0, S - 1)] = val[:, 0]


def _seq_write(buf: Tensor, val: Tensor, pos: int) -> None:
    """Prefill write into a sequence shard: rank j's ``buf`` (B, S_loc,
    ...) holds positions ``[j * S_loc, (j + 1) * S_loc)``; the positions
    ``pos .. pos + T`` of ``val`` (B, T, ...) that fall there are written,
    IN PLACE."""
    j = current_mesh().coords["model"]
    s_loc, T = buf.shape[1], val.shape[1]
    lo, hi = max(pos, j * s_loc), min(pos + T, (j + 1) * s_loc)
    if lo < hi:
        buf[:, lo - j * s_loc:hi - j * s_loc] = \
            val[:, lo - pos:hi - pos].to(buf.dtype)


def _all_heads(t: Tensor, full: int) -> Tensor:
    """The rank's heads (dim 2) of ``t`` -> every head (all-gathered over
    ``"model"``); ``t`` when it holds all ``full`` already."""
    if t.shape[2] == full:
        return t
    return current_mesh().all_gather(t, "model", dim=2)


def _own_heads(t: Tensor, local: int) -> Tensor:
    """Every head (dim 2) of ``t`` -> this rank's ``local`` heads (``t``,
    replicated over ``"model"``, enters the head-split branch)."""
    if t.shape[2] == local:
        return t
    mesh = current_mesh()
    j = mesh.coords["model"]
    return mesh.enter(t, "model")[:, :, j * local:(j + 1) * local]


def _rank_kv(cfg: ModelConfig, t: Tensor, hq: int) -> Tensor:
    """The KV heads (dim 2) of ``t`` that the rank's ``hq`` query heads
    read: ``t`` itself unless the query heads split over ``"model"`` while
    ``t`` holds every KV head; then rank j's query heads ``j * hq ..`` lie
    under KV heads ``j * hq // G ..`` (G query heads a KV head), which are
    cut out: the rank's ``n_kv_heads / model`` heads when they divide the
    axis (a whole cross-attention cache), else the one head of the rank's
    group (``check_shardable`` lets through only ``model % n_kv_heads ==
    0``)."""
    if hq == cfg.n_heads or t.shape[2] != cfg.n_kv_heads:
        return t
    G = cfg.n_heads // cfg.n_kv_heads
    h = current_mesh().coords["model"] * hq // G
    return t[:, :, h:h + max(1, hq // G)]


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


def _block_paged_cache(cfg: ModelConfig, spec: BlockSpec, repeats: int,
                       num_blocks: int, block_tokens: int, dtype, dev,
                       kv_heads: int):
    lead = (repeats, num_blocks, block_tokens)
    if spec.mixer not in ("attn", "mla"):
        raise ValueError(f"paged cache unsupported for mixer {spec.mixer!r}")
    if spec.mixer == "mla":
        return {"ckv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype,
                                   device=dev),
                "krope": torch.zeros(lead + (cfg.rope_head_dim,),
                                     dtype=dtype, device=dev)}
    kv = lead + (kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=dev),
            "v": torch.zeros(kv, dtype=dtype, device=dev)}


def init_paged_cache(cfg: ModelConfig, slots: int, max_seq: int,
                     num_blocks: int, block_tokens: int,
                     device: DeviceLike = "cuda", mesh=None) -> dict:
    """Paged serving cache: KV leaves are physical block pools
    ``(repeats, num_blocks, block_tokens, Hkv, hd)`` shared by every slot
    (MLA blocks: ``ckv`` ``(..., kv_lora_rank)`` and ``krope`` ``(...,
    rope_head_dim)``);
    ``cache["tbl"]`` (slots, max_seq // block_tokens) int32 maps each
    slot's logical blocks to physical ones (0 = the reserved trash
    block); ``cache["pos"]`` (slots,) int32 holds each slot's depth.
    With ``mesh``: GQA pools hold the rank's KV heads when they divide
    the ``"model"`` axis, the one KV head its query heads read when the
    query heads split and the KV heads do not (``kv_layout`` "group"),
    else every head; MLA pools the whole latent."""
    check_supported(cfg)
    check_shardable(cfg, mesh)
    layout = kv_layout(cfg, mesh, max_seq, paged=True)
    kv_heads = {"heads": cfg.n_kv_heads // model_split(mesh),
                "group": 1}.get(layout, cfg.n_kv_heads)
    if max_seq % block_tokens:
        raise ValueError("max_seq must be a multiple of block_tokens")
    dev = _device(device)
    dtype = torch_dtype(cfg.dtype)
    cache = {"pos": torch.zeros((slots,), dtype=torch.int32, device=dev),
             "tbl": torch.zeros((slots, max_seq // block_tokens),
                                dtype=torch.int32, device=dev)}
    for i, g in enumerate(cfg.groups):
        cache[f"g{i}"] = {
            f"b{j}": _block_paged_cache(cfg, spec, g.repeats, num_blocks,
                                        block_tokens, dtype, dev, kv_heads)
            for j, spec in enumerate(g.period)}
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
    """Training and fresh-prefill attention: ``layers.sdpa_blocked`` under
    ``attn_impl="blocked"``; the CUDA flash kernel under ``"pallas"`` (its
    plain version on the CPU; it refuses inputs that require grad, as the
    reference's kernel has no gradient); else ``layers.sdpa``."""
    if cfg.attn_impl == "blocked" and q.shape[1] > 1:
        return L.sdpa_blocked(q, k, v, causal=causal,
                              sliding_window=sliding_window,
                              block=cfg.attn_block)
    if cfg.attn_impl == "pallas" and q.shape[1] > 1:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               None, causal=causal,
                               sliding_window=sliding_window)
    return L.sdpa(q, k, v, causal=causal, sliding_window=sliding_window)


def _self_attn(cfg, p: Block, h, rope, mode, bcache, pos, tbl,
               paged_fresh=False, bidir=False):
    """Self-attention in every serving mode.  ``bcache`` is this layer's
    ``{"k", "v"}``: paged pools when ``tbl`` (B, max_blocks) is given, else
    the contiguous ``(B, max_seq, Hkv, hd)`` rows, or None (the encoder's
    "full" mode: no cache).  Cache tensors are written in place.

    Paged: ``paged_fresh`` marks a from-scratch prefill (no cached prefix):
    attention then runs on the local K/V — right-padded rows rely on
    causality alone, so no ``lens`` reaches the kernel — and only the
    writes go through the table.  A suffix prefill (``pos`` = per-row
    start offsets) attends over the gathered view so cached prefix blocks
    are read, never recomputed.  Contiguous: prefill attends on the local
    K/V and writes them at ``pos``; decode writes each row's K/V at its own
    position and attends over the row up to it.

    A sharded member whose query heads split over ``"model"`` while its
    KV heads stay whole attends with the one KV head its query heads read
    (``_rank_kv``) in every mode; its paged pools hold that head alone
    (``kv_layout`` "group"), its contiguous cache every head."""
    x = L.rms_norm(h, p.norm1, cfg.norm_eps)
    q, k, v = L.attn_qkv(p.attn, cfg, x, x, rope, rope)
    hq = q.shape[2]
    kr, vr = _rank_kv(cfg, k, hq), _rank_kv(cfg, v, hq)
    causal = not bidir
    if mode == "full" or bcache is None:
        out = _sdpa_impl(cfg, q, kr, vr, causal=causal,
                         sliding_window=cfg.sliding_window)
        return h + L.attn_out(p.attn, out)
    if tbl is None and bcache.get("seq_split"):
        # a sharded member's sequence-sharded contiguous cache: prefill
        # attends on the prompt and writes the rank's positions of every
        # head; decode is the split-KV ``smdec`` over every head, of
        # which the rank keeps its own for its rows of ``wo``
        Hkv = cfg.n_kv_heads
        kf, vf = _all_heads(k, Hkv), _all_heads(v, Hkv)
        if mode == "prefill":
            out = _sdpa_impl(cfg, q, kr, vr, causal=causal,
                             sliding_window=cfg.sliding_window)
            _seq_write(bcache["k"], kf, int(pos))
            _seq_write(bcache["v"], vf, int(pos))
        else:
            out, _, _ = smdec.gqa_decode_sm(
                cfg, _all_heads(q, cfg.n_heads), kf, vf, bcache["k"],
                bcache["v"], pos)
            out = _own_heads(out, hq)
        return h + L.attn_out(p.attn, out)
    if tbl is None:
        _cache_write(bcache["k"], k, pos)
        _cache_write(bcache["v"], v, pos)
        if mode == "prefill":
            out = _sdpa_impl(cfg, q, kr, vr, causal=causal,
                             sliding_window=cfg.sliding_window)
        else:  # decode: pos (B,) per-row positions, or a scalar
            out = L.sdpa(q, _rank_kv(cfg, bcache["k"], hq),
                         _rank_kv(cfg, bcache["v"], hq), causal=False,
                         q_offset=pos, kv_len=pos + 1, sliding_window=0)
        return h + L.attn_out(p.attn, out)
    kpool, vpool = bcache["k"], bcache["v"]
    _paged_write(kpool, kr, tbl, pos)
    _paged_write(vpool, vr, tbl, pos)
    if mode == "prefill":
        if paged_fresh:
            out = _sdpa_impl(cfg, q, kr, vr, causal=True,
                             sliding_window=cfg.sliding_window)
        else:
            out = L.sdpa(q, _paged_view(kpool, tbl), _paged_view(vpool, tbl),
                         causal=True, sliding_window=cfg.sliding_window,
                         q_offset=pos)
    elif mode == "verify":
        # speculative verify: W tokens per row at pos..pos+W-1, attended
        # exactly like W successive decode steps — position t's mask set
        # (ik <= pos+t) is the decode step's kv_len = pos+t+1 set
        W = q.shape[1]
        kv_len = (pos + W).to(torch.int32)
        if cfg.decode_impl == "flash_paged":
            out = paged_flash_verify(q.contiguous(), kpool, vpool, tbl,
                                     kv_len)
        else:
            out = L.sdpa(q, _paged_view(kpool, tbl), _paged_view(vpool, tbl),
                         causal=True, q_offset=pos, kv_len=kv_len,
                         sliding_window=0)
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


def _cross_attn(cfg, p: Block, h, cross_ctx, mode, bcache):
    """Cross-attention to a per-request context (whisper's encoded frames,
    a vision member's patch embeddings): prefill projects ``cross_ctx``
    (B, T, d) to K/V, attends, and stores them in the layer's ``ck``/``cv``
    (in place); decode attends to the stored K/V.  Plain ``layers.sdpa``
    in both modes, as the reference's (no kernel).

    A sharded member attends with the rank's query heads and the KV heads
    they read (``_rank_kv``: its own where ``wk`` splits, the one of its
    group where only ``wq`` does); ``ck``/``cv`` hold every KV head (the
    rules keep them whole), so a prefill whose ``wk`` splits all-gathers
    the rank's heads once before it stores them."""
    x = L.rms_norm(h, p.norm1, cfg.norm_eps)
    if mode == "decode":
        B, Sq, _ = x.shape
        split = L.split_over(p.attn["wq"], dim=1)
        q = (L.enter(x, split) @ L.W(p.attn["wq"])).reshape(
            B, Sq, -1, cfg.head_dim)
        if cfg.qk_norm:
            q = L.rms_norm(q, L.enter(p.attn["q_norm"], split),
                           cfg.norm_eps)
        hq = q.shape[2]
        out = L.sdpa(q, _rank_kv(cfg, bcache["ck"], hq),
                     _rank_kv(cfg, bcache["cv"], hq), causal=False)
        return h + L.attn_out(p.attn, out)
    q, k, v = L.attn_qkv(p.attn, cfg, x, cross_ctx, None, None)
    hq = q.shape[2]
    out = L.sdpa(q, _rank_kv(cfg, k, hq), _rank_kv(cfg, v, hq), causal=False)
    if mode == "prefill" and bcache is not None:
        bcache["ck"].copy_(_all_heads(k, cfg.n_kv_heads))
        bcache["cv"].copy_(_all_heads(v, cfg.n_kv_heads))
    return h + L.attn_out(p.attn, out)


def _mla_attn(cfg, p: Block, h, rope, mode, bcache, pos, tbl,
              paged_fresh=False):
    """MLA in every mode (training: ``_mla_naive``, no cache).  In prefill,
    decode or verify mode ``bcache`` is ``{"ckv",
    "krope"}`` for this layer: paged pools when ``tbl`` is given, else the
    contiguous rows (prefill: ``_mla_naive`` on the local latents; decode:
    absorbed ``mla_attention`` over the row).  Written in place.

    Fresh prefill runs ``_mla_naive`` on the local latents.  A suffix
    prefill runs the EXPANDED form over the gathered view, not the
    absorbed one: absorption reassociates the latent matmul, and that
    last-ulp logit difference flips greedy argmax on near-ties (the
    reference's reason, model.py:385-389).  Decode is absorbed: under
    ``decode_impl="flash_paged"`` the CUDA latent-decode kernel computes
    the context from the pools through the table; otherwise
    ``mla_attention`` runs over the gathered view.  Verify runs the SAME
    absorbed program as decode over W positions (never ``_mla_naive``), so
    position t equals a decode step at ``kv_len = pos + t + 1``."""
    x = L.rms_norm(h, p.norm1, cfg.norm_eps)
    mp = p.mla
    q_nope, q_rope = L.mla_q(mp, cfg, x, rope)
    # a sharded member: every rank computes every head's query and the
    # whole latent, then keeps its heads (its blocks of wk_b / wv_b / wo)
    H_loc = mp["wk_b"].shape[0]
    q_nope, q_rope = _own_heads(q_nope, H_loc), _own_heads(q_rope, H_loc)
    c_kv, k_rope = L.mla_kv_latent(mp, cfg, x, rope)
    if mode == "full" or bcache is None:
        # the latents, computed whole on every rank, enter its heads
        split = H_loc < cfg.n_heads
        return h + _mla_naive(cfg, mp, q_nope, q_rope, L.enter(c_kv, split),
                              L.enter(k_rope, split))
    if tbl is None and bcache.get("seq_split"):
        if mode == "prefill":
            _seq_write(bcache["ckv"], c_kv, int(pos))
            _seq_write(bcache["krope"], k_rope, int(pos))
            return h + _mla_naive(cfg, mp, q_nope, q_rope, c_kv, k_rope)
        q_lat = _all_heads(L.mla_absorb_q(mp, q_nope), cfg.n_heads)
        ctx, _, _ = smdec.mla_decode_sm(
            cfg, q_lat, _all_heads(q_rope, cfg.n_heads), c_kv, k_rope,
            bcache["ckv"], bcache["krope"], pos)
        return h + L.mla_out(mp, cfg, _own_heads(ctx, H_loc))
    if tbl is None:   # the contiguous cache
        _cache_write(bcache["ckv"], c_kv, pos)
        _cache_write(bcache["krope"], k_rope, pos)
        if mode == "prefill":
            return h + _mla_naive(cfg, mp, q_nope, q_rope, c_kv, k_rope)
        return h + L.mla_attention(mp, cfg, q_nope, q_rope, bcache["ckv"],
                                   bcache["krope"], causal=False,
                                   q_offset=pos, kv_len=pos + 1)
    ckv_p, krope_p = bcache["ckv"], bcache["krope"]
    _paged_write(ckv_p, c_kv, tbl, pos)
    _paged_write(krope_p, k_rope, tbl, pos)
    if mode == "prefill":
        if paged_fresh:
            out = _mla_naive(cfg, mp, q_nope, q_rope, c_kv, k_rope)
        else:
            out = _mla_naive(cfg, mp, q_nope, q_rope, _paged_view(ckv_p, tbl),
                             _paged_view(krope_p, tbl), q_offset=pos)
    elif mode == "verify":
        W = q_nope.shape[1]
        kv_len = (pos + W).to(torch.int32)
        if cfg.decode_impl == "flash_paged":
            ctx = paged_flash_verify_mla(
                L.mla_absorb_q(mp, q_nope).contiguous(), q_rope.contiguous(),
                ckv_p, krope_p, tbl, kv_len, scale=L.mla_scale(cfg))
            out = L.mla_out(mp, cfg, ctx)
        else:
            out = L.mla_attention(mp, cfg, q_nope, q_rope,
                                  _paged_view(ckv_p, tbl),
                                  _paged_view(krope_p, tbl), causal=True,
                                  q_offset=pos, kv_len=kv_len)
    else:  # decode: pos (B,) per-row positions
        kv_len = (pos + 1).to(torch.int32)
        if cfg.decode_impl == "flash_paged":
            q_lat = L.mla_absorb_q(mp, q_nope)
            ctx = paged_flash_decode_mla(
                q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous(), ckv_p,
                krope_p, tbl, kv_len, scale=L.mla_scale(cfg))
            out = L.mla_out(mp, cfg, ctx[:, None])
        else:
            out = L.mla_attention(mp, cfg, q_nope, q_rope,
                                  _paged_view(ckv_p, tbl),
                                  _paged_view(krope_p, tbl), causal=False,
                                  q_offset=pos, kv_len=kv_len)
    return h + out


def _mla_naive(cfg, mp, q_nope, q_rope, c_kv, k_rope, q_offset=None):
    """Training / prefill MLA: expand latents to per-head K/V, standard
    SDPA.
    ``q_offset`` ((B,) per-row start positions) is the paged-suffix case:
    K/V come from the gathered block view, queries sit at an offset."""
    B, Sq, H, _ = q_nope.shape
    k_nope = torch.einsum("bsr,hrn->bshn", c_kv, L.W(mp["wk_b"]))
    v = torch.einsum("bsr,hrv->bshv", c_kv, L.W(mp["wv_b"]))
    k_rope_h = k_rope[:, :, None, :].expand(B, k_rope.shape[1], H,
                                            cfg.rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h.to(k_nope.dtype)], dim=-1)
    if q_offset is not None:
        out = L.sdpa(q, k, v, causal=True, q_offset=q_offset)
    else:
        out = _sdpa_impl(cfg, q, k, v, causal=True, sliding_window=0)
    return L.row_parallel_sum(
        out.reshape(B, Sq, H * cfg.v_head_dim) @ L.W(mp["wo"]), mp["wo"])


def _apply_block(cfg: ModelConfig, p: Block, h: Tensor, *, rope, cross_ctx,
                 mode: str, bcache, pos, tbl, moe_impl: str,
                 paged_fresh=False) -> Tuple[Tensor, Optional[tuple]]:
    """One block.  Returns (h, aux): aux is the MoE FFN's ``(moe_lb,
    moe_z)`` in the training mode ("full"), else None (the serving modes
    do not compute them)."""
    mixer = p.spec.mixer
    if mixer in ("attn", "bidir_attn"):
        h = _self_attn(cfg, p, h, rope, mode, bcache, pos, tbl,
                       paged_fresh=paged_fresh, bidir=mixer == "bidir_attn")
    elif mixer == "cross_attn":
        h = _cross_attn(cfg, p, h, cross_ctx, mode, bcache)
    elif mixer == "mla":
        h = _mla_attn(cfg, p, h, rope, mode, bcache, pos, tbl,
                      paged_fresh=paged_fresh)
    else:   # SSM: a recurrent state per row, copied into the cache in place
        x = L.rms_norm(h, p.norm1, cfg.norm_eps)
        forward, step = S.FORWARD[mixer]
        sp = getattr(p, mixer)
        if mode == "decode":
            y, state = step(sp, cfg, x, bcache)
        else:
            y, state = forward(sp, cfg, x, state=None,
                               return_state=mode == "prefill")
        if state is not None and bcache is not None:
            for leaf, t in state.items():
                bcache[leaf].copy_(t)
        h = h + y
    if p.spec.ffn == "none":
        return h, None
    x = L.rms_norm(h, p.norm2, cfg.norm_eps)
    if p.spec.ffn == "moe":
        y, aux = M.moe_apply(p.moe, cfg, x, moe_impl, aux=mode == "full")
        return h + y, None if aux is None else (aux["moe_lb"], aux["moe_z"])
    return h + L.ffn_apply(p.ffn, x), None


def _period(cfg: ModelConfig, blocks, h: Tensor, lb, z, **kw):
    """One repeat of a group's period: its blocks in turn, adding each MoE
    block's aux losses to the running ``lb`` / ``z`` (None outside the
    training mode)."""
    for blk, bc in blocks:
        h, aux = _apply_block(cfg, blk, h, bcache=bc, **kw)
        if aux is not None:
            lb, z = lb + aux[0], z + aux[1]
    return h, lb, z


def _run_groups(cfg: ModelConfig, blocks: nn.ModuleList,
                groups: Sequence[LayerGroup], h: Tensor, *, rope, mode,
                cache, pos, tbl, moe_impl: str, cross_ctx=None,
                paged_fresh=False, remat: bool = False
                ) -> Tuple[Tensor, Optional[dict]]:
    """The stack, unrolled: group i, repeat r, period slot j is block
    ``n``; its cache leaves are ``cache["g{i}"]["b{j}"][leaf][r]`` (views,
    written in place), or None when ``cache`` is (training, the encoder).

    Returns (h, aux): in the training mode ("full") aux holds the float32
    ``moe_lb`` / ``moe_z`` totals over every block, as the reference's
    scan carry, and ``remat`` recomputes each repeat of a period in the
    backward pass (``torch.utils.checkpoint``, non-reentrant); in the
    serving modes aux is None."""
    train = mode == "full"
    lb = z = None
    if train:
        lb = torch.zeros((), dtype=torch.float32, device=h.device)
        z = torch.zeros((), dtype=torch.float32, device=h.device)
    kw = dict(rope=rope, cross_ctx=cross_ctx, mode=mode, pos=pos, tbl=tbl,
              moe_impl=moe_impl, paged_fresh=paged_fresh)
    n = 0
    for i, g in enumerate(groups):
        gc = cache[f"g{i}"] if cache is not None else None
        for r in range(g.repeats):
            period = []
            for j in range(len(g.period)):
                bc = None
                if gc is not None:
                    leaves = gc[f"b{j}"]
                    bc = {leaf: t[r] for leaf, t in leaves.items()}
                    bc["seq_split"] = any(getattr(t, "_seq_split", False)
                                          for t in leaves.values())
                period.append((blocks[n], bc))
                n += 1
            if remat and train:
                # the recompute sees the forward's mesh and rules
                state = capture()
                h, lb, z = checkpoint(
                    _period, cfg, period, h, lb, z, use_reentrant=False,
                    context_fn=lambda: (contextlib.nullcontext(),
                                        installed(state)), **kw)
            else:
                h, lb, z = _period(cfg, period, h, lb, z, **kw)
    return h, ({"moe_lb": lb, "moe_z": z} if train else None)


def _encode(cfg: ModelConfig, params: Model, frames: Tensor,
            moe_impl: str, remat: bool = False) -> Tensor:
    """Run the encoder stack over stub frame embeddings (whisper):
    bidirectional self-attention over every frame, no cache."""
    Sf = frames.shape[1]
    rope = L.rope_tables(torch.arange(Sf, device=frames.device),
                         cfg.head_dim, cfg.rope_theta)
    h, _ = _run_groups(cfg, params.enc_blocks, cfg.encoder_groups, frames,
                       rope=rope, mode="full", cache=None, pos=0, tbl=None,
                       moe_impl=moe_impl, remat=remat)
    return L.rms_norm(h, params.enc_final_norm, cfg.norm_eps)


def _prepare_cross(cfg: ModelConfig, params: Model, cross_ctx, moe_impl,
                   remat: bool = False):
    if cross_ctx is None:
        return None
    if cfg.is_encoder_decoder:
        return _encode(cfg, params, cross_ctx, moe_impl, remat)
    return cross_ctx  # vision: pre-embedded patches (stub frontend)


def _rope_dim(cfg: ModelConfig) -> int:
    return cfg.rope_head_dim if cfg.is_mla else cfg.head_dim


def _embed(params: Model, tokens: Tensor) -> Tensor:
    """Token embeddings; vocab-parallel when the rules split the table's
    rows over ``"model"``: each rank looks up the ids of its rows (zeros
    for the rest) and the rows are all-reduced (one nonzero term each)."""
    table = L.W(params.embed)
    if not L.split_over(params.embed):
        return table[tokens.long()]
    mesh = current_mesh()
    Vl = table.shape[0]
    local = tokens.long() - mesh.coords["model"] * Vl
    inside = (local >= 0) & (local < Vl)
    h = torch.where(inside[..., None], table[local.clamp(0, Vl - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    return mesh.psum(h, "model")


def _logits(cfg: ModelConfig, params: Model, h: Tensor) -> Tensor:
    """Logits over the vocabulary — the rank's vocab shard when the rules
    split it over ``"model"`` (``serve_lib.greedy`` and ``loss_fn``
    reduce shards)."""
    h = L.rms_norm(h, params.final_norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.enter(h, L.split_over(params.embed)) @ L.W(params.embed).T
    return L.enter(h, L.split_over(params.lm_head, dim=1)) @ \
        L.W(params.lm_head)


def _take_last(h: Tensor, lens) -> Tensor:
    """Each row's last real position: ``lens - 1``, or the last one."""
    if lens is None:
        return h[:, -1:, :]
    idx = torch.as_tensor(lens, device=h.device).long() - 1
    return torch.gather(h, 1, idx[:, None, None].expand(h.shape[0], 1,
                                                        h.shape[2]))


# ===========================================================================
# public API
# ===========================================================================

def forward(cfg: ModelConfig, params: Model, tokens: Tensor,
            cross_ctx: Optional[Tensor] = None, *, moe_impl: str = "gshard",
            remat: bool = False) -> Tuple[Tensor, dict]:
    """Training forward: tokens (B,S) -> (logits (B,S,V), aux ``{"moe_lb",
    "moe_z"}`` summed over the MoE blocks).  Differentiable: gradients
    reach every parameter that requires grad.  ``cross_ctx`` (B, T, d):
    stub audio frames that the encoder runs over first (whisper, with
    ``remat`` too), or a vision member's pre-embedded patches.  Under
    ``attn_impl="pallas"`` a forward that needs gradients raises
    ``NotImplementedError`` (the kernel has none, as the reference's)."""
    check_supported(cfg)
    h = _embed(params, tokens)
    rope = L.rope_tables(torch.arange(tokens.shape[1], device=h.device),
                         _rope_dim(cfg), cfg.rope_theta)
    cross = _prepare_cross(cfg, params, cross_ctx, moe_impl, remat)
    h, aux = _run_groups(cfg, params.blocks, cfg.groups, h, rope=rope,
                         mode="full", cache=None, pos=0, tbl=None,
                         moe_impl=moe_impl, cross_ctx=cross, remat=remat)
    return _logits(cfg, params, h), aux


def loss_fn(cfg: ModelConfig, params: Model, tokens: Tensor, labels: Tensor,
            cross_ctx: Optional[Tensor] = None, *, moe_impl: str = "gshard",
            remat: bool = True, lb_coef: float = 0.01, z_coef: float = 1e-3):
    """Next-token cross entropy (+ MoE aux losses), the reference's
    ``loss_fn``: logits in float32, labels (B,S) with -100 entries masked,
    the aux losses averaged over ``n_moe`` (the MoE blocks of one period
    of each group, at least 1, as the reference counts them).  Returns
    (total, {"ce", "moe_lb", "moe_z"}), float32 scalars."""
    logits, aux = forward(cfg, params, tokens, cross_ctx, moe_impl=moe_impl,
                          remat=remat)
    logits = logits.float()
    labels = labels.long()
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    mesh = current_mesh()
    if logits.shape[-1] < cfg.vocab_size:
        logz, gold = _vocab_parallel_ce(mesh, logits, safe)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    num, den = ((logz - gold) * mask).sum(), mask.sum()
    rows = row_axes()
    lb, z = aux["moe_lb"], aux["moe_z"]
    if rows:
        # the rank holds its rows: the sums are the global batch's, and
        # each MoE aux loss is the first data shard's value with the
        # shards' mean gradient, as GSPMD gives the reference's
        # (``moe.moe_ep``'s per-shard aux out of its ``shard_map``)
        num = mesh.psum(num, rows)
        den = mesh.all_reduce(den, rows)
        if cfg.n_experts:
            lb, z = mesh.first(lb, rows), mesh.first(z, rows)
    ce = num / torch.clamp(den, min=1.0)
    n_moe = max(1, sum(1 for g in cfg.groups for s in g.period
                       if s.ffn == "moe"))
    total = ce + lb_coef * lb / n_moe + z_coef * z / n_moe
    metrics = {"ce": ce, "moe_lb": lb / n_moe, "moe_z": z / n_moe}
    return total, metrics


def _vocab_parallel_ce(mesh, logits: Tensor, labels: Tensor):
    """(logsumexp, gold logit) over a vocabulary split over ``"model"``:
    ``logits`` is the rank's shard (float32); the max is all-reduced
    without gradient, the sums of exponentials and the gold logit (from
    the rank that owns it) as partial sums."""
    Vl = logits.shape[-1]
    m = mesh.all_reduce(logits.detach().amax(-1), "model", op="max")
    se = mesh.psum(torch.exp(logits - m[..., None]).sum(-1), "model")
    local = labels - mesh.coords["model"] * Vl
    inside = (local >= 0) & (local < Vl)
    g = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = mesh.psum(torch.where(inside, g, torch.zeros_like(g)), "model")
    return torch.log(se) + m, gold


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Model, tokens: Tensor, cache: dict,
            cross_ctx: Optional[Tensor] = None, *, moe_impl: str = "gshard",
            lens: Optional[Tensor] = None, start: Optional[Tensor] = None,
            tbl: Optional[Tensor] = None,
            paged_fresh: bool = False) -> Tuple[Tensor, dict]:
    """Prefill: returns (last-token logits (B,V), cache).

    ``lens`` (B,) gives each row's real prompt length when rows are
    right-padded: logits are taken at ``lens - 1``.  ``moe_impl`` selects
    the MoE FFN as in the reference.

    Contiguous (no ``tbl``): the prompt starts at position 0 of the
    contiguous ``cache`` (``init_cache``) and ``cache["pos"]`` becomes its
    width.  ``cross_ctx`` (B, T, d) is the cross-attention context: stub
    audio frames that the encoder runs over first (whisper), or a vision
    member's pre-embedded patches.

    Paged (``tbl`` (B, max_blocks) given): ``cache`` is the shared block
    pool and each row's KV writes go through its table row.  ``start`` (B,)
    is the absolute position of ``tokens[:, 0]`` — for a prefix-cache hit
    only the unmatched suffix is passed in and attention reads the cached
    prefix blocks through the table (``paged_fresh=True`` marks a
    no-prefix prefill)."""
    check_supported(cfg)
    dev = tokens.device
    B, Sq = tokens.shape
    h = _embed(params, tokens)
    if tbl is None:
        rope = L.rope_tables(torch.arange(Sq, device=dev), _rope_dim(cfg),
                             cfg.rope_theta)
        cross = _prepare_cross(cfg, params, cross_ctx, moe_impl)
        h, _ = _run_groups(cfg, params.blocks, cfg.groups, h, rope=rope,
                           mode="prefill", cache=cache, pos=0, tbl=None,
                           moe_impl=moe_impl, cross_ctx=cross)
        cache["pos"] = torch.full((), Sq, dtype=torch.int32, device=dev)
        return _logits(cfg, params, _take_last(h, lens))[:, 0, :], cache
    pos = (torch.zeros((B,), dtype=torch.long, device=dev) if start is None
           else torch.as_tensor(start, device=dev).long())
    positions = pos[:, None] + torch.arange(Sq, device=dev)[None, :]
    rope = L.rope_tables(positions, _rope_dim(cfg), cfg.rope_theta)
    h, _ = _run_groups(cfg, params.blocks, cfg.groups, h, rope=rope,
                       mode="prefill", cache=cache, pos=pos, tbl=tbl,
                       moe_impl=moe_impl, paged_fresh=paged_fresh)
    return _logits(cfg, params, _take_last(h, lens))[:, 0, :], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Model, tokens: Tensor,
                cache: dict, *, moe_impl: str = "gshard"
                ) -> Tuple[Tensor, dict]:
    """One decode step: tokens (B,1) + cache -> (logits (B,V), cache).

    ``cache["pos"]`` is a scalar (every row at one depth) or a (B,) vector
    of per-row positions (continuous batching): each row writes, rotates
    and attends at its own depth.  The cache — paged when it holds
    ``"tbl"``, else contiguous — is written in place and ``cache["pos"]``
    comes back advanced by one.  ``moe_impl`` as in ``prefill``."""
    check_supported(cfg)
    pos = cache["pos"].long()
    tbl = cache.get("tbl")
    h = _embed(params, tokens)
    rope_pos = pos[None] if pos.dim() == 0 else pos[:, None]
    rope = L.rope_tables(rope_pos, _rope_dim(cfg), cfg.rope_theta)
    h, _ = _run_groups(cfg, params.blocks, cfg.groups, h, rope=rope,
                       mode="decode", cache=cache, pos=pos, tbl=tbl,
                       moe_impl=moe_impl)
    cache["pos"] = cache["pos"] + 1
    return _logits(cfg, params, h)[:, 0, :], cache


@torch.no_grad()
def verify(cfg: ModelConfig, params: Model, tokens: Tensor, cache: dict,
           *, moe_impl: str = "gshard") -> Tuple[Tensor, dict]:
    """Speculative-decoding verify: tokens (B,W) + paged cache ->
    (logits (B,W,V), cache).

    Feeds W tokens per row (the pending token followed by W-1 draft
    proposals) at positions ``pos..pos+W-1``, writing all W KV entries
    through the block table (in place) and returning logits at EVERY
    position.  Attention at position t masks to ``kv <= pos+t`` — the set
    a decode step sees at depth pos+t — through the decode program
    (absorbed MLA, no sliding window).  KV written past the accepted
    prefix sits beyond the row's next ``pos`` and is overwritten before it
    can be attended to, so rollback costs nothing.  ``cache["pos"]`` and
    ``cache["tbl"]`` are scheduler-owned and left unchanged.  ``moe_impl``
    as in ``prefill``."""
    check_supported(cfg)
    if "tbl" not in cache:
        raise NotImplementedError("speculative verify needs the paged cache")
    pos = cache["pos"].long()
    tbl = cache["tbl"]
    W = tokens.shape[1]
    h = _embed(params, tokens)
    positions = pos[:, None] + torch.arange(W, device=pos.device)[None, :]
    rope = L.rope_tables(positions, _rope_dim(cfg), cfg.rope_theta)
    h, _ = _run_groups(cfg, params.blocks, cfg.groups, h, rope=rope,
                       mode="verify", cache=cache, pos=pos, tbl=tbl,
                       moe_impl=moe_impl)
    return _logits(cfg, params, h), cache
