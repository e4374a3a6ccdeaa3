"""Unified model-architecture configuration (copy of ``repro.models.config``).

Every architecture is a stack of ``LayerGroup``s: a *period* of
heterogeneous ``BlockSpec``s repeated ``repeats`` times.  The port unrolls
the repeats into one ``nn.ModuleList`` of blocks (layer ``n`` of group
``i`` is block ``sum(previous groups) + r * len(period) + j``).

The dataclasses are kept field-for-field identical to the reference so one
config means the same thing in both packages.  The port serves every mixer
(attention, bidirectional and cross-attention, MLA, mamba, mLSTM, sLSTM)
and FFN kind (dense, MoE, none) and every decode path (``xla``,
``flash_paged``, ``shardmap``); ``models/model.py:check_supported``
refuses only an unknown one, and ``check_shardable`` the members that do
not shard over a model axis yet (SSM state, cross-attention).
``param_count`` / ``model_flops`` are the reference's analytic counts
(pure Python), the roofline's MODEL_FLOPS.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

MIXERS = ("attn", "bidir_attn", "cross_attn", "mla", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")


@dataclass(frozen=True)
class BlockSpec:
    mixer: str
    ffn: str = "dense"

    def __post_init__(self):
        assert self.mixer in MIXERS, self.mixer
        assert self.ffn in FFNS, self.ffn


@dataclass(frozen=True)
class LayerGroup:
    period: Tuple[BlockSpec, ...]
    repeats: int

    @property
    def n_blocks(self) -> int:
        return len(self.period) * self.repeats


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    groups: Tuple[LayerGroup, ...]

    # --- encoder / cross-attention context (stub modality frontends) -------
    encoder_groups: Tuple[LayerGroup, ...] = ()
    cross_ctx_len: int = 0          # stub context tokens (vision patches / audio frames)

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    moe_capacity_factor: float = 1.25

    # --- MLA (DeepSeek-V2) ----------------------------------------------------
    q_lora_rank: int = 0            # 0 => full-rank q projection
    kv_lora_rank: int = 0
    nope_head_dim: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- attention details ----------------------------------------------------
    qk_norm: bool = False
    sliding_window: int = 0         # 0 => global
    rope_theta: float = 1.0e6

    # --- Mamba (Jamba) ----------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- xLSTM ------------------------------------------------------------------
    xlstm_proj_factor: float = 2.0  # mLSTM up-projection factor
    xlstm_conv: int = 4

    # --- numerics / misc ----------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sub_quadratic: bool = False     # eligible for the long_500k shape
    # training / prefill attention: "einsum" (materialized S^2 probs, the
    # plain path) | "blocked" (a loop over KV blocks with online softmax,
    # O(S) memory) | "pallas" (the name the reference gives its kernel; in
    # the port it selects the hand-written CUDA flash-attention kernel)
    attn_impl: str = "einsum"
    attn_block: int = 512
    # decode attention: "xla" (gathered view + plain sdpa) | "flash_paged"
    # (in the port: the CUDA block-table decode kernel) | "shardmap" (a
    # sharded member's split-KV decode over a sequence-sharded cache)
    decode_impl: str = "xla"
    # sharding-rule variant (sharding/rules.py)
    shard_variant: str = "baseline"

    # ------------------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return sum(g.n_blocks for g in self.groups)

    @property
    def n_encoder_blocks(self) -> int:
        return sum(g.n_blocks for g in self.encoder_groups)

    @property
    def q_dim(self) -> int:
        if self.is_mla:
            return self.n_heads * (self.nope_head_dim + self.rope_head_dim)
        return self.n_heads * self.head_dim

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return len(self.encoder_groups) > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Analytic parameter / FLOP accounting (used by the roofline's MODEL_FLOPS).
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig, cross: bool = False) -> int:
    d = cfg.d_model
    if cfg.is_mla and not cross:
        qh = cfg.nope_head_dim + cfg.rope_head_dim
        p = 0
        if cfg.q_lora_rank:
            p += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qh
        else:
            p += d * cfg.n_heads * qh
        p += d * (cfg.kv_lora_rank + cfg.rope_head_dim)                       # down-proj + k_rope
        p += cfg.kv_lora_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.v_head_dim)  # up-proj k_nope,v
        p += cfg.n_heads * cfg.v_head_dim * d                                  # out proj
        return p
    hd = cfg.head_dim
    p = d * cfg.n_heads * hd          # q
    p += 2 * d * cfg.n_kv_heads * hd  # k, v
    p += cfg.n_heads * hd * d         # out
    return p


def _dense_ffn_params(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff  # SwiGLU: gate, up, down


def _moe_ffn_params(cfg: ModelConfig, active_only: bool = False) -> int:
    n_routed = cfg.moe_top_k if active_only else cfg.n_experts
    p = n_routed * 3 * cfg.d_model * cfg.d_ff_expert
    p += cfg.n_shared_experts * 3 * cfg.d_model * cfg.d_ff_expert
    p += cfg.d_model * cfg.n_experts  # router
    return p


def _mamba_params(cfg: ModelConfig) -> int:
    d, e, s, c = cfg.d_model, cfg.mamba_expand, cfg.mamba_d_state, cfg.mamba_d_conv
    di = e * d
    p = d * 2 * di              # in_proj (x, z)
    p += di * c + di            # conv1d + bias
    p += di * (s * 2 + 1)       # B, C, dt projections (x -> dt_rank folded: use di->(2s+dt))
    dt_rank = max(1, d // 16)
    p += di * dt_rank + dt_rank * di  # dt down/up
    p += di * s                 # A_log
    p += di                     # D
    p += di * d                 # out_proj
    return p


def _mlstm_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    di = int(cfg.xlstm_proj_factor * d)
    p = d * 2 * di              # up-proj (x, z)
    p += di * cfg.xlstm_conv + di
    p += 3 * di * di            # q, k, v
    p += 2 * di                 # i, f gate biases-ish (per-head linear small) -> use di each
    p += 2 * di                 # the reference's 2 * di * H // H (H >= 1)
    p += di * d                 # down-proj
    return p


def _slstm_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    p = 4 * d * d               # i, f, z, o recurrent-input projections
    p += 4 * d * d              # recurrent weights (block-diag per head; counted dense upper bound /heads)
    ff = int(d * 4 / 3)
    p += 2 * d * ff + ff * d    # post-block GeGLU FFN (per xLSTM paper)
    return p


def _stack_params(cfg: ModelConfig, groups, active_only: bool = False) -> int:
    total = 0
    for g in groups:
        for spec in g.period:
            p = 0
            if spec.mixer in ("attn", "bidir_attn", "mla"):
                p += _attn_params(cfg)
            elif spec.mixer == "cross_attn":
                p += _attn_params(cfg, cross=True)
            elif spec.mixer == "mamba":
                p += _mamba_params(cfg)
            elif spec.mixer == "mlstm":
                p += _mlstm_params(cfg)
            elif spec.mixer == "slstm":
                p += _slstm_params(cfg)
            p += cfg.d_model
            if spec.ffn == "dense":
                p += _dense_ffn_params(cfg) + cfg.d_model
            elif spec.ffn == "moe":
                p += _moe_ffn_params(cfg, active_only=active_only) + cfg.d_model
            total += p * g.repeats
    return total


def param_count(cfg: ModelConfig, include_embed: bool = True,
                active_only: bool = False) -> int:
    """Analytic parameter count.  ``active_only`` counts top-k routed experts
    only (MoE active parameters, for 6*N_active*D roofline FLOPs)."""
    total = _stack_params(cfg, cfg.groups, active_only)
    total += _stack_params(cfg, cfg.encoder_groups, active_only)
    total += cfg.d_model  # final norm
    if include_embed:
        total += cfg.vocab_size * cfg.d_model           # embedding
        if not cfg.tie_embeddings:
            total += cfg.vocab_size * cfg.d_model       # lm head
    return total


def model_flops(cfg: ModelConfig, n_tokens: int, mode: str = "train") -> float:
    """MODEL_FLOPS: 6*N*D (train) / 2*N*D (forward) with
    N = active non-embedding params, D = processed tokens.  Ignores the
    quadratic attention term by convention (it is surfaced separately via the
    HLO_FLOPs / MODEL_FLOPS ratio)."""
    n_active = param_count(cfg, include_embed=False, active_only=True)
    # lm head matmul is real compute even when "embedding" params are excluded
    n_active += cfg.vocab_size * cfg.d_model
    mult = 6.0 if mode == "train" else 2.0
    return mult * n_active * float(n_tokens)
