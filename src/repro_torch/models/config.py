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
