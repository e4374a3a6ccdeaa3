"""qwen3-moe-235b-a22b [moe] — hf:Qwen/Qwen3-235B-A22B (per Qwen3-30B-A3B family).

94L d_model=4096 64H (GQA kv=4) d_ff(expert)=1536 vocab=151936,
MoE 128 experts top-8, qk_norm, no shared experts.
"""

from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    groups=(LayerGroup((BlockSpec("attn", "moe"),), 94),),
    n_experts=128,
    n_shared_experts=0,
    moe_top_k=8,
    d_ff_expert=1536,
    qk_norm=True,
    rope_theta=1.0e6,
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        groups=(LayerGroup((BlockSpec("attn", "moe"),), 2),),
        n_experts=8,
        moe_top_k=2,
        d_ff_expert=32,
    )
