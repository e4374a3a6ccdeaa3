"""qwen3-1.7b [dense] — hf:Qwen/Qwen3-1.7B (per Qwen3-8B family).

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, qk_norm.
"""

from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    groups=(LayerGroup((BlockSpec("attn", "dense"),), 28),),
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1.0e6,
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        groups=(LayerGroup((BlockSpec("attn", "dense"),), 2),),
    )
