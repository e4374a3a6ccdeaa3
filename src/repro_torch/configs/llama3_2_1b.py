"""llama3.2-1b [dense] — hf:meta-llama/Llama-3.2-1B.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, head_dim=64.
"""

from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    groups=(LayerGroup((BlockSpec("attn", "dense"),), 16),),
    tie_embeddings=True,
    rope_theta=5.0e5,
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
