"""smollm-360m [dense] — hf:HuggingFaceTB/SmolLM-360M (llama-arch small).

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, head_dim=64.
"""

from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    groups=(LayerGroup((BlockSpec("attn", "dense"),), 32),),
    tie_embeddings=True,
    rope_theta=1.0e4,
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=60,
        n_heads=3,
        n_kv_heads=1,
        head_dim=20,
        d_ff=128,
        vocab_size=256,
        groups=(LayerGroup((BlockSpec("attn", "dense"),), 2),),
    )
