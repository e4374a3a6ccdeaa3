"""glm4-9b [dense] — hf:THUDM/glm-4-9b.
A copy of ``repro.configs.glm4_9b``.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552, RoPE.
"""

from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    groups=(LayerGroup((BlockSpec("attn", "dense"),), 40),),
    rope_theta=1.0e4,
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
