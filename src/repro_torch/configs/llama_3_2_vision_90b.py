"""llama-3.2-vision-90b [vlm] — hf:meta-llama/Llama-3.2-90B-Vision.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  Period-5
interleave: 4 self-attention decoder layers + 1 cross-attention layer
(20 cross-attn layers total).  The vision frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings (1600 tokens).
"""

from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    groups=(
        LayerGroup(
            (
                BlockSpec("attn", "dense"),
                BlockSpec("attn", "dense"),
                BlockSpec("attn", "dense"),
                BlockSpec("attn", "dense"),
                BlockSpec("cross_attn", "dense"),
            ),
            20,
        ),
    ),
    cross_ctx_len=1600,
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
        groups=(
            LayerGroup(
                (BlockSpec("attn", "dense"), BlockSpec("cross_attn", "dense")),
                2,
            ),
        ),
        cross_ctx_len=16,
    )
