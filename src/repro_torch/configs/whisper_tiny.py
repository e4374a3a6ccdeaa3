"""whisper-tiny [audio] — arXiv:2212.04356.

4L encoder + 4L decoder, d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
The conv audio frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings (1500 frames).  Each decoder layer is modeled as a period-2
pair [self-attn (no FFN), cross-attn (+FFN)] — structurally equivalent
params/FLOPs to a standard whisper decoder layer.  Positional encoding is
RoPE (deviation from whisper's sinusoidal/learned absolute; noted in
DESIGN.md, immaterial for the systems study).
"""

from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    groups=(
        LayerGroup(
            (BlockSpec("attn", "none"), BlockSpec("cross_attn", "dense")),
            4,
        ),
    ),
    encoder_groups=(LayerGroup((BlockSpec("bidir_attn", "dense"),), 4),),
    cross_ctx_len=1500,
    rope_theta=1.0e4,
    tie_embeddings=True,
    sub_quadratic=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        groups=(
            LayerGroup(
                (BlockSpec("attn", "none"), BlockSpec("cross_attn", "dense")),
                2,
            ),
        ),
        encoder_groups=(LayerGroup((BlockSpec("bidir_attn", "dense"),), 2),),
        cross_ctx_len=24,
    )
