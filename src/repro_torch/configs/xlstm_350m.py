"""xlstm-350m [ssm] — arXiv:2405.04517.

24L d_model=1024 4H vocab=50304, d_ff=0 (blocks carry internal projections).
Strict 1:1 alternation of mLSTM / sLSTM blocks (period-2 x 12).
"""

from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    groups=(
        LayerGroup((BlockSpec("mlstm", "none"), BlockSpec("slstm", "none")), 12),
    ),
    xlstm_proj_factor=2.0,
    xlstm_conv=4,
    tie_embeddings=True,
    sub_quadratic=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        vocab_size=256,
        groups=(
            LayerGroup((BlockSpec("mlstm", "none"), BlockSpec("slstm", "none")), 2),
        ),
    )
