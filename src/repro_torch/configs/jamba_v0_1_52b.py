"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887 / hf:ai21labs/Jamba-v0.1.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Period-8 Jamba block (x4): attention at index 4, Mamba elsewhere (1:7);
MoE FFN on odd indices (every other layer), dense MLP on even indices.
Mamba-1 selective scan: d_state=16, d_conv=4, expand=2.
"""

from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig

_PERIOD = tuple(
    BlockSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    groups=(LayerGroup(_PERIOD, 4),),
    n_experts=16,
    n_shared_experts=0,
    moe_top_k=2,
    d_ff_expert=14336,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=1.0e4,
    sub_quadratic=True,
)


def reduced() -> ModelConfig:
    period = tuple(
        BlockSpec("attn" if i == 2 else "mamba", "moe" if i % 2 == 1 else "dense")
        for i in range(4)
    )
    return CONFIG.replace(
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        groups=(LayerGroup(period, 2),),
        n_experts=4,
        moe_top_k=2,
        d_ff_expert=128,
        mamba_d_state=8,
    )
