"""deepseek-v2-236b [moe] — arXiv:2405.04434 / hf:deepseek-ai/DeepSeek-V2.

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400, MoE 160e top-6,
MLA kv_lora=512 (q_lora=1536, nope=128, rope=64, v=128), 2 shared experts.
Layer 0 uses a dense FFN (intermediate 12288 per the HF config); layers 1-59
are MoE.  The assignment's "(GQA kv=128)" denotes MLA's 128 effective heads
over the shared 512-dim latent.
"""

from repro_torch.models.config import BlockSpec, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,                 # dense layer-0 FFN (HF intermediate_size)
    vocab_size=102400,
    groups=(
        LayerGroup((BlockSpec("mla", "dense"),), 1),
        LayerGroup((BlockSpec("mla", "moe"),), 59),
    ),
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    d_ff_expert=1536,
    q_lora_rank=1536,
    kv_lora_rank=512,
    nope_head_dim=128,
    rope_head_dim=64,
    v_head_dim=128,
    rope_theta=1.0e4,
    norm_eps=1e-6,
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
            LayerGroup((BlockSpec("mla", "dense"),), 1),
            LayerGroup((BlockSpec("mla", "moe"),), 2),
        ),
        n_experts=8,
        n_shared_experts=2,
        moe_top_k=2,
        d_ff_expert=32,
        q_lora_rank=32,
        kv_lora_rank=16,
        nope_head_dim=16,
        rope_head_dim=8,
        v_head_dim=16,
    )
