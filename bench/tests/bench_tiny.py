"""Small sizes of the benchmark's cells for the CPU tests: each
configuration, mix and encoder with its widths cut, everything else as
the files give it."""

import dataclasses
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from vsrbench import spec as S  # noqa: E402

ENCODER = {"n_layers": 2, "d_model": 64, "n_heads": 4, "d_ff": 128,
           "max_len": 64, "lora_rank": 8, "embed_dim": 64}

SIZES = {
    "deepseek-v2-stage": dict(
        hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
        n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
        num_hidden_layers=3, vocab_size=256),
    "glm4-9b": dict(
        num_layers=2, hidden_size=64, num_attention_heads=4,
        multi_query_group_num=2, kv_channels=16, ffn_hidden_size=128,
        padded_vocab_size=256),
}

MIXES = {
    "decode": dict(clients=8, block=8, prompt_words={"low": 8, "high": 40},
                   answer_tokens=8, slots=4, max_seq=96, max_batch=4,
                   check_sample=2),
    "rag": dict(rate_per_s=20.0, block=8, prompt_words={"low": 20, "high": 70},
                question_words={"low": 2, "high": 6}, answer_tokens=4,
                slots=4, max_seq=96, max_batch=4, check_sample=3),
}


def config(name: str) -> dict:
    return dict(S.load_json(S.ROOT / f"bench/configs/{name}.json"),
                **SIZES[name])


def cell(name: str) -> S.Cell:
    c = S.resolve(name)
    return dataclasses.replace(c, mix=dict(c.mix, **MIXES[c.traffic]),
                               config=config(c.config_name))
