"""Model FLOPs of GLM-4-9B per served request, from the configuration
file: the matmuls of every weight and attention over the real context, at
real lengths (no padding)."""


def _per_token(cfg: dict) -> float:
    d, H, G = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["multi_query_group_num"])
    hd = cfg["kv_channels"]
    attn = d * H * hd + 2 * d * G * hd + H * hd * d
    ffn = 3 * d * cfg["ffn_hidden_size"]
    return (attn + ffn) * cfg["num_layers"]


def request_flops(cfg: dict, n_prompt: int, n_gen: int) -> float:
    """Forward FLOPs of one request: a prefill of ``n_prompt`` tokens, then
    ``n_gen - 1`` decode steps, logits for each of the ``n_gen`` tokens
    sampled."""
    H, hd = cfg["num_attention_heads"], cfg["kv_channels"]
    fed = n_prompt + n_gen - 1
    keys = fed * (fed + 1) // 2
    attn = 4 * H * hd * keys * cfg["num_layers"]
    head = 2 * cfg["hidden_size"] * cfg["padded_vocab_size"] * n_gen
    return 2.0 * _per_token(cfg) * fed + attn + head
