"""Model FLOPs of a DeepSeek-V2 stage per served request, from the
configuration file: the matmuls of the active weights (MLA in its expanded
form, the dense FFN, the top-k routed and the shared experts, the router)
and attention over the real context, at real lengths (no padding, no
dropless capacity slots)."""


def _per_token(cfg: dict) -> float:
    """Active matmul parameters that one token passes through, all layers."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nh, rh, vh = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, qr = cfg["kv_lora_rank"], cfg["q_lora_rank"]
    mla = (d * qr + qr * H * (nh + rh) + d * (r + rh)
           + r * H * (nh + vh) + H * vh * d)
    f = cfg["moe_intermediate_size"]
    moe = ((cfg["num_experts_per_tok"] + cfg["n_shared_experts"]) * 3 * d * f
           + d * cfg["n_routed_experts"])
    dense = 3 * d * cfg["intermediate_size"]
    total = 0
    for i in range(cfg["num_hidden_layers"]):
        is_moe = i >= cfg["first_k_dense_replace"] and \
            i % cfg["moe_layer_freq"] == 0
        total += mla + (moe if is_moe else dense)
    return total


def request_flops(cfg: dict, n_prompt: int, n_gen: int) -> float:
    """Forward FLOPs of one request: a prefill of ``n_prompt`` tokens, then
    ``n_gen - 1`` decode steps (the last token is never fed back), logits
    for each of the ``n_gen`` tokens sampled."""
    H, L = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    vh = cfg["v_head_dim"]
    fed = n_prompt + n_gen - 1
    # keys each fed token attends to: position j sees j + 1 keys
    keys = fed * (fed + 1) // 2
    attn = 2 * H * (qk + vh) * keys * L
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"] * n_gen
    return 2.0 * _per_token(cfg) * fed + attn + head
