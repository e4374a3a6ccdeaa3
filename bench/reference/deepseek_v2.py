"""Plain float32 reference of a DeepSeek-V2 stage: multi-head latent
attention (MLA) and a mixture of experts with shared experts, as the
configuration file gives them, with the departures that file lists under
``departures`` (a softmax top-k over all experts, renormalised, no
``routed_scaling_factor``, plain RoPE on the rope dims, no YaRN).

Attention is the expanded form (keys and values up-projected per head from
the latent), the MoE a loop over the experts that tokens chose.  The
weights' names and shapes are the program's parameter names, so the
harness can load the drawn tensors into it; the math here is written from
the published architecture, not from the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from reference.common import (Leaf, causal_attention, rms_norm, rope,
                              swiglu)

BF16, F32 = torch.bfloat16, torch.float32


def dims(cfg: dict) -> dict:
    return dict(d=cfg["hidden_size"], H=cfg["num_attention_heads"],
                qr=cfg["q_lora_rank"], r=cfg["kv_lora_rank"],
                nh=cfg["qk_nope_head_dim"], rh=cfg["qk_rope_head_dim"],
                vh=cfg["v_head_dim"], ff=cfg["intermediate_size"],
                E=cfg["n_routed_experts"], k=cfg["num_experts_per_tok"],
                f=cfg["moe_intermediate_size"], ns=cfg["n_shared_experts"],
                L=cfg["num_hidden_layers"],
                dense=cfg["first_k_dense_replace"], V=cfg["vocab_size"],
                eps=cfg["rms_norm_eps"], theta=cfg["rope_theta"])


def is_moe(cfg: dict, layer: int) -> bool:
    return layer >= cfg["first_k_dense_replace"] and \
        layer % cfg["moe_layer_freq"] == 0


def blocks(cfg: dict) -> List[List[Leaf]]:
    """Weight blocks in draw order: 0 the embedding, 1..L the layers, L+1
    the final norm and output head."""
    m = dims(cfg)
    d, H = m["d"], m["H"]
    out: List[List[Leaf]] = [[("embed", (m["V"], d), BF16, 0.02)]]
    for i in range(m["L"]):
        p = f"blocks.{i}."
        b = [(p + "norm1", (d,), BF16, "norm"),
             (p + "mla.wq_a", (d, m["qr"]), BF16, "dense"),
             (p + "mla.q_norm", (m["qr"],), BF16, "norm"),
             (p + "mla.wq_b", (m["qr"], H * (m["nh"] + m["rh"])), BF16,
              "dense"),
             (p + "mla.wkv_a", (d, m["r"] + m["rh"]), BF16, "dense"),
             (p + "mla.kv_norm", (m["r"],), BF16, "norm"),
             (p + "mla.wk_b", (H, m["r"], m["nh"]), BF16, "dense"),
             (p + "mla.wv_b", (H, m["r"], m["vh"]), BF16, "dense"),
             (p + "mla.wo", (H * m["vh"], d), BF16, "dense"),
             (p + "norm2", (d,), BF16, "norm")]
        if is_moe(cfg, i):
            fs = m["ns"] * m["f"]
            b += [(p + "moe.router", (d, m["E"]), F32, 0.02),
                  (p + "moe.w_gate", (m["E"], d, m["f"]), BF16, "dense"),
                  (p + "moe.w_up", (m["E"], d, m["f"]), BF16, "dense"),
                  (p + "moe.w_down", (m["E"], m["f"], d), BF16, "dense"),
                  (p + "moe.shared.w_gate", (d, fs), BF16, "dense"),
                  (p + "moe.shared.w_up", (d, fs), BF16, "dense"),
                  (p + "moe.shared.w_down", (fs, d), BF16, "dense")]
        else:
            b += [(p + "ffn.w_gate", (d, m["ff"]), BF16, "dense"),
                  (p + "ffn.w_up", (d, m["ff"]), BF16, "dense"),
                  (p + "ffn.w_down", (m["ff"], d), BF16, "dense")]
        out.append(b)
    out.append([("final_norm", (d,), BF16, "norm"),
                ("lm_head", (d, m["V"]), BF16, "dense")])
    return out


def port_model(cfg: dict) -> dict:
    """The program's member for this file: its registry arch, the fields
    that set its sizes, and its layer groups as (mixer, ffn, repeats)."""
    m = dims(cfg)
    if m["dense"] + sum(is_moe(cfg, i) for i in range(m["L"])) != m["L"]:
        raise ValueError("the port's groups hold leading dense layers, then "
                         "MoE layers only")
    return dict(arch=cfg["port_arch"],
                groups=[("mla", "dense", m["dense"]),
                        ("mla", "moe", m["L"] - m["dense"])],
                fields=dict(d_model=m["d"], n_heads=m["H"],
                            n_kv_heads=cfg["num_key_value_heads"],
                            head_dim=m["nh"], d_ff=m["ff"], vocab_size=m["V"],
                            n_experts=m["E"], n_shared_experts=m["ns"],
                            moe_top_k=m["k"], d_ff_expert=m["f"],
                            q_lora_rank=m["qr"], kv_lora_rank=m["r"],
                            nope_head_dim=m["nh"], rope_head_dim=m["rh"],
                            v_head_dim=m["vh"], rope_theta=float(m["theta"]),
                            norm_eps=float(m["eps"]),
                            tie_embeddings=bool(cfg["tie_word_embeddings"]),
                            dtype="bfloat16"))


def _mla(w: Dict[str, torch.Tensor], p: str, x: torch.Tensor, m: dict,
         ar) -> torch.Tensor:
    """x (S, d) normalised -> attention output (S, d)."""
    S, H = x.shape[0], m["H"]
    nh, rh, r = m["nh"], m["rh"], m["r"]
    q = ar.mm(rms_norm(ar.mm(x, w[p + "mla.wq_a"]), w[p + "mla.q_norm"],
                       m["eps"]), w[p + "mla.wq_b"]).view(S, H, nh + rh)
    kv = ar.mm(x, w[p + "mla.wkv_a"])
    c = rms_norm(kv[:, :r], w[p + "mla.kv_norm"], m["eps"])
    k_pe = rope(kv[:, r:], m["theta"])                          # (S, rh)
    q_pe = rope(q[..., nh:], m["theta"])                        # (S, H, rh)
    # per-head up-projections of the latent
    wk = w[p + "mla.wk_b"].permute(1, 0, 2).reshape(r, H * nh)
    wv = w[p + "mla.wv_b"].permute(1, 0, 2).reshape(r, H * m["vh"])
    k_nope = ar.mm(c, wk).view(S, H, nh)
    v = ar.mm(c, wv).view(S, H, m["vh"])
    qf = torch.cat([q[..., :nh], q_pe], dim=-1)
    kf = torch.cat([k_nope, k_pe[:, None, :].expand(S, H, rh)], dim=-1)
    o = causal_attention(qf, kf, v, 1.0 / math.sqrt(nh + rh))
    return ar.mm(o.reshape(S, H * m["vh"]), w[p + "mla.wo"])


def _moe(w: Dict[str, torch.Tensor], p: str, x: torch.Tensor, m: dict,
         ar) -> torch.Tensor:
    """x (N, d) normalised -> routed top-k experts (weights renormalised)
    plus the shared experts."""
    probs = torch.softmax(ar.mm(x, w[p + "moe.router"]), dim=-1)
    top_p, top_i = torch.topk(probs, m["k"], dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = swiglu(x, w[p + "moe.shared.w_gate"], w[p + "moe.shared.w_up"],
                 w[p + "moe.shared.w_down"], ar)
    for e in torch.unique(top_i).tolist():
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        y = swiglu(x[tok], w[p + "moe.w_gate"][e], w[p + "moe.w_up"][e],
                   w[p + "moe.w_down"][e], ar)
        out.index_add_(0, tok, y * top_p[tok, slot][:, None])
    return out


@torch.no_grad()
def forward(cfg: dict, weights: Callable[[int], Dict[str, torch.Tensor]],
            seqs: Sequence[torch.Tensor], spans: Sequence[Tuple[int, int]],
            ar) -> List[torch.Tensor]:
    """Logits (float32) of each sequence of token ids at the positions
    ``[a, b)`` of its span, every sequence from position 0.  ``weights(i)``
    gives block ``i`` (``blocks``' order), so one layer's weights are held
    at a time; ``ar`` is the arithmetic of the linear maps."""
    m = dims(cfg)
    emb = weights(0)["embed"]
    hs = [emb[s].float() for s in seqs]
    del emb
    for i in range(m["L"]):
        w = weights(1 + i)
        p = f"blocks.{i}."
        hs = [h + _mla(w, p, rms_norm(h, w[p + "norm1"], m["eps"]), m, ar)
              for h in hs]
        xs = [rms_norm(h, w[p + "norm2"], m["eps"]) for h in hs]
        if is_moe(cfg, i):
            x = torch.cat(xs)
            y = _moe(w, p, x, m, ar)
            ys = torch.split(y, [h.shape[0] for h in hs])
        else:
            ys = [swiglu(x, w[p + "ffn.w_gate"], w[p + "ffn.w_up"],
                         w[p + "ffn.w_down"], ar) for x in xs]
        hs = [h + y for h, y in zip(hs, ys)]
        del w
    w = weights(m["L"] + 1)
    return [ar.mm(rms_norm(h[a:b], w["final_norm"], m["eps"]), w["lm_head"])
            for h, (a, b) in zip(hs, spans)]
