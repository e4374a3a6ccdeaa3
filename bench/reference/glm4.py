"""Plain float32 reference of GLM-4-9B as the configuration file gives it:
grouped-query attention (``multi_query_group_num`` key/value heads),
RMSNorm, a SwiGLU feed-forward, with the departures that file lists (no
QKV bias, rotate-half RoPE over every dim of a head, the port's RMSNorm
epsilon).

The weights' names and shapes are the program's parameter names, so the
harness can load the drawn tensors into it; the math here is written from
the published architecture, not from the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from reference.common import Leaf, causal_attention, rms_norm, rope, swiglu

BF16 = torch.bfloat16


def _served(cfg: dict, key: str):
    """The value both sides run: the source's, unless the file lists the
    port's own under ``departed_values``."""
    return cfg.get("departed_values", {}).get(key, cfg[key])


def dims(cfg: dict) -> dict:
    return dict(d=cfg["hidden_size"], H=cfg["num_attention_heads"],
                G=cfg["multi_query_group_num"], hd=cfg["kv_channels"],
                ff=cfg["ffn_hidden_size"], V=cfg["padded_vocab_size"],
                L=cfg["num_layers"], eps=_served(cfg, "layernorm_epsilon"),
                theta=cfg["rope_theta"])


def blocks(cfg: dict) -> List[List[Leaf]]:
    """Weight blocks in draw order: 0 the embedding, 1..L the layers, L+1
    the final norm and output head."""
    m = dims(cfg)
    d, hd = m["d"], m["hd"]
    out: List[List[Leaf]] = [[("embed", (m["V"], d), BF16, 0.02)]]
    for i in range(m["L"]):
        p = f"blocks.{i}."
        out.append([(p + "norm1", (d,), BF16, "norm"),
                    (p + "attn.wq", (d, m["H"] * hd), BF16, "dense"),
                    (p + "attn.wk", (d, m["G"] * hd), BF16, "dense"),
                    (p + "attn.wv", (d, m["G"] * hd), BF16, "dense"),
                    (p + "attn.wo", (m["H"] * hd, d), BF16, "dense"),
                    (p + "norm2", (d,), BF16, "norm"),
                    (p + "ffn.w_gate", (d, m["ff"]), BF16, "dense"),
                    (p + "ffn.w_up", (d, m["ff"]), BF16, "dense"),
                    (p + "ffn.w_down", (m["ff"], d), BF16, "dense")])
    out.append([("final_norm", (d,), BF16, "norm"),
                ("lm_head", (d, m["V"]), BF16, "dense")])
    return out


def port_model(cfg: dict) -> dict:
    """The program's member for this file: its registry arch, the fields
    that set its sizes, and its layer groups as (mixer, ffn, repeats)."""
    m = dims(cfg)
    return dict(arch=cfg["port_arch"], groups=[("attn", "dense", m["L"])],
                fields=dict(d_model=m["d"], n_heads=m["H"], n_kv_heads=m["G"],
                            head_dim=m["hd"], d_ff=m["ff"], vocab_size=m["V"],
                            rope_theta=float(m["theta"]),
                            norm_eps=float(m["eps"]),
                            tie_embeddings=bool(cfg["tie_word_embeddings"]),
                            dtype="bfloat16"))


def _attention(w: Dict[str, torch.Tensor], p: str, x: torch.Tensor,
               m: dict, ar) -> torch.Tensor:
    S, hd = x.shape[0], m["hd"]
    q = rope(ar.mm(x, w[p + "attn.wq"]).view(S, m["H"], hd), m["theta"])
    k = rope(ar.mm(x, w[p + "attn.wk"]).view(S, m["G"], hd), m["theta"])
    v = ar.mm(x, w[p + "attn.wv"]).view(S, m["G"], hd)
    o = causal_attention(q, k, v, 1.0 / math.sqrt(hd))
    return ar.mm(o.reshape(S, m["H"] * hd), w[p + "attn.wo"])


@torch.no_grad()
def forward(cfg: dict, weights: Callable[[int], Dict[str, torch.Tensor]],
            seqs: Sequence[torch.Tensor], spans: Sequence[Tuple[int, int]],
            ar) -> List[torch.Tensor]:
    """Logits (float32) of each sequence of token ids at the positions
    ``[a, b)`` of its span, every sequence from position 0.  ``weights(i)``
    gives block ``i`` (``blocks``' order), one layer at a time; ``ar`` is
    the arithmetic of the linear maps."""
    m = dims(cfg)
    emb = weights(0)["embed"]
    hs = [emb[s].float() for s in seqs]
    del emb
    for i in range(m["L"]):
        w = weights(1 + i)
        p = f"blocks.{i}."
        # one layer's weights prepared once for every sequence
        w = {k: (ar.prep(t) if t.dim() == 2 else t) for k, t in w.items()}
        lin = _Prepped(ar)
        for j, h in enumerate(hs):
            h = h + _attention(w, p, rms_norm(h, w[p + "norm1"], m["eps"]),
                               m, lin)
            x = rms_norm(h, w[p + "norm2"], m["eps"])
            hs[j] = h + swiglu(x, w[p + "ffn.w_gate"], w[p + "ffn.w_up"],
                               w[p + "ffn.w_down"], lin)
        del w
    w = weights(m["L"] + 1)
    return [ar.mm(rms_norm(h[a:b], w["final_norm"], m["eps"]), w["lm_head"])
            for h, (a, b) in zip(hs, spans)]


class _Prepped:
    """``ar`` over weights that ``ar.prep`` has already prepared."""

    def __init__(self, ar):
        self.ar = ar

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (self.ar.act(x) @ w).float()
