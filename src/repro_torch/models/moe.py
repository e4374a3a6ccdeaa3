"""Mixture-of-Experts FFN of the port, for serving (``repro.models.moe``'s
twin, the single-device sort/gather path).

Routing: float32 router logits, softmax, top-k, top-k probabilities
renormalised.  Expert compute: tokens are sorted into per-expert capacity
slots, run through a batched SwiGLU (``torch.bmm``, as the reference
leaves it to XLA einsums) and combined back, plus the shared experts.

On one device the reference's ``moe_impl`` "ep", "ep_serve" and "sort"
all compute ``moe_sort_local`` (with no mesh, or over a one-way "model"
axis, their ``shard_map`` body is ``_sort_core`` over every expert with
identity collectives), so the port runs that for all three.  The
capacity-dropping "gshard" path and the router's auxiliary losses feed
training and arrive with the training slice.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

SORT_IMPLS = ("sort", "ep", "ep_serve")


def _route(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor):
    """x: (N, d) -> (topk_idx (N,k) int64, topk_prob (N,k) float32)."""
    logits = x.float() @ p["router"]                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    topk_prob, topk_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    topk_prob = topk_prob / topk_prob.sum(-1, keepdim=True).clamp_min(1e-9)
    return topk_idx, topk_prob


def _shared_expert(p: Mapping[str, Tensor], x: Tensor) -> Tensor:
    sp = p["shared"]
    return (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]


def _capacity(n_tokens: int, k: int, E: int, cf: float) -> int:
    return max(4, math.ceil(n_tokens * k / E * cf))


def _sort_core(w_gate, w_up, w_down, xf: Tensor, idx: Tensor, prob: Tensor,
               E_loc: int, e_offset: int, C: int) -> Tensor:
    """Routed-expert compute for the experts in [e_offset, e_offset+E_loc).

    xf: (N, d) tokens; idx/prob: (N, k) global routing; weights are the
    local slice (E_loc, ...).  Returns the (N, d) partial output (zeros
    for tokens whose experts live elsewhere).

    The combine is deterministic: the reference scatter-adds each token's
    weighted expert outputs into a zero buffer in the model dtype, in
    expert-major order; here each token's k outputs are added one after
    another in ascending expert id, in the model dtype.  (``index_add_``
    on the card adds with atomics, in an order that changes from run to
    run.)"""
    N, d = xf.shape
    k = idx.shape[1]
    dev = xf.device
    e_local = idx - e_offset                                    # (N, k)
    here = (e_local >= 0) & (e_local < E_loc)

    flat_e = torch.where(here, e_local, E_loc).reshape(-1)      # (N*k,)
    flat_tok = torch.arange(N, device=dev).repeat_interleave(k)
    flat_prob = torch.where(here, prob, 0.0).reshape(-1)

    onehot = F.one_hot(flat_e, E_loc + 1)[:, :E_loc]            # (N*k, E_loc)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos_e = (pos * onehot).sum(-1)                              # (N*k,)
    keep = (pos_e < C) & (flat_e < E_loc)

    # kept entries own distinct slots; dropped ones all land on the extra
    # slot E_loc*C, which is cut off (no host sync for a boolean index)
    slot = torch.where(keep, flat_e * C + pos_e, E_loc * C)
    table = torch.full((E_loc * C + 1,), N, dtype=torch.long, device=dev)
    table[slot] = flat_tok
    table = table[:E_loc * C].reshape(E_loc, C)
    wtable = torch.zeros((E_loc * C + 1,), dtype=torch.float32, device=dev)
    wtable[slot] = flat_prob
    wtable = wtable[:E_loc * C].reshape(E_loc, C)

    xpad = torch.cat([xf, torch.zeros((1, d), dtype=xf.dtype, device=dev)])
    expert_in = xpad[table]                                     # (E_loc, C, d)
    # in place where the reference makes new arrays: at the full-width
    # 479-token prefill each (E, C, d) tensor is ~0.8 GB
    h = F.silu(torch.bmm(expert_in, w_gate)).mul_(torch.bmm(expert_in, w_up))
    del expert_in
    weighted = torch.bmm(h, w_down).mul_(
        wtable[..., None].to(xf.dtype)).reshape(E_loc * C, d)
    del h

    # each (token, choice) reads its slot's row (zeros if dropped), then
    # the k rows are summed in ascending expert id
    per = torch.where(keep[:, None], weighted[slot.clamp_max(E_loc * C - 1)],
                      torch.zeros((), dtype=xf.dtype, device=dev))
    per = per.reshape(N, k, d)
    order = torch.argsort(flat_e.reshape(N, k), dim=1, stable=True)
    per = torch.gather(per, 1, order[..., None].expand(N, k, d))
    out = torch.zeros((N, d), dtype=xf.dtype, device=dev)
    for j in range(k):
        out = out + per[:, j]
    return out


def moe_sort_local(p: Mapping[str, Tensor], cfg: ModelConfig,
                   x: Tensor) -> Tensor:
    """Single-device sort/gather MoE (all experts local): x (B,S,d)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    idx, prob = _route(p, cfg, xf)
    E = cfg.n_experts
    C = _capacity(xf.shape[0], cfg.moe_top_k, E, cfg.moe_capacity_factor)
    out = _sort_core(p["w_gate"], p["w_up"], p["w_down"], xf, idx, prob,
                     E, 0, C).reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + _shared_expert(p, x)
    return out


def check_impl(impl: str) -> None:
    """Raise for a ``moe_impl`` the port does not serve."""
    if impl in SORT_IMPLS:
        return
    if impl == "gshard":
        raise NotImplementedError("moe_impl='gshard' (capacity-dropping "
                                  "dispatch, the training default) is not "
                                  "ported yet: serve with 'ep', 'ep_serve' "
                                  "or 'sort'")
    raise ValueError(f"unknown moe impl {impl!r}")


def moe_apply(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
              impl: str) -> Tensor:
    """The MoE FFN output (B,S,d); the reference also returns the aux
    losses, which only training reads."""
    check_impl(impl)
    return moe_sort_local(p, cfg, x)
