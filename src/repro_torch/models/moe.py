"""Mixture-of-Experts FFN of the port (``repro.models.moe``'s twin, the
single-device paths).

Routing: float32 router logits, softmax, top-k, top-k probabilities
renormalised; the auxiliary losses (Switch-style load balance ``moe_lb``
and router z-loss ``moe_z``) as the reference's ``_route``.  Two expert
paths:

* ``gshard`` — capacity-based dispatch/combine einsums over token groups
  of ``GROUP_SIZE`` (the training default);
* ``sort`` — tokens sorted into per-expert capacity slots, a batched
  SwiGLU (``torch.bmm``, as the reference leaves it to XLA einsums) and
  a deterministic combine.  On one device the reference's "ep" and
  "ep_serve" compute this too (with no mesh, or over a one-way "model"
  axis, their ``shard_map`` body is ``_sort_core`` over every expert with
  identity collectives), so the port runs it for all three.

Both add the shared experts.  ``moe_apply`` returns ``(out, aux)`` as the
reference's; the serving callers pass ``aux=False`` (the aux losses are
then not computed, as XLA drops them from a jitted serving step) and
drop it.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

GROUP_SIZE = 256  # tokens per dispatch group (gshard impl)
SORT_IMPLS = ("sort", "ep", "ep_serve")
IMPLS = ("gshard",) + SORT_IMPLS


def _route(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
           aux: bool = True):
    """x: (N, d) -> (topk_idx (N,k) int64, topk_prob (N,k) float32, aux
    dict ``{"moe_lb", "moe_z"}`` of float32 scalars, or None when ``aux``
    is False)."""
    logits = x.float() @ p["router"]                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    topk_prob, topk_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    topk_prob = topk_prob / topk_prob.sum(-1, keepdim=True).clamp_min(1e-9)
    if not aux:
        return topk_idx, topk_prob, None
    # aux losses (Switch-style load balance + z-loss)
    E = cfg.n_experts
    me = probs.mean(dim=0)                                 # (E,)
    ce = torch.bincount(topk_idx.reshape(-1), minlength=E).float()
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return topk_idx, topk_prob, {"moe_lb": lb_loss, "moe_z": z_loss}


def _shared_expert(p: Mapping[str, Tensor], x: Tensor) -> Tensor:
    sp = p["shared"]
    return (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]


def _one_hot(idx: Tensor, n: int) -> Tensor:
    """``jax.nn.one_hot``: float32, and an index outside [0, n) gives an
    all-zero row (``F.one_hot`` would raise)."""
    inside = (idx >= 0) & (idx < n)
    return F.one_hot(torch.where(inside, idx, n).long(), n + 1)[..., :n] \
        .float()


# ---------------------------------------------------------------------------
# gshard capacity dispatch
# ---------------------------------------------------------------------------

def moe_gshard(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
               aux: bool = True):
    """x: (B, S, d) -> (out (B, S, d), aux).  Tokens in groups of
    ``GROUP_SIZE`` (or S when it does not divide S); each expert takes
    at most ``C = ceil(gs * k / E * cf)`` (token, slot) pairs of a group,
    in token order (exclusive cumsum); the rest are dropped."""
    B, S, d = x.shape
    gs = GROUP_SIZE if S % GROUP_SIZE == 0 else S
    G = B * S // gs
    xg = x.reshape(G, gs, d)

    idx, prob, aux_d = _route(p, cfg, xg.reshape(-1, d), aux)
    k, E = cfg.moe_top_k, cfg.n_experts
    idx = idx.reshape(G, gs, k)
    prob = prob.reshape(G, gs, k)

    C = max(1, math.ceil(gs * k / E * cfg.moe_capacity_factor))

    # position of each (token, slot) in its expert queue, per group
    onehot = _one_hot(idx, E)                                  # (G,gs,k,E)
    flat = onehot.reshape(G, gs * k, E)
    pos = torch.cumsum(flat, dim=1) - flat                     # 0-indexed
    pos_e = (pos.reshape(G, gs, k, E) * onehot).sum(-1)        # (G,gs,k)
    keep = (pos_e < C).float()
    pos_oh = _one_hot(pos_e.long(), C)

    # combine/dispatch tensors (G, gs, E, C)
    combine = torch.einsum("gsk,gske,gskc->gsec", prob * keep, onehot,
                           pos_oh)
    dispatch = (combine > 0).to(x.dtype)

    expert_in = torch.einsum("gsec,gsd->gecd", dispatch, xg)   # (G,E,C,d)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", expert_in, p["w_up"])
    expert_out = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    out = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), expert_out)

    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + _shared_expert(p, x)
    return out, aux_d


# ---------------------------------------------------------------------------
# sort/gather expert compute (no dispatch einsum)
# ---------------------------------------------------------------------------

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


def moe_sort_local(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
                   aux: bool = True):
    """Single-device sort/gather MoE (all experts local): x (B,S,d) ->
    (out (B,S,d), aux)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    idx, prob, aux_d = _route(p, cfg, xf, aux)
    E = cfg.n_experts
    C = _capacity(xf.shape[0], cfg.moe_top_k, E, cfg.moe_capacity_factor)
    out = _sort_core(p["w_gate"], p["w_up"], p["w_down"], xf, idx, prob,
                     E, 0, C).reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + _shared_expert(p, x)
    return out, aux_d


def check_impl(impl: str) -> None:
    """Raise for an unknown ``moe_impl``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}")


def moe_apply(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
              impl: str, *, aux: bool = True):
    """The MoE FFN: x (B,S,d) -> (out (B,S,d), aux ``{"moe_lb",
    "moe_z"}``, or None when ``aux`` is False)."""
    check_impl(impl)
    if impl == "gshard":
        return moe_gshard(p, cfg, x, aux)
    return moe_sort_local(p, cfg, x, aux)
