"""Mixture-of-Experts FFN of the port (``repro.models.moe``'s twin).

Routing: float32 router logits, softmax, top-k, top-k probabilities
renormalised; the auxiliary losses (Switch-style load balance ``moe_lb``
and router z-loss ``moe_z``) as the reference's ``_route``.  Two expert
paths:

* ``gshard`` — capacity-based dispatch/combine einsums over token groups
  of ``GROUP_SIZE`` (the training default);
* ``sort`` — tokens sorted into per-expert capacity slots, a batched
  SwiGLU (``torch.bmm``, as the reference leaves it to XLA einsums) and
  a deterministic combine (``moe_sort_local``);
* ``ep`` / ``ep_serve`` — expert parallelism over the ``"model"`` ranks of
  the mesh that ``sharding.ctx`` holds (``moe_ep``, ``moe_ep_serve``):
  rank j computes its experts ``[j * E_loc, (j + 1) * E_loc)`` through
  ``_sort_core`` and the partial outputs are all-reduced.  With no mesh
  they are ``moe_sort_local``, as the reference's without one.

All add the shared experts (tensor-parallel over ``"model"`` where the
rules split their ``d_ff``).  ``moe_apply`` returns ``(out, aux)`` as the
reference's; the serving callers pass ``aux=False`` (the aux losses are
then not computed, as XLA drops them from a jitted serving step) and
drop it.

In the train step the batch rows are split over ``"data"``
(``sharding.ctx.row_axes``).  ``moe_ep`` then takes the rank's rows as
they come, with the capacity of that shard, as the reference's
``shard_map`` body does, and its aux losses are the shard's
(``model.loss_fn`` reduces them as GSPMD does).  ``gshard`` and ``sort``,
which the reference runs over the global batch, gather the rows, compute
the whole batch and keep the rank's rows.  Routing runs replicated over
``"model"``; the tokens and their top-k weights enter the expert-split
compute through ``Mesh.enter``, so the router's gradient is the sum of
every rank's experts' share.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import W, enter, row_parallel_sum, split_over
from repro_torch.sharding.ctx import current_mesh, row_axes

Tensor = torch.Tensor

GROUP_SIZE = 256  # tokens per dispatch group (gshard impl)
SORT_IMPLS = ("sort", "ep", "ep_serve")
IMPLS = ("gshard",) + SORT_IMPLS


def _route(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
           aux: bool = True):
    """x: (N, d) -> (topk_idx (N,k) int64, topk_prob (N,k) float32, aux
    dict ``{"moe_lb", "moe_z"}`` of float32 scalars, or None when ``aux``
    is False)."""
    logits = x.float() @ W(p["router"])                    # (N, E)
    probs = torch.softmax(logits, dim=-1)
    topk_prob, topk_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    topk_prob = topk_prob / topk_prob.sum(-1, keepdim=True).clamp_min(1e-9)
    if not aux:
        return topk_idx, topk_prob, None
    # aux losses (Switch-style load balance + z-loss)
    E = cfg.n_experts
    me = probs.mean(dim=0)                                 # (E,)
    # the count of each expert's (token, slot) pairs, with static shapes
    # (integer counts are exact in float32; ``bincount`` has no meta kernel)
    flat_idx = topk_idx.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, flat_idx, torch.ones(flat_idx.shape, dtype=torch.float32,
                                device=x.device))
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return topk_idx, topk_prob, {"moe_lb": lb_loss, "moe_z": z_loss}


def _shared_expert(p: Mapping[str, Tensor], x: Tensor) -> Tensor:
    """The shared experts' SwiGLU; column-/row-parallel over ``"model"``
    when the rules split their ``d_ff`` (partial outputs all-reduced)."""
    sp = p["shared"]
    x = enter(x, split_over(sp["w_down"]))
    y = (F.silu(x @ W(sp["w_gate"])) * (x @ W(sp["w_up"]))) @ W(sp["w_down"])
    return row_parallel_sum(y, sp["w_down"])


def _one_hot(idx: Tensor, n: int) -> Tensor:
    """``jax.nn.one_hot``: float32, and an index outside [0, n) gives an
    all-zero row.  An equality against ``arange(n)``: the same aten ops on
    every device (``F.one_hot`` range-checks on the host on the CPU,
    scatters on the card and compares on the meta device)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


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

    # under a mesh every rank gathers the whole expert set
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch, xg)   # (G,E,C,d)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in,
                            W(p["w_gate"], model=True)))
    h = h * torch.einsum("gecd,edf->gecf", expert_in,
                         W(p["w_up"], model=True))
    expert_out = torch.einsum("gecf,efd->gecd", h,
                              W(p["w_down"], model=True))
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

    onehot = (flat_e[:, None] ==                                # (N*k, E_loc)
              torch.arange(E_loc, device=dev)).long()
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
    # under a mesh every rank gathers the whole expert set
    out = _sort_core(W(p["w_gate"], model=True), W(p["w_up"], model=True),
                     W(p["w_down"], model=True), xf, idx, prob, E, 0,
                     C).reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + _shared_expert(p, x)
    return out, aux_d


def _ep_mesh(cfg: ModelConfig):
    """(mesh, E_loc) when the experts split over the mesh's ``"model"``
    ranks, else None (no mesh, or ``E % model != 0``)."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return None
    if cfg.n_experts % mesh.shape["model"]:
        return None
    return mesh, cfg.n_experts // mesh.shape["model"]


def moe_ep(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
           aux: bool = True):
    """Expert parallelism over ``"model"``: rank j holds experts
    ``[j * E_loc, (j + 1) * E_loc)``, f-sharded over ``"data"`` (ZeRO-3:
    gathered here); it routes every token (the router is replicated),
    computes its experts' share and the shares are all-reduced over
    ``"model"`` (no all-to-all, no dispatch einsum).  As the reference's
    ``shard_map`` body, each ``"data"`` rank computes its batch shard with
    the capacity of that shard when the batch divides, else the whole
    batch.  Serving holds the whole batch on every rank: the rank cuts its
    shard and the shards are all-gathered, so every rank returns the whole
    batch.  Training (``sharding.ctx.row_axes``): ``x`` is the rank's rows
    already.  No mesh, or ``E % model != 0``: ``moe_sort_local``."""
    ep = _ep_mesh(cfg)
    if ep is None:
        return _global(moe_sort_local, p, cfg, x, aux)
    mesh, E_loc = ep
    B, S, d = x.shape
    E = cfg.n_experts
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    n_dp = mesh.axis_size(dp) if dp else 1
    split = n_dp > 1 and B % n_dp == 0 and not row_axes()
    xl = x
    if split:
        b = B // n_dp
        j = mesh.index(dp)
        xl = x[j * b:(j + 1) * b]
    C = _capacity(max(1, B * S // (n_dp if split else 1)), cfg.moe_top_k, E,
                  cfg.moe_capacity_factor)
    xf = xl.reshape(-1, d)
    idx, prob, aux_d = _route(p, cfg, xf, aux)
    off = mesh.coords["model"] * E_loc
    # routing is replicated over "model"; the tokens and their weights
    # enter the rank's experts
    out = _sort_core(W(p["w_gate"]), W(p["w_up"]), W(p["w_down"]),
                     mesh.enter(xf, "model"), idx, mesh.enter(prob, "model"),
                     E_loc, off, C)
    out = mesh.psum(out, "model").reshape(xl.shape)
    if split:
        out = mesh.all_gather(out, dp, dim=0)
    if cfg.n_shared_experts:
        out = out + _shared_expert(p, x)
    return out, aux_d


def moe_ep_serve(p: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
                 aux: bool = True):
    """Weights-stationary EP for decode: no expert weight moves.  Every
    rank routes the whole batch (the reference all-gathers the token
    shards over ``"data"``; here the batch is whole on every rank),
    computes its experts' share on its local f slice, and the partial
    outputs are all-reduced over ``("data", "model")``.  Falls back as the
    reference's: no mesh -> ``moe_sort_local``; ``E % model`` or
    ``f % data`` nonzero -> ``moe_ep``."""
    ep = _ep_mesh(cfg)
    if ep is None:
        return moe_sort_local(p, cfg, x, aux)
    mesh, E_loc = ep
    if cfg.d_ff_expert % mesh.shape.get("data", 1):
        return moe_ep(p, cfg, x, aux)
    B, S, d = x.shape
    E = cfg.n_experts
    C = _capacity(B * S, cfg.moe_top_k, E, cfg.moe_capacity_factor)
    xf = x.reshape(-1, d)
    idx, prob, aux_d = _route(p, cfg, xf, aux)
    off = mesh.coords["model"] * E_loc
    # the rank's block (E_loc, d, f / data): weights never move
    out = _sort_core(p["w_gate"], p["w_up"], p["w_down"], xf, idx, prob,
                     E_loc, off, C)
    axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    out = mesh.all_reduce(out, axes).reshape(B, S, d)
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
    if impl == "ep":
        return moe_ep(p, cfg, x, aux)
    if impl == "ep_serve":
        return moe_ep_serve(p, cfg, x, aux)
    return _global(moe_gshard if impl == "gshard" else moe_sort_local,
                   p, cfg, x, aux)


def _global(fn, p, cfg: ModelConfig, x: Tensor, aux: bool):
    """``fn`` over the global batch, as the reference's GSPMD program
    computes it (routing and capacity of every row): when ``x`` holds the
    rank's rows of a batch split over ``row_axes()``, the rows are
    gathered and the rank keeps its own of the output."""
    rows = row_axes()
    if not rows:
        return fn(p, cfg, x, aux)
    mesh = current_mesh()
    out, aux_d = fn(p, cfg, mesh.gather(x, rows, 0, grad="sum"), aux)
    return out.narrow(0, mesh.index(rows) * x.shape[0], x.shape[0]), aux_d
