"""Serving-step builders of the port: contiguous (slot-row) and paged
prefill + decode, and the speculative-decoding steps (wide verify, fused
draft proposal).

The reference jits each step and donates the cache; here every step is a
plain callable that runs eagerly and updates the cache's KV pools in
place, returning the same cache dict so callers keep the reference's
``nxt, cache = step(...)`` shape.  Sampled token ids come back as a device
tensor; the (B, vocab) logits never leave the device.

Given a rank ``mesh`` (``launch.mesh``), a builder's steps run a sharded
member: each call installs ``sharding_rules(mesh, act_rules(mesh))`` on
its thread, and every rank of the mesh calls the same step with the same
inputs (the serving fleet's controller sees to it).
"""

from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules as R
from repro_torch.sharding.ctx import current_mesh, sharding_rules


def greedy(logits: torch.Tensor, cfg: ModelConfig = None) -> torch.Tensor:
    """Argmax over the logits (first maximum on ties, as ``jnp.argmax``).
    Logits narrower than ``cfg.vocab_size`` are the rank's vocab shard of
    a sharded member: each rank's (max, first index) pair is gathered over
    ``"model"`` and the greatest value wins, the lowest index on a tie —
    the whole vocabulary's argmax, on every rank."""
    if cfg is None or logits.shape[-1] == cfg.vocab_size:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    mesh = current_mesh()
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    glob = idx + mesh.coords["model"] * logits.shape[-1]
    pairs = mesh.all_gather(
        torch.stack([val.double(), glob.double()], -1)[None], "model", dim=0)
    vals, ids = pairs[..., 0], pairs[..., 1]
    best = vals.amax(0)
    ids = torch.where(vals == best, ids, torch.full_like(ids, float("inf")))
    return ids.amin(0).to(torch.int32)


def on_mesh(mesh):
    """A context installing ``mesh``'s sharding rules (no-op without)."""
    if mesh is None:
        return contextlib.nullcontext()
    return sharding_rules(mesh, R.act_rules(mesh))


def _on_mesh(fn, mesh):
    """``fn`` run inside ``on_mesh(mesh)`` (``fn`` itself without a
    mesh)."""
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def step(*args, **kw):
        with on_mesh(mesh):
            return fn(*args, **kw)
    return step


def make_prefill_fn(cfg: ModelConfig, *, moe_impl: str = "ep"):
    def prefill_step(params, tokens, cache, cross_ctx=None):
        logits, cache = MD.prefill(cfg, params, tokens, cache, cross_ctx,
                                   moe_impl=moe_impl)
        return greedy(logits, cfg), cache
    return prefill_step


def context_or_zeros(cfg: ModelConfig, cross_ctx, batch: int, device):
    """The context a request attends to on a cross-attention member:
    ``cross_ctx``, or zero patches (batch, cross_ctx_len, d) where the
    request brings none (a vision member's text prompt).  None on a
    member without cross-attention."""
    if cross_ctx is not None or not cfg.cross_ctx_len:
        return cross_ctx
    return torch.zeros((batch, cfg.cross_ctx_len, cfg.d_model),
                       dtype=torch_dtype(cfg.dtype), device=device)


def make_prefill_row_fn(cfg: ModelConfig, *, moe_impl: str = "ep"):
    """Length-aware prefill: ``lens`` (B,) marks each row's real prompt
    length; the sampled token comes from each row's last real position,
    not the right-pad tail.  On a cross-attention member a ``cross_ctx``
    of None is a request that brings no context (a vision member's text
    prompt): it attends to zero patches (``context_or_zeros``), made
    here on every rank."""
    def prefill_row(params, tokens, lens, cache, cross_ctx=None):
        cross_ctx = context_or_zeros(cfg, cross_ctx, tokens.shape[0],
                                     tokens.device)
        logits, cache = MD.prefill(cfg, params, tokens, cache, cross_ctx,
                                   moe_impl=moe_impl, lens=lens)
        return greedy(logits, cfg), cache
    return prefill_row


def make_decode_fn(cfg: ModelConfig, *, moe_impl: str = "ep"):
    def serve_step(params, tokens, cache):
        logits, cache = MD.decode_step(cfg, params, tokens, cache,
                                       moe_impl=moe_impl)
        return greedy(logits, cfg), cache
    return serve_step


def make_verify_fn(cfg: ModelConfig, *, moe_impl: str = "ep"):
    """Speculative verify: W tokens per row (pending token + W-1 draft
    proposals) through ONE wide forward over the paged cache.  Returns
    the greedy token at EVERY position — ``out[:, t]`` is what a plain
    decode step at depth pos+t would have sampled."""
    def verify_step(params, tokens, cache):
        logits, cache = MD.verify(cfg, params, tokens, cache,
                                  moe_impl=moe_impl)
        return greedy(logits, cfg), cache
    return verify_step


def make_draft_propose_fn(cfg: ModelConfig, *, moe_impl: str = "ep"):
    """Draft proposal loop: ``steps`` autoregressive draft-model decode
    steps (the reference fuses them in one ``lax.scan``; here a Python
    loop that chains each step's greedy token on the device — no host sync
    per step).

    ``buf`` (B, 2) holds the known-true tokens at draft depths
    ``dpos``/``dpos+1`` and ``lag`` (B,) in {0, 1} is how far the draft
    trails the target (``pos - dpos``): step 0 consumes ``buf[:, 0]``,
    step 1 consumes ``buf[:, 1]`` for lagging rows (else its own step-0
    argmax), later steps chain their own argmax.  Row b's W-1 proposals
    for target positions ``pos+1..`` are the step outputs shifted by its
    lag.  The draft cache pos advances by ``steps``."""
    @torch.no_grad()
    def draft_propose(params, buf, lag, cache, *, steps: int):
        prev = buf[:, 0]
        outs = []
        for j in range(steps):
            if j == 0:
                tok = buf[:, 0]
            elif j == 1:
                tok = torch.where(lag == 1, buf[:, 1], prev)
            else:
                tok = prev
            logits, cache = MD.decode_step(cfg, params, tok[:, None], cache,
                                           moe_impl=moe_impl)
            prev = greedy(logits, cfg)
            outs.append(prev)
        outs = torch.stack(outs, dim=1)                  # (B, steps)
        idx = torch.arange(steps - 1, device=outs.device)[None, :] + \
            lag.long()[:, None]                          # (B, steps-1)
        return torch.gather(outs, 1, idx), cache
    return draft_propose


def build_spec_steps(target_cfg: ModelConfig, draft_cfg: ModelConfig, *,
                     moe_impl: str = "ep", mesh=None):
    """Speculative-decoding step bundle for one text lane: the target-side
    ``verify`` (W-wide paged forward, greedy tokens at all W positions),
    the draft-side ``draft_propose`` (k chained draft decode steps) and the
    draft's own paged admission prefills (``draft_prefill_fresh`` /
    ``draft_prefill_suffix``) for lazy draft-KV catch-up after admission,
    parks and backed-off rounds.  Every cache is updated in place.
    ``mesh``: the steps of a target and draft sharded over its ranks (each
    rank calls them on its blocks)."""
    steps = {"verify": make_verify_fn(target_cfg, moe_impl=moe_impl),
             "draft_propose": make_draft_propose_fn(draft_cfg,
                                                    moe_impl=moe_impl),
             "draft_prefill_fresh": make_prefill_paged_fn(
                 draft_cfg, fresh=True, moe_impl=moe_impl),
             "draft_prefill_suffix": make_prefill_paged_fn(
                 draft_cfg, fresh=False, moe_impl=moe_impl)}
    return {k: _on_mesh(fn, mesh) for k, fn in steps.items()}


@torch.no_grad()
def merge_row(cache: dict, row_cache: dict, slot: int) -> dict:
    """Insert a prefilled batch-1 contiguous cache into batch slot ``slot``
    of the shared decode cache, IN PLACE, over every leaf but ``pos``
    (scheduler-owned).  Leaves are ``(repeats, B, ...)``: the row is axis
    1."""
    for key, group in cache.items():
        if key == "pos":
            continue
        for bkey, leaves in group.items():
            for name, leaf in leaves.items():
                leaf[:, slot] = row_cache[key][bkey][name][:, 0]
    return cache


def build_row_serve_steps(cfg: ModelConfig, *, moe_impl: str = "ep",
                          mesh=None):
    """Continuous-batching serving steps over the contiguous cache.

    Returns ``(prefill_row, decode, merge_row)``:

    * ``prefill_row(params, tokens (1, L), lens (1,), cache1, [cross])`` —
      single-row prefill into a zeroed batch-1 cache; the sampled token is
      taken at the row's last REAL position (``lens``-aware), so bucketed
      right-padding never conditions on pad tokens.
    * ``decode(params, tokens (B, 1), cache)`` — one step over ALL slots;
      ``cache["pos"]`` is a (B,) per-row position vector, so each slot
      writes/attends at its own depth.
    * ``merge_row(cache, row_cache, slot)`` — copy a prefilled batch-1
      cache into batch slot ``slot`` of the shared decode cache, in place
      (``pos`` is scheduler-owned and excluded).
    """
    return (_on_mesh(make_prefill_row_fn(cfg, moe_impl=moe_impl), mesh),
            _on_mesh(make_decode_fn(cfg, moe_impl=moe_impl), mesh), merge_row)


def make_prefill_paged_fn(cfg: ModelConfig, *, fresh: bool,
                          moe_impl: str = "ep"):
    """Paged admission prefill: writes go through the row's block table
    into the shared block pool, so there is no separate merge step.
    ``fresh=True`` is the no-cached-prefix variant (attention on local
    K/V); ``fresh=False`` is the suffix variant (``start`` > 0): rope
    offset by ``start``, attention over the gathered paged view — the
    cached prefix is READ, never recomputed."""
    def prefill_paged(params, tokens, lens, start, tbl_row, cache):
        logits, cache = MD.prefill(cfg, params, tokens, cache,
                                   moe_impl=moe_impl, lens=lens, start=start,
                                   tbl=tbl_row, paged_fresh=fresh)
        return greedy(logits, cfg), cache
    return prefill_paged


def make_copy_block_fn():
    """Device-side copy-on-write: duplicate physical block ``src`` into
    ``dst`` across every KV pool leaf (axis 1 — axis 0 is the layer-group
    repeat dim), in place."""
    @torch.no_grad()
    def copy_block(cache, src, dst):
        src, dst = int(src), int(dst)
        for key, group in cache.items():
            if not key.startswith("g"):
                continue
            for leaves in group.values():
                for leaf in leaves.values():
                    leaf[:, dst] = leaf[:, src]
        return cache
    return copy_block


def build_paged_serve_steps(cfg: ModelConfig, *, moe_impl: str = "ep",
                            mesh=None):
    """Paged continuous-batching serving steps (``moe_impl`` selects the
    MoE FFN of MoE configs, as in the reference).

    Returns ``(prefill_fresh, prefill_suffix, decode, copy_block)``:

    * ``prefill_fresh(params, toks (1,W), lens (1,), start (1,),
      tbl_row (1, max_blocks), cache)`` — admission with no cached
      prefix; KV writes scattered through the table.
    * ``prefill_suffix(...)`` — same signature, ``start > 0``: only the
      unmatched suffix is computed, the matched prefix blocks are read
      through the table.
    * ``decode(params, tokens (B,1), cache)`` — the shared decode step;
      ``cache["tbl"]`` routes each row's reads/writes (freed slots map to
      the trash block).
    * ``copy_block(cache, src, dst)`` — COW for shared blocks.

    The cache (block pool) is updated in place everywhere.
    """
    prefill_fresh = make_prefill_paged_fn(cfg, fresh=True, moe_impl=moe_impl)
    prefill_suffix = make_prefill_paged_fn(cfg, fresh=False,
                                           moe_impl=moe_impl)
    decode = make_decode_fn(cfg, moe_impl=moe_impl)
    return (_on_mesh(prefill_fresh, mesh), _on_mesh(prefill_suffix, mesh),
            _on_mesh(decode, mesh), make_copy_block_fn())


def serve_shardings(cfg: ModelConfig, mesh, batch: int, max_seq: int):
    """The specs of a member served on ``mesh``: ``param_specs`` (the
    port's parameter names -> spec), ``cache_specs`` (the contiguous
    cache's tree of the reference's specs, ``sharding.rules.cache_specs``),
    ``tokens_spec``, and the shapes they apply to (``params_shape``,
    ``cache_shape``; no storage is made).  The port holds the rank's block
    over ``"model"`` of each (``models.model.kv_layout`` for the KV
    leaves) and keeps the batch whole on every rank."""
    params_shape = MD.param_shapes(cfg)
    cache_shape = MD.init_cache(cfg, batch, max_seq, "meta")
    cache_shape = {k: (tuple(v.shape) if not isinstance(v, dict) else
                       {b: {n: tuple(t.shape) for n, t in lv.items()}
                        for b, lv in v.items()})
                   for k, v in cache_shape.items()}
    out = {"params_shape": params_shape,
           "param_specs": R.param_specs(cfg, params_shape, mesh),
           "cache_shape": cache_shape,
           "cache_specs": R.cache_specs(cfg, cache_shape, mesh),
           "tokens_spec": R.batch_spec(mesh, batch)}
    if cfg.cross_ctx_len:
        out["cross_spec"] = R.P(R.maybe(batch, R.batch_axes(mesh), mesh),
                                None, None)
    return out


def build_serve_steps(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                      *, moe_impl: str = "ep", donate: bool = True):
    """Contiguous prefill + decode of a member on ``mesh`` with a scalar
    ``cache["pos"]`` (every row at one depth): ``prefill(params, tokens,
    cache[, cross])`` and ``decode(params, tokens, cache)``, each returning
    (greedy tokens, cache), and ``serve_shardings``.  Every rank of the
    mesh calls them (SPMD) on its blocks — ``init_params(...,
    mesh=mesh)`` and ``init_cache(..., mesh=mesh)``; a
    ``launch.mesh.SpecMesh`` stands as rank 0 of a dry run; under
    ``decode_impl="shardmap"`` the decode is ``smdec``'s split-KV over the
    sequence-sharded cache.  The cache is written in place (``donate`` is
    the reference's keyword and changes nothing here).  ``mesh`` None:
    the unsharded steps, and no specs."""
    sh = None if mesh is None else serve_shardings(cfg, mesh, batch, max_seq)
    prefill = _on_mesh(make_prefill_fn(cfg, moe_impl=moe_impl), mesh)
    decode = _on_mesh(make_decode_fn(cfg, moe_impl=moe_impl), mesh)
    return prefill, decode, sh
