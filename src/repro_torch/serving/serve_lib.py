"""Serving-step builders of the port: contiguous (slot-row) and paged
prefill + decode, and the speculative-decoding steps (wide verify, fused
draft proposal).

The reference jits each step and donates the cache; here every step is a
plain callable that runs eagerly and updates the cache's KV pools in
place, returning the same cache dict so callers keep the reference's
``nxt, cache = step(...)`` shape.  Sampled token ids come back as a device
tensor; the (B, vocab) logits never leave the device.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the logits (first maximum on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_fn(cfg: ModelConfig, *, moe_impl: str = "ep"):
    def prefill_step(params, tokens, cache, cross_ctx=None):
        logits, cache = MD.prefill(cfg, params, tokens, cache, cross_ctx,
                                   moe_impl=moe_impl)
        return greedy(logits), cache
    return prefill_step


def make_prefill_row_fn(cfg: ModelConfig, *, moe_impl: str = "ep"):
    """Length-aware prefill: ``lens`` (B,) marks each row's real prompt
    length; the sampled token comes from each row's last real position,
    not the right-pad tail."""
    def prefill_row(params, tokens, lens, cache, cross_ctx=None):
        logits, cache = MD.prefill(cfg, params, tokens, cache, cross_ctx,
                                   moe_impl=moe_impl, lens=lens)
        return greedy(logits), cache
    return prefill_row


def make_decode_fn(cfg: ModelConfig, *, moe_impl: str = "ep"):
    def serve_step(params, tokens, cache):
        logits, cache = MD.decode_step(cfg, params, tokens, cache,
                                       moe_impl=moe_impl)
        return greedy(logits), cache
    return serve_step


def make_verify_fn(cfg: ModelConfig, *, moe_impl: str = "ep"):
    """Speculative verify: W tokens per row (pending token + W-1 draft
    proposals) through ONE wide forward over the paged cache.  Returns
    the greedy token at EVERY position — ``out[:, t]`` is what a plain
    decode step at depth pos+t would have sampled."""
    def verify_step(params, tokens, cache):
        logits, cache = MD.verify(cfg, params, tokens, cache,
                                  moe_impl=moe_impl)
        return greedy(logits), cache
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
            prev = greedy(logits)
            outs.append(prev)
        outs = torch.stack(outs, dim=1)                  # (B, steps)
        idx = torch.arange(steps - 1, device=outs.device)[None, :] + \
            lag.long()[:, None]                          # (B, steps-1)
        return torch.gather(outs, 1, idx), cache
    return draft_propose


def build_spec_steps(target_cfg: ModelConfig, draft_cfg: ModelConfig, *,
                     moe_impl: str = "ep"):
    """Speculative-decoding step bundle for one text lane: the target-side
    ``verify`` (W-wide paged forward, greedy tokens at all W positions),
    the draft-side ``draft_propose`` (k chained draft decode steps) and the
    draft's own paged admission prefills (``draft_prefill_fresh`` /
    ``draft_prefill_suffix``) for lazy draft-KV catch-up after admission,
    parks and backed-off rounds.  Every cache is updated in place."""
    return {"verify": make_verify_fn(target_cfg, moe_impl=moe_impl),
            "draft_propose": make_draft_propose_fn(draft_cfg,
                                                   moe_impl=moe_impl),
            "draft_prefill_fresh": make_prefill_paged_fn(
                draft_cfg, fresh=True, moe_impl=moe_impl),
            "draft_prefill_suffix": make_prefill_paged_fn(
                draft_cfg, fresh=False, moe_impl=moe_impl)}


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


def build_row_serve_steps(cfg: ModelConfig, *, moe_impl: str = "ep"):
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
    return (make_prefill_row_fn(cfg, moe_impl=moe_impl),
            make_decode_fn(cfg, moe_impl=moe_impl), merge_row)


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
        return greedy(logits), cache
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


def build_paged_serve_steps(cfg: ModelConfig, *, moe_impl: str = "ep"):
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
    return prefill_fresh, prefill_suffix, decode, make_copy_block_fn()
