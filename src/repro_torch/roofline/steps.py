"""The main path's steps as roofline subjects, and their meta twins.

Each of ``prefill`` / ``decode`` / ``train`` returns a ``Step``:
``run()`` runs the step once on its state (repeatable: a decode resets
its positions first, so every run sees the same cache depths), ``held``
the tensors alive before it (the live-bytes tracker's start).  The same call over ``meta_of`` the
state (and ``models.model.Model(cfg, "meta")``) is the step's meta twin:
the same shapes, and the host values of every small integer tensor of
the state (positions, block tables, tokens) for
``roofline.op_cost.CostMode(values=...)``, so the kernels'
data-dependent costs count the same.

The steps are the serving and training entry points a user calls:
``serve_lib``'s paged prefill and decode (the fleet's) and
``train_lib.make_step_fn``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.roofline.op_cost import SHADOW_LIMIT, CostMode
from repro_torch.serving import serve_lib
from repro_torch.training import train_lib
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            init_opt_state)


class Step(NamedTuple):
    run: Callable[[], object]
    held: List[torch.Tensor]


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def meta_of(tree, values: Dict[torch.Tensor, torch.Tensor]):
    """``tree`` (tensors in dicts, lists, tuples, ``OptState``) with every
    tensor replaced by an empty meta tensor of its shape and dtype; each
    small integer tensor's host values go to ``values``."""
    if isinstance(tree, torch.Tensor):
        m = torch.empty(tree.shape, dtype=tree.dtype, device="meta")
        if not tree.is_floating_point() and tree.numel() <= SHADOW_LIMIT:
            values[m] = tree.detach().cpu()
        return m
    if isinstance(tree, dict):
        return {k: meta_of(v, values) for k, v in tree.items()}
    if isinstance(tree, OptState):
        return OptState(*(meta_of(v, values) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_of(v, values) for v in tree)
    return tree


def paged_cache(cfg: ModelConfig, slots: int, max_seq: int, block: int,
                device) -> dict:
    """A paged cache whose ``slots`` rows each own ``max_seq // block``
    blocks of the pool (block 0 is the trash block), at depth 0."""
    mb = max_seq // block
    cache = MD.init_paged_cache(cfg, slots, max_seq, 1 + slots * mb, block,
                                device)
    cache["tbl"].copy_(1 + torch.arange(slots * mb, dtype=torch.int32)
                       .reshape(slots, mb))
    return cache


@torch.no_grad()
def fill(cfg: ModelConfig, params, cache: dict, lens: List[int],
         gen: torch.Generator) -> None:
    """Prefill row b of ``cache`` with ``lens[b]`` random tokens (a fresh
    paged prefill each, as the fleet admits them) and set its depth."""
    pre = serve_lib.make_prefill_paged_fn(cfg, fresh=True)
    dev = cache["pos"].device
    for b, n in enumerate(lens):
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                             device=gen.device, dtype=torch.int32).to(dev)
        pre(params, toks, torch.tensor([n], dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            cache["tbl"][b:b + 1], cache)
    cache["pos"] = torch.tensor(lens, dtype=torch.int32, device=dev)


def prefill(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor,
            row: int = 0) -> Step:
    """The fleet's fresh paged prefill of ``tokens`` (1, S) into ``row``."""
    pre = serve_lib.make_prefill_paged_fn(cfg, fresh=True)
    dev = tokens.device
    S = tokens.shape[1]
    lens = torch.full((1,), S, dtype=torch.int32, device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    tbl = cache["tbl"][row:row + 1]

    @torch.no_grad()
    def run():
        return pre(params, tokens, lens, start, tbl, cache)
    return Step(run, _tensors([params, cache, tokens, lens,
                                          start]))


def decode(cfg: ModelConfig, params, cache: dict,
           tokens: torch.Tensor) -> Step:
    """The fleet's decode step of every row at its depth (``cache["pos"]``
    as it stands: every run starts there and leaves it there)."""
    dec = serve_lib.make_decode_fn(cfg)
    pos0 = cache["pos"]

    @torch.no_grad()
    def run():
        cache["pos"] = pos0
        try:
            return dec(params, tokens, cache)
        finally:
            cache["pos"] = pos0
    return Step(run, _tensors([params, cache, tokens]))


def train(cfg: ModelConfig, params, opt: Optional[OptState],
          tokens: torch.Tensor, labels: torch.Tensor, *,
          opt_cfg: Optional[AdamWConfig] = None, moe_impl: str = "gshard",
          remat: bool = True) -> Step:
    """``make_step_fn``'s step (loss, backward, AdamW in place)."""
    opt = init_opt_state(params) if opt is None else opt
    step = train_lib.make_step_fn(cfg, opt_cfg or AdamWConfig(),
                                  moe_impl=moe_impl, remat=remat)

    def run():
        return step(params, opt, tokens, labels)
    return Step(run, _tensors([params, opt, tokens, labels]))


def trace(step: Step, device, values=None,
          track_memory: bool = True) -> CostMode:
    """Run ``step`` once under a ``CostMode`` on ``device``."""
    with CostMode(device, values=values, track_memory=track_memory,
                  held=step.held) as cm:
        step.run()
    return cm
