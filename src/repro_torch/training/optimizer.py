"""AdamW in plain PyTorch (the reference's ``repro.training.optimizer``:
no ``torch.optim``), with global-norm clipping.

The optimizer state (``m``, ``v`` in float32) mirrors the parameters: a
dict keyed like ``Model.named_parameters()`` (``bridge.opt_state_to_jax``
re-stacks it into the reference's tree).  ``adamw_update`` follows the
reference's op order: clip by global norm, bias-corrected moments with
``b ** step``, ``p - lr * (mhat / (sqrt(vhat) + eps) + decay * p)`` in
float32, cast back to the parameter's dtype.  It writes the parameters and
the moments in place.

Weight decay follows the rank of the leaf in the REFERENCE's tree, where
every layer-group leaf carries the stacked repeats axis: the port's
unrolled block tensors are one rank lower, so a 1-D block leaf (``norm1``,
MLA ``q_norm``/``kv_norm``, the SSM vectors) is decayed as in the
reference, and only the top-level 1-D ``final_norm`` / ``enc_final_norm``
are not.  (``torch.optim.AdamW`` differs in its eps, its clipping and its
decay rule.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple

import torch
from torch import nn

Tensor = torch.Tensor
BLOCK_PREFIXES = ("blocks.", "enc_blocks.")


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    step: Tensor                 # () int32
    m: Dict[str, Tensor]         # float32, keyed like named_parameters()
    v: Dict[str, Tensor]


def init_opt_state(params: nn.Module) -> OptState:
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in named.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zeros, v={k: z.clone() for k, z in zeros.items()})


def ref_ndim(name: str, p: Tensor) -> int:
    """The leaf's rank in the reference's tree: block leaves carry the
    stacked repeats axis there."""
    return p.dim() + (1 if name.startswith(BLOCK_PREFIXES) else 0)


def _schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    warm = torch.clamp((step.float() + 1) / max(1, cfg.warmup_steps),
                       max=1.0)
    return cfg.lr * warm


def global_norm(tree: Mapping[str, Tensor]) -> Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: nn.Module,
                 grads: Mapping[str, Tensor], state: OptState):
    """One AdamW step: ``grads`` keyed like ``params.named_parameters()``.
    Updates the parameters and ``state``'s moments in place; returns
    (params, new OptState, {"grad_norm", "lr"})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, state.step)
    sf = step.float()
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32,
                           device=sf.device) ** sf
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32,
                           device=sf.device) ** sf
    for name, p in params.named_parameters():
        g = grads[name].float() * scale
        m, v = state.m[name], state.v[name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        pf = p.float()
        decay = cfg.weight_decay if ref_ndim(name, p) >= 2 else 0.0
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + decay * pf)
        p.copy_(pf.to(p.dtype))
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm,
                                                      "lr": lr}
