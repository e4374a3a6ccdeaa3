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

Over a rank mesh the parameters, gradients and moments are each rank's
blocks (``_spec`` on the parameter): ``global_norm`` is then the norm of
the whole, unsharded gradient — each block's sum of squares is summed
over the axes its spec splits, a replicated block counted once — and the
clipping, moments and decay work block by block, as the reference's
ZeRO-3 state lives with its weight shard.
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


def split_axes(spec, mesh) -> tuple:
    """The axes of ``mesh`` (more than one rank each) that ``spec``
    splits, in the mesh's order."""
    used = set()
    for ax in spec or ():
        used.update(ax if isinstance(ax, tuple) else (ax,))
    return tuple(a for a in mesh.axis_names
                 if a in used and mesh.shape[a] > 1)


def global_norm(tree: Mapping[str, Tensor], specs=None,
                mesh=None) -> Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  With
    ``mesh`` (a rank mesh) and ``specs`` (name -> spec), the leaves are
    blocks: the sums of the blocks that share their split axes are summed
    over those axes (one all-reduce per set of axes, in one order on every
    rank), so the result is the whole gradient's norm on every rank."""
    if mesh is None or mesh.size == 1:
        total = None
        for x in tree.values():
            sq = torch.sum(torch.square(x.float()))
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    sums: Dict[tuple, Tensor] = {}
    for name, x in tree.items():
        axes = split_axes(specs.get(name), mesh)
        sq = torch.sum(torch.square(x.float()))
        sums[axes] = sq if axes not in sums else sums[axes] + sq
    total = None
    for axes in sorted(sums):
        s = mesh.all_reduce(sums[axes], axes) if axes else sums[axes]
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: nn.Module,
                 grads: Mapping[str, Tensor], state: OptState, mesh=None):
    """One AdamW step: ``grads`` keyed like ``params.named_parameters()``.
    Updates the parameters and ``state``'s moments in place; returns
    (params, new OptState, {"grad_norm", "lr"}).  ``mesh``: the rank mesh
    whose blocks ``params`` and ``grads`` hold (the norm is the whole
    gradient's)."""
    step = state.step + 1
    specs = {n: getattr(p, "_spec", None)
             for n, p in params.named_parameters()}
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, state.step)
    sf = step.float()
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32,
                           device=sf.device) ** sf
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32,
                           device=sf.device) ** sf
    # the reference's arithmetic, op for op, with the temporaries reused in
    # place (a leaf's update holds four float32 copies of it at most)
    for name, p in params.named_parameters():
        g = grads[name].float() * scale
        m, v = state.m[name], state.v[name]
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        del g
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        decay = cfg.weight_decay if ref_ndim(name, p) >= 2 else 0.0
        upd.add_(pf * decay).mul_(lr)
        p.copy_(pf - upd)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm,
                                                      "lr": lr}
