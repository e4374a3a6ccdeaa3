"""The train step of the port (``repro.training.train_lib.make_step_fn``'s
twin): ``loss_fn`` under autograd, then one AdamW update.

The reference's ``shardings_for`` / ``build_train_step`` derive mesh
shardings for a jitted step; they wait for the multi-GPU slice.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update


@contextlib.contextmanager
def trainable(params: nn.Module):
    """Gradients on for every parameter inside the block, off again after
    (the model's parameters are made with ``requires_grad=False`` and the
    serving paths expect them so)."""
    ps = list(params.parameters())
    for p in ps:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            yield ps
    finally:
        for p in ps:
            p.requires_grad_(False)


def value_and_grad(cfg: ModelConfig, params: nn.Module, tokens, labels,
                   cross_ctx=None, *, moe_impl: str = "gshard",
                   remat: bool = True):
    """(loss, metrics, grads): ``loss_fn`` and its gradient with respect to
    every parameter, keyed like ``params.named_parameters()`` (zeros for a
    parameter the loss does not reach, as ``jax.grad`` gives)."""
    with trainable(params) as ps:
        loss, metrics = MD.loss_fn(cfg, params, tokens, labels, cross_ctx,
                                   moe_impl=moe_impl, remat=remat)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
    names = [n for n, _ in params.named_parameters()]
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, ps, gs)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_step_fn(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                 moe_impl: str = "gshard", remat: bool = True):
    """``step(params, opt_state, tokens, labels, cross_ctx=None) ->
    (params, opt_state, metrics)``; metrics ``loss``, ``ce``, ``moe_lb``,
    ``moe_z``, ``grad_norm`` and ``lr`` (float32 scalar tensors).  The
    parameters and moments are updated in place."""
    def train_step(params: nn.Module, opt_state: OptState, tokens, labels,
                   cross_ctx: Optional[torch.Tensor] = None):
        dev = params.embed.device
        tokens = torch.as_tensor(tokens).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        loss, metrics, grads = value_and_grad(
            cfg, params, tokens, labels, cross_ctx, moe_impl=moe_impl,
            remat=remat)
        params2, opt_state2, om = adamw_update(opt_cfg, params, grads,
                                               opt_state)
        metrics = dict(metrics, loss=loss, **om)
        return params2, opt_state2, metrics
    return train_step
