"""Train-step builders of the port (``repro.training.train_lib``'s twin).

``make_step_fn`` is the step on one device: ``loss_fn`` under autograd,
then one AdamW update.  ``shardings_for`` gives the specs of a step over a
mesh (any ``.shape`` / ``.axis_names`` mesh: ``launch.mesh.Mesh`` needs no
ranks), and ``build_train_step`` the step itself over a rank mesh of
``launch.mesh``: every rank calls it with the same global batch, cuts its
rows by the tokens spec, and updates its blocks of the parameters and the
moments in place.  It computes the reference's GSPMD step for the same
specs: the same loss, gradient norm, clipping and AdamW update.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules as R
from repro_torch.sharding.ctx import row_axes, sharding_rules
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_update, split_axes)


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
                   remat: bool = True, scale: float = 1.0):
    """(loss, metrics, grads): ``loss_fn`` and the gradient of ``scale *
    loss`` with respect to every parameter, keyed like
    ``params.named_parameters()`` (zeros for a parameter the loss does not
    reach, as ``jax.grad`` gives)."""
    with trainable(params) as ps:
        loss, metrics = MD.loss_fn(cfg, params, tokens, labels, cross_ctx,
                                   moe_impl=moe_impl, remat=remat)
        gs = torch.autograd.grad(loss if scale == 1.0 else loss * scale, ps,
                                 allow_unused=True)
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


def shardings_for(cfg: ModelConfig, mesh, batch: int, seq: int,
                  with_cross: bool) -> dict:
    """The specs of a train step over ``mesh``, keyed as the reference's:
    ``params_shape`` (parameter name -> whole shape), ``param_sharding``
    (name -> spec, ``sharding.rules.param_specs``), ``opt_sharding``
    (``OptState``: ``step`` replicated, ``m``/``v`` as the parameters),
    ``tokens_sharding`` (``batch_spec``) and, ``with_cross``,
    ``cross_sharding``.  ``seq`` is unused, as in the reference."""
    shapes = MD.param_shapes(cfg)
    pspecs = R.param_specs(cfg, shapes, mesh)
    out = {"params_shape": shapes, "param_sharding": pspecs,
           "opt_sharding": OptState(step=R.P(), m=pspecs, v=pspecs),
           "tokens_sharding": R.batch_spec(mesh, batch or None)}
    if with_cross:
        dp = R.maybe(batch, R.batch_axes(mesh), mesh) if batch else \
            R.batch_axes(mesh)
        out["cross_sharding"] = R.P(dp, None, None)
    return out


def _rows(t, spec, mesh, dev) -> torch.Tensor:
    """This rank's block of a global batch tensor under ``spec``."""
    t = torch.as_tensor(t)
    sl = R.block_slices(tuple(t.shape), spec, mesh, mesh.coords)
    return t[sl].to(dev)


def sync_data_grads(grads: dict, specs: dict, mesh) -> None:
    """Sum, over each data axis (``"pod"``, ``"data"``) that a block's spec
    does not split, the rank's gradient of that block — the data-parallel
    gradient sum of a replicated leaf (a split leaf's sum is the
    reduce-scatter of its gather).  One all-reduce per set of axes and
    dtype, in one order on every rank; in place."""
    data = tuple(a for a in mesh.axis_names
                 if a in ("pod", "data") and mesh.shape[a] > 1)
    groups: dict = {}
    for name, g in grads.items():
        own = split_axes(specs[name], mesh)
        axes = tuple(a for a in data if a not in own)
        if axes:
            groups.setdefault((axes, str(g.dtype)), []).append(name)
    for key in sorted(groups):
        names = groups[key]
        flat = mesh.all_reduce(torch.cat([grads[n].reshape(-1)
                                          for n in names]), key[0])
        for n, part in zip(names, torch.split(
                flat, [grads[n].numel() for n in names])):
            grads[n] = part.view(grads[n].shape)


def build_train_step(cfg: ModelConfig, mesh,
                     opt_cfg: Optional[AdamWConfig] = None, *,
                     batch: int = 0, moe_impl: str = "ep", remat: bool = True,
                     donate: bool = True):
    """Returns ``(step, shardings)`` for ``mesh`` (a rank mesh of
    ``launch.mesh``, or a ``SpecMesh``: rank 0's step of a dry run;
    ``shardings`` as ``shardings_for`` gives them).

    ``step(params, opt_state, tokens, labels, cross_ctx=None) -> (params,
    opt_state, metrics)`` runs on every rank of the mesh with the same
    global ``tokens`` / ``labels`` (B, S) (``TokenStream.batch_at``'s) and
    cross context; ``params`` is the rank's sharded ``Model``
    (``init_params(..., mesh=mesh)``) and ``opt_state`` its blocks.  Each
    rank cuts its rows by the tokens spec, runs ``loss_fn`` under
    ``act_rules(mesh, batch)`` with its rows, sums the data-parallel
    gradients, and updates its blocks in place.  The metrics (loss,
    ``ce``, ``moe_lb``, ``moe_z``, ``grad_norm``, ``lr``) are the same on
    every rank.  A batch the data axes do not divide is replicated: every
    rank computes it whole and the gradient is scaled by one over the
    replicas before the data sums.  ``donate`` is accepted for the
    reference's signature and has no effect (the update is in place)."""
    from repro_torch.launch.mesh import RankMesh, SpecMesh
    opt_cfg = opt_cfg or AdamWConfig()
    with_cross = cfg.cross_ctx_len > 0
    sh = shardings_for(cfg, mesh, batch, 0, with_cross)
    rules = R.act_rules(mesh, batch or None)
    data = tuple(a for a in mesh.axis_names if a in ("pod", "data"))

    def train_step(params: nn.Module, opt_state: OptState, tokens, labels,
                   cross_ctx: Optional[torch.Tensor] = None):
        if not isinstance(mesh, (RankMesh, SpecMesh)):
            raise TypeError("build_train_step's step runs over a rank mesh "
                            "(launch.mesh.make_host_mesh / "
                            "make_production_mesh) or, as rank 0 of a dry "
                            "run, a launch.mesh.SpecMesh")
        dev = params.embed.device
        tsp = sh["tokens_sharding"]
        tokens = _rows(tokens, tsp, mesh, dev)
        labels = _rows(labels, tsp, mesh, dev)
        if cross_ctx is not None:
            cross_ctx = _rows(cross_ctx, sh["cross_sharding"], mesh, dev)
        specs = {n: getattr(p, "_spec", None)
                 for n, p in params.named_parameters()}
        with sharding_rules(mesh, rules, rows=True):
            reps = mesh.axis_size(data) // mesh.axis_size(row_axes()) \
                if data else 1
            loss, metrics, grads = value_and_grad(
                cfg, params, tokens, labels, cross_ctx, moe_impl=moe_impl,
                remat=remat, scale=1.0 / reps)
            sync_data_grads(grads, specs, mesh)
            params2, opt_state2, om = adamw_update(opt_cfg, params, grads,
                                                   opt_state, mesh=mesh)
        metrics = dict(metrics, loss=loss, **om)
        return params2, opt_state2, metrics

    return train_step, sh
