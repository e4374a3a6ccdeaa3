"""Weight bridge between the packages: the reference's ``init_params``
pytree <-> the port's model (both ways), the optimizer state likewise, and
the reference encoder's params and adapters -> the port's encoder.

The reference stacks each layer group's leaves over a leading repeats axis
(``tree["g{i}"]["b{j}"]["attn"]["wq"]`` is ``(repeats, d, H*hd)``); the
port unrolls them into ``Model.blocks`` in the order group, repeat, period
slot.  ``params_from_jax`` reads every leaf through ``np.asarray`` (numpy
arrays, or anything numpy can convert — this module imports no JAX — or
torch tensors) and returns the port's state dict.  bf16 leaves travel through float32, which
is exact; ``load_state_dict`` casts them back to the model's dtype.

``params_to_jax`` is the inverse: it re-stacks ``blocks`` / ``enc_blocks``
over each group's repeats into the reference's nested tree
(``ref_tree`` keeps torch tensors of each leaf's dtype; ``params_to_jax``
gives numpy arrays, bf16 widened to float32 since numpy has no bf16).
``shard_params`` cuts whole weights into one rank's blocks,
``shard_opt_state`` a whole optimizer state, and ``whole_params`` gathers
a rank mesh's blocks back into whole leaves.
``opt_state_to_jax`` / ``opt_state_from_jax`` map ``training.optimizer``'s
``OptState`` (``m``/``v`` keyed like the model's parameters) onto the
reference's ``OptState(step, m, v)`` trees and back.  Checkpoints go
through these maps, so either package restores the other's;
``train_state_tree`` is a sharded train state as the reference's tree of
``checkpoint.ckpt.Blocks``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _tensor(leaf) -> torch.Tensor:
    # numpy has no native bfloat16: widen to float32 (exact)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().float()
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def _block_leaves(prefix: str, tree: Mapping, r: int, state: dict) -> None:
    """Repeat ``r`` of every leaf under ``tree``, nested keys joined with
    dots (``moe.shared.w_gate``) as ``nn.ParameterDict`` names them."""
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            _block_leaves(f"{prefix}{name}.", leaf, r, state)
        else:
            state[prefix + name] = _tensor(leaf[r])


def _groups(tree: Mapping, prefix: str, blocks: str, state: dict) -> None:
    """Unroll the reference's ``{prefix}{i}`` groups into ``{blocks}.{n}``
    in the order group, repeat, period slot."""
    n = 0
    i = 0
    while f"{prefix}{i}" in tree:
        gp = tree[f"{prefix}{i}"]
        period = len(gp)
        repeats = np.shape(gp["b0"]["norm1"])[0]
        for r in range(repeats):
            for j in range(period):
                _block_leaves(f"{blocks}.{n}.", gp[f"b{j}"], r, state)
                n += 1
        i += 1


def params_from_jax(tree: Mapping) -> dict:
    """Reference pytree -> ``Model.state_dict()``-keyed dict of float32
    CPU tensors.  Each group's blocks map leaf for leaf (``norm1``, the
    mixer's ``attn`` / ``mla`` / ``mamba`` / ``mlstm`` / ``slstm`` leaves
    with the sLSTM's own ``ffn``, ``norm2``, ``ffn`` or ``moe`` with its
    ``shared`` experts), so groups of different kinds (deepseek's dense
    layer 0 and its MoE layers, jamba's period of eight) need nothing
    special; float32 leaves (the router, the SSM gates and decays) stay
    float32.  The whisper encoder's ``enc_g{i}`` groups become
    ``enc_blocks``, beside ``enc_final_norm``."""
    state = {"embed": _tensor(tree["embed"]),
             "final_norm": _tensor(tree["final_norm"])}
    for name in ("lm_head", "enc_final_norm"):
        if name in tree:
            state[name] = _tensor(tree[name])
    _groups(tree, "g", "blocks", state)
    _groups(tree, "enc_g", "enc_blocks", state)
    return state


def _set_path(tree: dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


TOP_LEAVES = ("embed", "final_norm", "lm_head", "enc_final_norm")


def _stack_groups(names, groups, blocks: str, prefix: str, tree: dict,
                  make) -> None:
    """``{blocks}.{n}.<leaf>`` -> ``tree[f"{prefix}{i}"]["b{j}"][...]`` =
    ``make(port names of group i's repeats)`` (the inverse of
    ``_groups``)."""
    n = 0
    for i, g in enumerate(groups):
        period = len(g.period)
        gt: dict = {}
        for j in range(period):
            head = f"{blocks}.{n + j}."
            for name in [k[len(head):] for k in names if k.startswith(head)]:
                _set_path(gt, [f"b{j}"] + name.split("."), make([
                    f"{blocks}.{n + r * period + j}.{name}"
                    for r in range(g.repeats)]))
        tree[f"{prefix}{i}"] = gt
        n += period * g.repeats


def _tree(names, cfg: ModelConfig, top, stacked) -> dict:
    """The reference's tree over the port's parameter ``names``: ``top(name)``
    at a top-level leaf, ``stacked(names of the repeats)`` at a group's."""
    tree = {k: top(k) for k in TOP_LEAVES if k in names}
    _stack_groups(names, cfg.groups, "blocks", "g", tree, stacked)
    _stack_groups(names, cfg.encoder_groups, "enc_blocks", "enc_g", tree,
                  stacked)
    return tree


def ref_tree(named, cfg: ModelConfig) -> dict:
    """The reference's parameter tree of ``named`` (a ``Model``, or a
    mapping keyed like its ``named_parameters()``: gradients, optimizer
    moments): a nested dict of CPU torch tensors in each leaf's dtype,
    every group leaf stacked over its repeats."""
    if isinstance(named, Model):
        named = dict(named.named_parameters())
    named = {k: v.detach().cpu() for k, v in named.items()}
    return _tree(named, cfg, named.__getitem__,
                 lambda ns: torch.stack([named[n] for n in ns]))


def blocks_tree(named, model: Model, cfg: ModelConfig) -> dict:
    """The reference's tree of a sharded ``model``'s blocks (``named``: the
    model, or a mapping of blocks keyed like its parameters — optimizer
    moments) as ``checkpoint.ckpt.Blocks``: each leaf's whole shape and
    spec from ``model``'s parameter (a group leaf stacked over its
    repeats: a leading repeats dim, replicated), its dtype and this rank's
    block from ``named``."""
    from repro_torch.checkpoint.ckpt import Blocks
    params = dict(model.named_parameters())
    if isinstance(named, Model):
        named = params

    def top(n):
        p = params[n]
        return Blocks(p._full, p._spec, named[n].dtype,
                      lambda: named[n].detach())

    def stacked(ns):
        p = params[ns[0]]
        return Blocks((len(ns),) + tuple(p._full), (None,) + tuple(p._spec),
                      named[ns[0]].dtype,
                      lambda: torch.stack([named[n].detach() for n in ns]))

    return _tree(params, cfg, top, stacked)


def train_state_tree(params: Model, opt_state, cfg: ModelConfig):
    """A sharded train state ``(params, OptState)`` as the reference's
    checkpoint tree ``(params, OptState(step, m, v))`` of ``Blocks`` (the
    step a CPU tensor): what ``checkpoint.save_checkpoint(..., mesh=)``
    writes, and the target its restore fills with this rank's blocks."""
    return (blocks_tree(params, params, cfg),
            type(opt_state)(opt_state.step.detach().cpu(),
                            blocks_tree(opt_state.m, params, cfg),
                            blocks_tree(opt_state.v, params, cfg)))


def to_numpy(tree):
    """A tree of torch tensors -> the same tree of numpy arrays (bf16 and
    float16 widened to float32, exactly)."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    t = tree.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def params_to_jax(named, cfg: ModelConfig) -> dict:
    """The port's parameters (a ``Model`` or a ``named_parameters()``-keyed
    mapping, e.g. gradients) -> the reference's ``init_params`` tree of
    numpy arrays; float32 and integer leaves keep their dtype, bf16 leaves
    come as float32 (exact)."""
    return to_numpy(ref_tree(named, cfg))


def opt_state_to_jax(state, cfg: ModelConfig, numpy: bool = True):
    """``training.optimizer.OptState`` -> the reference's ``OptState``
    layout ``(step, m, v)`` with ``m``/``v`` as parameter trees (numpy
    arrays, or CPU torch tensors with ``numpy=False``)."""
    out = type(state)(state.step.detach().cpu(), ref_tree(state.m, cfg),
                      ref_tree(state.v, cfg))
    return to_numpy(out) if numpy else out


def opt_state_from_jax(tree, device="cuda"):
    """The reference's ``OptState(step, m, v)`` (or any ``(step, m, v)``
    triple of trees) -> the port's ``OptState``: ``m``/``v`` float32 and
    keyed like the model's parameters, ``step`` an int32 scalar, on
    ``device``."""
    from repro_torch.training.optimizer import OptState
    dev = resolve_device(device)
    step, m, v = tree

    def named(t):
        return {k: x.to(dev) for k, x in params_from_jax(t).items()}

    return OptState(torch.as_tensor(np.array(step), dtype=torch.int32)
                    .to(dev), named(m), named(v))


def shard_params(named: Mapping[str, torch.Tensor], cfg: ModelConfig, mesh,
                 rank: int = None) -> dict:
    """Whole weights (a ``Model``, or ``state_dict()`` / ``params_from_jax``
    keys) -> the blocks that ``rank`` of ``mesh`` holds under
    ``sharding.rules.param_specs`` (``rank`` defaults to the mesh's own):
    each block a contiguous tensor carrying its ``_spec``, ready for a
    sharded model's ``load_state_dict``."""
    from repro_torch.sharding import rules as R
    if isinstance(named, Model):
        named = dict(named.named_parameters())
    coords = mesh.coords if rank is None else mesh.coords_of(rank)
    out = {}
    for name, t in named.items():
        spec = R.param_spec(cfg, name, tuple(t.shape), mesh)
        block = t.detach()[R.block_slices(tuple(t.shape), spec, mesh,
                                          coords)].contiguous()
        block._spec = spec
        out[name] = block
    return out


def shard_opt_state(tree, cfg: ModelConfig, mesh, device="cuda"):
    """A whole optimizer state (the reference's ``OptState(step, m, v)``
    trees, or any ``(step, m, v)`` triple) -> the port's ``OptState``
    holding this rank's blocks of ``m`` and ``v`` under the parameters'
    specs, on ``device``."""
    state = opt_state_from_jax(tree, "cpu")
    dev = resolve_device(device)

    def cut(named):
        return {k: v.to(dev) for k, v in
                shard_params(named, cfg, mesh).items()}

    return type(state)(state.step.to(dev), cut(state.m), cut(state.v))


def whole_params(named, model: Model, mesh) -> dict:
    """Whole leaves from a rank's blocks: ``named`` (a sharded ``model``,
    or a mapping of its blocks: gradients, moments) -> name -> the whole
    tensor on the CPU, on every rank (an all-gather per sharded dim of
    each leaf, in one order on every rank)."""
    params = dict(model.named_parameters())
    if isinstance(named, Model):
        named = params
    out = {}
    for name, t in named.items():
        t = t.detach()
        for dim, ax in enumerate(getattr(params[name], "_spec", ())):
            if ax is not None:
                t = mesh.all_gather(t, ax, dim)
        out[name] = t.cpu()
    return out


def model_from_jax(tree: Mapping, cfg: ModelConfig, device="cuda") -> Model:
    """A port ``Model`` for ``cfg`` holding the reference's weights."""
    model = Model(cfg, device)
    model.load_state_dict(params_from_jax(tree))
    return model


def encoder_from_jax(params: Mapping, adapters: Mapping, device="cuda"):
    """The reference encoder's ``init_encoder`` params and
    ``init_adapters`` trees (numpy arrays, or anything numpy converts) ->
    the port encoder's ``(params, adapters)`` dicts of float32 tensors on
    ``device``, leaf for leaf (float32 -> float32 is exact)."""
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, Mapping):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return _tensor(tree).to(dev)

    return conv(params), conv(adapters)
