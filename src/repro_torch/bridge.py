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
``opt_state_to_jax`` / ``opt_state_from_jax`` map ``training.optimizer``'s
``OptState`` (``m``/``v`` keyed like the model's parameters) onto the
reference's ``OptState(step, m, v)`` trees and back.  Checkpoints go
through these maps, so either package restores the other's.
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


def _stack_groups(named: Mapping[str, torch.Tensor], groups, blocks: str,
                  prefix: str, tree: dict) -> None:
    """``{blocks}.{n}.<leaf>`` -> ``tree[f"{prefix}{i}"]["b{j}"][...]``
    stacked over group i's repeats (the inverse of ``_groups``)."""
    n = 0
    for i, g in enumerate(groups):
        period = len(g.period)
        gt: dict = {}
        for j in range(period):
            head = f"{blocks}.{n + j}."
            for name in [k[len(head):] for k in named if k.startswith(head)]:
                stacked = torch.stack([
                    named[f"{blocks}.{n + r * period + j}.{name}"]
                    for r in range(g.repeats)])
                _set_path(gt, [f"b{j}"] + name.split("."), stacked)
        tree[f"{prefix}{i}"] = gt
        n += period * g.repeats


def ref_tree(named, cfg: ModelConfig) -> dict:
    """The reference's parameter tree of ``named`` (a ``Model``, or a
    mapping keyed like its ``named_parameters()``: gradients, optimizer
    moments): a nested dict of CPU torch tensors in each leaf's dtype,
    every group leaf stacked over its repeats."""
    if isinstance(named, Model):
        named = dict(named.named_parameters())
    named = {k: v.detach().cpu() for k, v in named.items()}
    tree = {k: named[k] for k in ("embed", "final_norm", "lm_head",
                                  "enc_final_norm") if k in named}
    _stack_groups(named, cfg.groups, "blocks", "g", tree)
    _stack_groups(named, cfg.encoder_groups, "enc_blocks", "enc_g", tree)
    return tree


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
