"""Weight bridge: the reference's ``init_params`` pytree -> the port's model,
and the reference encoder's params and adapters -> the port's encoder.

The reference stacks each layer group's leaves over a leading repeats axis
(``tree["g{i}"]["b{j}"]["attn"]["wq"]`` is ``(repeats, d, H*hd)``); the
port unrolls them into ``Model.blocks`` in the order group, repeat, period
slot.  ``params_from_jax`` reads every leaf through ``np.asarray`` (numpy
arrays, or anything numpy can convert — this module imports no JAX) and
returns the port's state dict.  bf16 leaves travel through float32, which
is exact; ``load_state_dict`` casts them back to the model's dtype.
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
