"""Weight bridge: the reference's ``init_params`` pytree -> the port's model.

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

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _tensor(leaf) -> torch.Tensor:
    # numpy has no native bfloat16: widen to float32 (exact)
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def params_from_jax(tree: Mapping) -> dict:
    """Reference pytree -> ``Model.state_dict()``-keyed dict of float32
    CPU tensors."""
    state = {"embed": _tensor(tree["embed"]),
             "final_norm": _tensor(tree["final_norm"])}
    if "lm_head" in tree:
        state["lm_head"] = _tensor(tree["lm_head"])
    n = 0
    i = 0
    while f"g{i}" in tree:
        gp = tree[f"g{i}"]
        period = len(gp)
        repeats = np.shape(gp["b0"]["norm1"])[0]
        for r in range(repeats):
            for j in range(period):
                bp = gp[f"b{j}"]
                pre = f"blocks.{n}."
                state[pre + "norm1"] = _tensor(bp["norm1"][r])
                state[pre + "norm2"] = _tensor(bp["norm2"][r])
                for name, leaf in bp["attn"].items():
                    state[pre + f"attn.{name}"] = _tensor(leaf[r])
                for name, leaf in bp["ffn"].items():
                    state[pre + f"ffn.{name}"] = _tensor(leaf[r])
                n += 1
        i += 1
    return state


def model_from_jax(tree: Mapping, cfg: ModelConfig, device="cuda") -> Model:
    """A port ``Model`` for ``cfg`` holding the reference's weights."""
    model = Model(cfg, device)
    model.load_state_dict(params_from_jax(tree))
    return model
