"""Shared by ``tests/test_torch_shard_ssm.py`` and
``tests/test_torch_shard_cross.py``: the reference's sharded fleets of a
few reduced members, served once in a subprocess with 4 fake CPU devices,
and the near-tie rule the port's tokens are held to.

``reference`` runs ``repro.serving.fleet.LocalFleet([arch],
model_axis=M, decode_impl="xla")`` for every arch of ``cases`` (its
``arch_overrides``) and every M of ``models`` on ``data 4 // M x model
M``, and hands back per arch the bridged weights (``"named"``) and per M
the tokens of ``prompts`` and the reference paths of the leaves it splits
over ``"model"``.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.models import model as MD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX = r"""
import sys
import numpy as np
import jax
assert jax.device_count() == 4, jax.device_count()
from repro.serving.fleet import LocalFleet
out = {}
for arch, ov in %(cases)r.items():
    for model in %(models)r:
        fleet = LocalFleet([arch], model_axis=model, warmup=False,
                           arch_overrides={arch: ov}, decode_impl="xla",
                           **%(kw)r)
        assert dict(fleet.mesh.shape) == {"data": 4 // model,
                                          "model": model}
        m = fleet.members[arch]
        split = sorted(
            "/".join(str(getattr(k, "key", k)) for k in path)
            for path, x in jax.tree_util.tree_flatten_with_path(m.params)[0]
            if "model" in tuple(x.sharding.spec))
        out[f"{arch}/{model}/split"] = np.asarray(split)
        outs = fleet.generate(arch, %(prompts)r)
        out[f"{arch}/{model}/tokens"] = np.asarray(
            [o["tokens"] for o in outs], np.int32)
    for path, v in jax.tree_util.tree_flatten_with_path(m.params)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[arch + "/p/" + key] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def reference(out_dir, cases: dict, models, kw: dict, prompts) -> dict:
    """``{arch: {"named": whole weights (the port's keys), M: (tokens per
    prompt, set of split leaf paths)}}`` of the reference's sharded
    fleets (see the module docstring)."""
    out = os.path.join(str(out_dir), "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    script = _JAX % {"cases": cases, "models": tuple(models), "kw": kw,
                     "prompts": list(prompts)}
    proc = subprocess.run([sys.executable, "-c", script, out],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = dict(np.load(out))
    res = {}
    for arch in cases:
        pre = arch + "/p/"
        res[arch] = {"named": params_from_jax(_nest(
            {k[len(pre):]: v for k, v in data.items()
             if k.startswith(pre)}))}
        for model in models:
            res[arch][model] = (data[f"{arch}/{model}/tokens"].tolist(),
                                set(data[f"{arch}/{model}/split"].tolist()))
    return res


def near_tie(cfg, named, ids, out_a, out_b, cross=None, err=1e-4) -> bool:
    """The first position where two token lists of the prompt ``ids``
    differ is a near-tie of the unsharded float32 member (top-2 logit gap
    below ``err``; ``cross``: the request's cross-attention context)."""
    model = MD.Model(cfg, "cpu")
    model.load_state_dict(named)
    i = next(k for k, (a, b) in enumerate(zip(out_a, out_b)) if a != b)
    seq = torch.as_tensor(list(ids) + list(out_a[:i]))[None]
    logits = MD.forward(cfg, model, seq, cross)[0][0, -1]
    top = torch.topk(logits, 2).values
    gap = float(top[0] - top[1])
    print(f"{cfg.name}: near-tie at token {i}: top-2 gap {gap:.3g}")
    return gap < err
