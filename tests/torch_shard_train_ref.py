"""Shared by ``tests/test_torch_train_shard*.py`` and
``tests/test_torch_ckpt_shard.py``: the reference's sharded train step and
launcher, run once in a subprocess with 4 fake CPU devices, and the same
runs on the port's ``gloo`` CPU ranks.

The reference side: ``build_train_step`` on the host mesh
``make_host_mesh(model)`` (``data 2 x model 2`` by default, ``data 1 x
model 4`` with ``model=4``) for the reduced arch at float32, from
``init_params(cfg, PRNGKey(0))``, ``STEPS`` steps on the batches of
``batches`` (and, for a cross-attention config, the context of
``cross_batch``: the compiled step then takes five arguments); then, unless ``launch=False``, ``repro.launch.train.main``
on ``make_host_mesh()`` = ``data 4 x model 1`` (the reduced arch at its
bf16, ``STEPS`` steps of batch 4).  It hands back every step's metrics,
the launcher's losses, the initial weights of both runs and the weights
after the sharded steps (``.npz``).

The port side runs on every rank (``launch.mesh.host_ranks``'
``Controller.gather``): the same step on ``make_host_mesh(2)`` from the
bridged weights (each rank keeps its blocks, ``bridge.shard_params``),
returning the metrics and the whole weights after the steps
(``bridge.whole_params``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, STEPS = 4, 16, 3
LR = 3e-4
KEYS = ("loss", "ce", "moe_lb", "moe_z", "grad_norm")

_JAX = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
assert jax.device_count() == 4, jax.device_count()
sys.path.insert(0, %(tests)r)
from torch_shard_train_ref import batches, cross_batch, B, STEPS
from repro.configs import get_reduced
from repro.launch import train as JT
from repro.launch.mesh import make_host_mesh
from repro.models import model as MD
from repro.sharding import rules as R
from repro.sharding.ctx import sharding_rules
from repro.training import train_lib
from repro.training.optimizer import AdamWConfig, init_opt_state
arch, out, model, launch = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    sys.argv[4] == "1"
cfg = get_reduced(arch).replace(dtype="float32")
mesh = make_host_mesh(model)
assert dict(mesh.shape) == {"data": 4 // model, "model": model}
step, sh = train_lib.build_train_step(cfg, mesh, AdamWConfig(warmup_steps=1),
                                      batch=B, moe_impl="ep")
p0 = MD.init_params(cfg, jax.random.PRNGKey(0))
init = jax.tree.map(np.asarray, p0)     # the step donates its inputs
metrics = []
with sharding_rules(mesh, R.act_rules(mesh, B)):
    params = jax.device_put(p0, sh["param_sharding"])
    opt = jax.device_put(init_opt_state(p0), sh["opt_sharding"])
    for i in range(STEPS):
        toks, labels = batches(cfg.vocab_size, i)
        cross = cross_batch(cfg, i)
        extra = () if cross is None else (jnp.asarray(cross),)
        params, opt, m = step(params, opt, toks, labels, *extra)
        metrics.append({k: float(v) for k, v in m.items()})
losses = JT.main(["--arch", arch, "--reduced", "--steps", str(STEPS),
                  "--batch", str(B), "--seq", "16", "--log-every", "100"]) \
    if launch else []
flat = lambda tree: {
    "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(
        v, np.float32)
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
launch0 = MD.init_params(get_reduced(arch), jax.random.PRNGKey(0))
arrays = {}
for tag, tree in (("init", init), ("after", params), ("launch0", launch0)):
    arrays.update({tag + "/" + k: v for k, v in flat(tree).items()})
np.savez(out, metrics=json.dumps(metrics), losses=json.dumps(losses),
         **arrays)
"""


def batches(vocab: int, step: int, batch: int = B):
    """Global (batch, S) tokens and labels of ``step`` (numpy int32,
    seeded); a few labels masked (-100)."""
    r = np.random.default_rng(100 + step)
    toks = r.integers(0, vocab, (batch, S)).astype(np.int32)
    labels = r.integers(0, vocab, (batch, S)).astype(np.int32)
    labels[0, :3] = -100
    labels[min(3, batch - 1), -2:] = -100
    return toks, labels


def cross_batch(cfg, step: int, batch: int = B):
    """The global (batch, cross_ctx_len, d_model) float32 cross-attention
    context of ``step`` (numpy, seeded: whisper's stub frames, a vision
    member's patches); None for a config without cross-attention."""
    if not cfg.cross_ctx_len:
        return None
    r = np.random.default_rng(200 + step)
    return r.standard_normal((batch, cfg.cross_ctx_len, cfg.d_model)
                             ).astype(np.float32)


def nest(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def reference(arch: str, out_dir, model: int = 2,
              launch: bool = True) -> dict:
    """Run the reference's sharded step over ``data 4 // model x model``
    and, ``launch``, its launcher for ``arch``; returns ``{"metrics",
    "losses", "init", "after", "launch0"}`` (the trees as nested dicts of
    float32 numpy arrays; ``losses`` empty without ``launch``)."""
    out = os.path.join(str(out_dir), "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    script = _JAX % {"tests": os.path.join(ROOT, "tests")}
    proc = subprocess.run([sys.executable, "-c", script, arch, out,
                           str(model), "1" if launch else "0"],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = np.load(out)
    res = {"metrics": json.loads(str(data["metrics"])),
           "losses": json.loads(str(data["losses"]))}
    for tag in ("init", "after", "launch0"):
        res[tag] = nest({k[len(tag) + 1:]: data[k] for k in data.files
                         if k.startswith(tag + "/")})
    return res


def shardable(moe: bool):
    """The registry archs the port shards on ``data 2 x model 2`` (its
    ``check_shardable``: every one), with or without experts."""
    from repro_torch.configs import get_reduced, list_archs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import check_shardable
    out = []
    for arch in list_archs():
        cfg = get_reduced(arch)
        try:
            check_shardable(cfg, Mesh({"data": 2, "model": 2}))
        except NotImplementedError:
            continue
        if bool(cfg.n_experts) == moe:
            out.append(arch)
    return out


def port_steps(arch: str, model: int, named: dict, steps: int = STEPS,
               moe_impl: str = "ep", whole: bool = True, batch: int = B):
    """One rank: ``steps`` sharded steps of the reduced float32 ``arch`` on
    ``make_host_mesh(model)`` from the whole weights ``named`` (``model``
    0: ``make_step_fn`` without a mesh), on global batches of ``batch``
    rows.  Returns (metrics per step, the whole weights after, or None
    without ``whole``)."""
    from repro_torch.bridge import shard_params, whole_params
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.training import train_lib
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    cfg = get_reduced(arch).replace(dtype="float32")
    oc = AdamWConfig(lr=LR, warmup_steps=1)
    if model:
        mesh = LM.make_host_mesh(model)
        params = MD.Model(cfg, "cpu", mesh=mesh)
        params.load_state_dict(shard_params(named, cfg, mesh))
        step, _ = train_lib.build_train_step(cfg, mesh, oc, batch=batch,
                                             moe_impl=moe_impl)
    else:
        mesh = None
        params = MD.Model(cfg, "cpu")
        params.load_state_dict(named)
        step = train_lib.make_step_fn(cfg, oc, moe_impl=moe_impl)
    opt = init_opt_state(params)
    metrics = []
    for i in range(steps):
        toks, labels = batches(cfg.vocab_size, i, batch)
        cross = cross_batch(cfg, i, batch)
        extra = () if cross is None else (torch.from_numpy(cross),)
        params, opt, m = step(params, opt, torch.from_numpy(toks),
                              torch.from_numpy(labels), *extra)
        metrics.append({k: float(m[k]) for k in KEYS})
    if not whole:
        return metrics, None
    if mesh is None:
        return metrics, {k: v.clone() for k, v in params.state_dict().items()}
    return metrics, whole_params(params, params, mesh)


def assert_metrics_close(got, want, rel=1e-5):
    """Every step's ``KEYS`` within ``rel`` of ``want``'s."""
    for i, (g, w) in enumerate(zip(got, want)):
        for k in KEYS:
            assert abs(g[k] - w[k]) <= rel * max(abs(w[k]), 1e-6), \
                (i, k, g[k], w[k])


def assert_params_close(got: dict, want: dict, steps: int = STEPS,
                        lr: float = LR):
    """The parameters after ``steps`` AdamW steps.  AdamW's update is
    about ``lr`` times the sign of the gradient wherever the gradient is
    well above ``eps``, so an element whose gradient rounds to the other
    sign in one package moves up to ``2 * lr`` apart per step.  Rule:
    every element within ``2 * lr * steps`` (plus 1e-5 of its leaf's
    largest magnitude), and at least 99.9% of all the elements within 1e-5
    of their leaf's largest magnitude (the elements no flip reached; a
    leaf of a hundred elements may hold a flip)."""
    assert set(got) == set(want)
    far = total = 0
    for name, w in want.items():
        g = got[name].float()
        w = torch.as_tensor(np.asarray(w, dtype=np.float32)).reshape(
            g.shape) if not isinstance(w, torch.Tensor) else w.float()
        scale = float(w.abs().max()) or 1.0
        d = (g - w).abs()
        assert float(d.max()) <= 2 * lr * steps + 1e-5 * scale, \
            (name, float(d.max()))
        far += int((d > 1e-5 * scale).sum())
        total += d.numel()
    assert far <= 1e-3 * total, (far, total)


def rank_steps(arch, model, named, ckdir):
    """One rank: ``STEPS`` sharded steps of the reduced float32 ``arch`` on
    ``make_host_mesh(model)`` from the whole weights ``named``, then
    its copy of every leaf the rules keep whole over "model", the leaves'
    specs, and a checkpoint of its train state over the mesh."""
    import repro_torch.bridge as BR
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.training import train_lib
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    cfg = get_reduced(arch).replace(dtype="float32")
    mesh = LM.make_host_mesh(model)
    params = MD.Model(cfg, "cpu", mesh=mesh)
    params.load_state_dict(BR.shard_params(named, cfg, mesh))
    step, _ = train_lib.build_train_step(cfg, mesh,
                                         AdamWConfig(lr=LR, warmup_steps=1),
                                         batch=B)
    opt = init_opt_state(params)
    metrics = []
    for i in range(STEPS):
        toks, labels = batches(cfg.vocab_size, i)
        cross = cross_batch(cfg, i)
        extra = () if cross is None else (torch.from_numpy(cross),)
        params, opt, m = step(params, opt, torch.from_numpy(toks),
                              torch.from_numpy(labels), *extra)
        metrics.append({k: float(m[k]) for k in ("loss", "ce", "moe_lb",
                                                 "moe_z", "grad_norm")})
    save_checkpoint(ckdir, STEPS, BR.train_state_tree(params, opt, cfg),
                    {"next_step": STEPS}, mesh=mesh)
    specs = {n: tuple(p._spec) for n, p in params.named_parameters()}
    whole = {n: p.detach().clone() for n, p in params.named_parameters()
             if "model" not in specs[n]}
    return (metrics, BR.whole_params(params, params, mesh), whole, specs,
            mesh.coords)


def check_sharded_step(arch, ref, tmp_path, model=2, want_split=()):
    """The port's sharded steps of ``arch`` on 4 ``gloo`` CPU ranks over
    ``data 4 // model x model`` against the reference's ``ref``
    (``reference(arch, ..., model=model)``): the metrics and the weights
    after the steps (``assert_metrics_close`` / ``assert_params_close``);
    one copy — every leaf the rules keep whole over "model" bitwise equal
    on the model ranks of each data row; the 4 ranks' checkpoint restored
    in one process without a mesh equal to the gathered weights, bit for
    bit.  ``want_split``: leaf-name suffixes that must be split over
    "model"."""
    from repro_torch.bridge import (opt_state_to_jax, params_from_jax,
                                    ref_tree)
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.training import optimizer as O
    named = params_from_jax(ref["init"])
    ckdir = str(tmp_path / "ck")
    with LM.host_ranks(4, device="cpu") as ctl:
        out = ctl.gather(rank_steps, arch, model, named, ckdir)
    metrics, whole, _, specs, _ = out[0]
    for suffix in want_split:
        assert any(n.endswith(suffix) and "model" in s
                   for n, s in specs.items()), suffix
    assert_metrics_close(metrics, ref["metrics"])
    assert all(o[0] == metrics for o in out)
    assert_params_close(whole, params_from_jax(ref["after"]))
    # one copy: a leaf whole over "model" is bitwise equal on the model
    # ranks of its data row
    rows = {}
    for o in out:
        rows.setdefault(o[4]["data"], []).append(o[2])
    assert len(rows) == 4 // model
    for copies in rows.values():
        assert copies[0]
        for name, t in copies[0].items():
            assert all(torch.equal(c[name], t) for c in copies[1:]), name
    # the 4 ranks' checkpoint restores in one process, no mesh
    cfg = get_reduced(arch).replace(dtype="float32")
    solo = MD.Model(cfg, "cpu")
    opt = O.init_opt_state(solo)
    (ptree, _), meta = restore_checkpoint(
        ckdir, STEPS, (ref_tree(solo, cfg), opt_state_to_jax(opt, cfg,
                                                         numpy=False)))
    assert meta == {"next_step": STEPS}
    solo.load_state_dict(params_from_jax(ptree))
    for k, v in solo.state_dict().items():
        assert torch.equal(v, whole[k]), k
