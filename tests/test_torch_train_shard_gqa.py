"""The port's train step over ``data 1 x model 4`` for reduced qwen3-1.7b
(4 query heads split over "model", 2 KV heads that do not split, q/k
norms, a tied vocab-parallel head) against the reference's sharded step.

The reference runs once, in a subprocess with 4 fake CPU devices
(``torch_shard_train_ref.reference(..., model=4, launch=False)``):
``build_train_step`` on ``make_host_mesh(4)`` at float32, ``STEPS``
steps.  The port runs the same step on 4 ``gloo`` CPU ranks from the
bridged weights: ``wk``/``wv``/``k_norm`` are whole on every rank and
enter the rank's query heads' branch (``layers.enter``), so each rank's
partial gradient of them is summed over "model".

Tolerances (``torch_shard_train_ref``'s): each step's loss, ``ce`` and
``grad_norm`` within rel 1e-5; the weights after the steps every element
within ``2 * lr * steps`` and 99.9% within 1e-5 of their leaf's largest
magnitude.  Exact: ``wk``/``wv``/``k_norm`` and every other replicated
leaf bitwise identical on the 4 ranks after the steps (one copy); a
checkpoint written over the 4 ranks restores in one process without a
mesh to the gathered weights, bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.bridge import (opt_state_to_jax, params_from_jax, ref_tree,
                                train_state_tree)
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as LM
from repro_torch.models import model as MD
from repro_torch.training import optimizer as O
from torch_shard_train_ref import (assert_metrics_close, assert_params_close,
                                   port_steps, reference)

ARCH = "qwen3-1.7b"
MODEL = 4
REPLICATED = ("attn.wk", "attn.wv", "attn.k_norm", "attn.q_norm", "norm1")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(ARCH, tmp_path_factory.mktemp("gqa_train"),
                     model=MODEL, launch=False)


def _rank(named, ckdir):
    """One rank: the sharded steps, then this rank's replicated attention
    blocks and a checkpoint of its train state over the mesh."""
    import repro_torch.bridge as BR
    from repro_torch.training import train_lib
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from torch_shard_train_ref import LR, batches, STEPS, B
    cfg = get_reduced(ARCH).replace(dtype="float32")
    mesh = LM.make_host_mesh(MODEL)
    params = MD.Model(cfg, "cpu", mesh=mesh)
    params.load_state_dict(BR.shard_params(named, cfg, mesh))
    step, _ = train_lib.build_train_step(cfg, mesh,
                                         AdamWConfig(lr=LR, warmup_steps=1),
                                         batch=B)
    opt = init_opt_state(params)
    metrics = []
    for i in range(STEPS):
        toks, labels = batches(cfg.vocab_size, i)
        params, opt, m = step(params, opt, torch.from_numpy(toks),
                              torch.from_numpy(labels))
        metrics.append({k: float(m[k]) for k in ("loss", "ce", "moe_lb",
                                                 "moe_z", "grad_norm")})
    save_checkpoint(ckdir, STEPS, train_state_tree(params, opt, cfg),
                    {"next_step": STEPS}, mesh=mesh)
    mine = {n: p.detach().clone() for n, p in params.named_parameters()
            if n.endswith(REPLICATED)}
    specs = {n: p._spec for n, p in params.named_parameters()}
    return metrics, BR.whole_params(params, params, mesh), mine, specs


def test_sharded_gqa_step_matches_reference(ref, tmp_path):
    named = params_from_jax(ref["init"])
    ckdir = str(tmp_path / "ck")
    with LM.host_ranks(MODEL, device="cpu") as ctl:
        out = ctl.gather(_rank, named, ckdir)
    metrics, whole, mine, specs = out[0]
    assert specs["blocks.0.attn.wq"] == ("data", "model")
    assert specs["blocks.0.attn.wk"] == ("data", None)
    assert_metrics_close(metrics, ref["metrics"])
    assert all(o[0] == metrics for o in out)
    assert_params_close(whole, params_from_jax(ref["after"]))
    # one copy: the replicated leaves are bitwise equal on every rank
    assert len(mine) >= 5 * len(get_reduced(ARCH).groups)
    for name, t in mine.items():
        assert all(torch.equal(o[2][name], t) for o in out[1:]), name
        assert torch.equal(whole[name], t), name
    # the 4 ranks' checkpoint restores in one process, no mesh
    cfg = get_reduced(ARCH).replace(dtype="float32")
    model = MD.Model(cfg, "cpu")
    opt = O.init_opt_state(model)
    (ptree, _), meta = restore_checkpoint(
        ckdir, 3, (ref_tree(model, cfg), opt_state_to_jax(opt, cfg,
                                                         numpy=False)))
    assert meta == {"next_step": 3}
    model.load_state_dict(params_from_jax(ptree))
    for k, v in model.state_dict().items():
        assert torch.equal(v, whole[k]), k


def test_sharded_gqa_step_matches_own_unsharded(ref):
    """The same steps over the 4 ranks against ``make_step_fn`` in one
    process (both the port's), within the same tolerances."""
    named = params_from_jax(ref["init"])
    with LM.host_ranks(MODEL, device="cpu") as ctl:
        res = ctl.gather(port_steps, ARCH, MODEL, named)
    solo, after = port_steps(ARCH, 0, named)
    assert_metrics_close(res[0][0], solo)
    assert_params_close(res[0][1], after)
    assert np.isfinite([m["loss"] for m in solo]).all()
