"""The port's AdamW update and train step against the JAX package's: one
``adamw_update`` with clipping active on reduced deepseek-v2 (stacked 1-D
leaves decayed as the reference decays them), and three ``make_step_fn``
steps on reduced llama3.2-1b against the reference's jitted step.
Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import model as JMD
from repro_torch.bridge import model_from_jax, params_to_jax
from repro_torch.configs import get_reduced


def _tree_like(tree, r, scale):
    return jax.tree.map(
        lambda x: (r.standard_normal(x.shape) * scale).astype(np.float32),
        tree)


def test_adamw_update_matches_jax():
    """One update with clipping active (global norm > 10), moments from
    step 4, lr 1e-2: parameters within 1e-6 absolute, each moment leaf
    within 1e-6 of its max (the global norms differ in summation order,
    so the clipped gradients differ in the last bits).  Decay follows
    the reference's rank: every stacked block leaf (1-D in the port:
    ``norm1``, MLA ``q_norm`` / ``kv_norm``) is decayed, only the
    top-level ``final_norm`` is not."""
    from repro.training import optimizer as JO
    from repro_torch.bridge import (opt_state_from_jax, opt_state_to_jax,
                                    params_from_jax)
    from repro_torch.training import optimizer as O
    arch = "deepseek-v2-236b"
    cj = j_get_reduced(arch).replace(dtype="float32")
    ct = get_reduced(arch).replace(dtype="float32")
    params = JMD.init_params(cj, jax.random.PRNGKey(4))
    r = np.random.default_rng(4)
    grads = _tree_like(params, r, 0.1)
    m = _tree_like(params, r, 0.01)
    v = jax.tree.map(np.abs, _tree_like(params, r, 1e-3))
    jcfg = JO.AdamWConfig(lr=1e-2, warmup_steps=1)
    state = JO.OptState(jnp.asarray(4, jnp.int32), m, v)
    jp, jstate, jom = JO.adamw_update(jcfg, params, grads, state)
    assert float(jom["grad_norm"]) > 10           # clipping active

    model = model_from_jax(params, ct, "cpu")
    tstate = opt_state_from_jax((4, m, v), "cpu")
    tcfg = O.AdamWConfig(lr=1e-2, warmup_steps=1)
    model, tstate, om = O.adamw_update(
        tcfg, model, params_from_jax(grads), tstate)
    np.testing.assert_allclose(float(om["grad_norm"]),
                               float(jom["grad_norm"]), rtol=1e-6)
    assert float(om["lr"]) == float(jom["lr"])
    assert int(tstate.step) == int(jstate.step) == 5
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(params_to_jax(model, ct))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=0)
    got = opt_state_to_jax(tstate, ct)
    for a, b in zip(jax.tree_util.tree_leaves((jstate.m, jstate.v)),
                    jax.tree_util.tree_leaves((got.m, got.v))):
        a = np.asarray(a)
        assert np.abs(b - a).max() <= 1e-6 * np.abs(a).max()
    undecayed = [n for n, p in model.named_parameters()
                 if O.ref_ndim(n, p) < 2]
    assert undecayed == ["final_norm"]
    assert any(n.endswith("norm1") and p.dim() == 1
               for n, p in model.named_parameters())
    # the decay of a stacked 1-D leaf is visible at this lr: without it
    # the reference's norm1 would differ by lr * 0.1 * |p| = 1e-3
    nodecay, _, _ = JO.adamw_update(
        JO.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.0), params,
        grads, state)
    assert np.abs(np.asarray(nodecay["g1"]["b0"]["norm1"]) -
                  np.asarray(jp["g1"]["b0"]["norm1"])).max() > 5e-4


def test_make_step_fn_matches_jax_three_steps():
    """Three train steps on reduced llama3.2-1b (float32, remat, the
    reference's ``TokenStream`` batches and warmup 1) against the
    reference's jitted ``make_step_fn``: every metric within rel 1e-5 per
    step, the parameters after the third within 1e-5 absolute."""
    from repro.data.pipeline import TokenStream as JTokenStream
    from repro.training import optimizer as JO
    from repro.training import train_lib as JT
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_lib import make_step_fn
    arch = "llama3.2-1b"
    cj = j_get_reduced(arch).replace(dtype="float32")
    ct = get_reduced(arch).replace(dtype="float32")
    params = JMD.init_params(cj, jax.random.PRNGKey(5))
    model = model_from_jax(params, ct, "cpu")
    jstep = jax.jit(JT.make_step_fn(cj, JO.AdamWConfig(warmup_steps=2)))
    tstep = make_step_fn(ct, O.AdamWConfig(warmup_steps=2))
    jstate, tstate = JO.init_opt_state(params), O.init_opt_state(model)
    stream = JTokenStream(cj.vocab_size, 2, 16)
    for step in range(3):
        toks, labels = stream.batch_at(step)
        params, jstate, jm = jstep(params, jstate, toks, labels)
        model, tstate, tm = tstep(model, tstate, torch.from_numpy(toks),
                                  torch.from_numpy(labels))
        assert set(tm) == set(jm) == {"loss", "ce", "moe_lb", "moe_z",
                                      "grad_norm", "lr"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-12)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(params_to_jax(model, ct))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)
    assert not any(p.requires_grad for p in model.parameters())
