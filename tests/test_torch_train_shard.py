"""The port's train step over ranks against the reference's, for the
dense reduced llama3.2-1b (tensor-parallel attention and FFN, a tied
vocab-parallel head), and against its own unsharded step.

The reference runs once, in a subprocess with 4 fake CPU devices
(``torch_shard_train_ref.reference``): ``build_train_step`` on ``data 2 x
model 2`` at float32 for 3 steps, and ``repro.launch.train.main`` on
``data 4 x model 1``.  The port runs the same on 4 ``gloo`` CPU ranks
(``launch.mesh.host_ranks(4, device="cpu")``: this process is rank 0).

Tolerances.  Each step's loss, ``ce``, ``moe_lb``, ``moe_z`` and
``grad_norm``: rel 1e-5 (both sides sum in float32, in other orders).
The parameters after the steps: every element within ``2 * lr * steps``
(an element whose gradient rounds to the other sign in one package moves
up to ``2 * lr`` apart in a step: AdamW's first update is ``+-lr`` for any
gradient above ``eps``) and 99.9% of all elements within 1e-5 of their
leaf's largest magnitude (``torch_shard_train_ref.assert_params_close``).  The launchers
run the reduced config at its bf16 on both sides: their losses within rel
1e-3 (a bf16 product rounds at 4e-3; the ranks sum their partial
gradients in float32 where XLA sums in bf16).

Then the port against itself, sharded (``data 2 x model 2``) against
``make_step_fn`` on one process, 2 steps, for every dense arch of the
registry (the MoE archs are in ``test_torch_train_shard_moe.py``; the
cross-attention members take their seeded context,
``torch_shard_train_ref.cross_batch``), and for the SSM members on
``data 4 x model 1``; ``shardings_for`` on the spec-only production mesh against
the reference's specs; ``--production-mesh`` refused below 256 ranks; the
remat recompute in a backward on another thread (as on the card).
"""

import jax
import numpy as np
import pytest
import torch

from repro.models import model as JMD
from repro.sharding import rules as JR
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.launch import mesh as LM
from repro_torch.launch import train as T
from repro_torch.models import model as MD
from repro_torch.sharding import rules as R
from repro_torch.training import train_lib
from torch_shard_train_ref import (B, STEPS, assert_metrics_close,
                                   assert_params_close, port_steps,
                                   reference, shardable)

ARCH = "llama3.2-1b"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def test_production_mesh_needs_256_ranks_without_ranks():
    """(First in the file: the module's ranks are not up yet.)"""
    argv = ["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "1",
            "--production-mesh"]
    with pytest.raises(RuntimeError, match="needs 256 ranks, have 1"):
        T.main(argv)


def test_remat_recompute_carries_the_mesh_to_another_thread():
    """On the card autograd runs the backward — and so the remat
    recompute — on its device thread, where the caller's thread-local
    mesh and rules are not installed; the recompute carries the
    forward's.  Here the forward runs on this thread and the backward on
    another, on a world of one (first in the file: no ranks up), and the
    gradients equal the same-thread ones.  (Without the carried state the
    recompute's ``W`` raises "a sharded parameter used outside its
    mesh's sharding_rules".)"""
    import threading
    from repro_torch.sharding.ctx import sharding_rules
    from repro_torch.training.train_lib import trainable
    from torch_shard_train_ref import batches
    cfg = get_reduced("qwen3-moe-235b-a22b").replace(dtype="float32")
    mesh = LM.make_host_mesh()
    params = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            mesh=mesh)
    toks, labels = (torch.from_numpy(a) for a in batches(cfg.vocab_size, 0))
    grads = []
    with trainable(params) as ps:
        for other in (False, True):
            with sharding_rules(mesh, R.act_rules(mesh, B), rows=True):
                loss, _ = MD.loss_fn(cfg, params, toks, labels, remat=True,
                                     moe_impl="ep")
            if other:
                box = []
                t = threading.Thread(target=lambda: box.append(
                    torch.autograd.grad(loss, ps)))
                t.start()
                t.join()
                assert box, "the backward on another thread failed"
                grads.append(box[0])
            else:
                with sharding_rules(mesh, R.act_rules(mesh, B), rows=True):
                    grads.append(torch.autograd.grad(loss, ps))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(ARCH, tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def ranks():
    with LM.host_ranks(4, device="cpu") as ctl:
        yield ctl


def test_build_train_step_matches_reference(ref, ranks):
    named = params_from_jax(ref["init"])
    outs = ranks.gather(port_steps, ARCH, 2, named)
    for metrics, _ in outs:
        assert_metrics_close(metrics, ref["metrics"])
    assert_params_close(outs[0][1], params_from_jax(ref["after"]))
    for _, whole in outs[1:]:          # every rank gathers the same weights
        for k, v in whole.items():
            assert v.equal(outs[0][1][k]), k


def test_launcher_over_ranks_matches_reference_launcher(ref, ranks,
                                                        capsys):
    argv = ["--device", "cpu", "--arch", ARCH, "--reduced", "--steps",
            str(STEPS), "--batch", str(B), "--seq", "16", "--log-every", "1"]
    got = ranks.run(None, T.main, argv, gather=True, init=ref["launch0"])
    out = capsys.readouterr().out
    assert "mesh={'data': 4, 'model': 1}" in out
    assert out.count("step ") == STEPS          # rank 0 prints
    for losses in got:
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-3)
        assert losses == got[0]


@pytest.mark.parametrize("arch", shardable(moe=False))
def test_sharded_step_equals_unsharded(arch, ranks):
    named = MD.init_params(get_reduced(arch).replace(dtype="float32"),
                           torch.Generator().manual_seed(1),
                           "cpu").state_dict()
    want, want_p = port_steps(arch, 0, named, steps=2)
    outs = ranks.gather(port_steps, arch, 2, named, 2)
    for metrics, _ in outs:
        assert_metrics_close(metrics, want)
    assert_params_close(outs[0][1], want_p, steps=2)


@pytest.mark.parametrize("model,batch", [(1, 2), (2, 3)])
def test_batch_the_data_ranks_do_not_divide(model, batch, ranks):
    """A batch the data axes do not divide (2 rows on ``data 4 x model
    1``, 3 on ``data 2 x model 2``) is replicated, as the reference's
    ``batch_spec`` leaves it: every data rank computes the whole batch and
    its gradient is scaled by one over the replicas before the data sums.
    The step equals ``make_step_fn``'s on one process."""
    named = MD.init_params(get_reduced(ARCH).replace(dtype="float32"),
                           torch.Generator().manual_seed(2),
                           "cpu").state_dict()
    want, want_p = port_steps(ARCH, 0, named, 2, batch=batch)
    outs = ranks.gather(port_steps, ARCH, model, named, 2, "ep", True,
                        batch)
    for metrics, _ in outs:
        assert_metrics_close(metrics, want)
    assert_params_close(outs[0][1], want_p, steps=2)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_data_parallel_ssm_step_equals_unsharded(arch, ranks):
    """The SSM members over data ranks alone: on ``data 4 x model 1``
    their mixers' leaves are gathered whole (FSDP) and each rank runs its
    row of the batch (over a model axis: ``test_torch_train_shard_ssm``
    and the ``data 2 x model 2`` cases above)."""
    named = MD.init_params(get_reduced(arch).replace(dtype="float32"),
                           torch.Generator().manual_seed(1),
                           "cpu").state_dict()
    want, want_p = port_steps(arch, 0, named, steps=2, moe_impl="sort")
    outs = ranks.gather(port_steps, arch, 1, named, 2, "sort")
    for metrics, _ in outs:
        assert_metrics_close(metrics, want)
    assert_params_close(outs[0][1], want_p, steps=2)


@pytest.mark.parametrize("arch", list_archs())
def test_shardings_for_matches_reference_specs(arch):
    """On the spec-only production mesh: the parameter specs leaf for
    leaf (a block leaf's spec is the reference's without its repeats
    entry), the optimizer state's, the tokens' and the cross context's,
    as the reference's ``shardings_for`` derives them."""
    m = LM.Mesh({"data": 16, "model": 16})
    jcfg = __import__("repro.configs", fromlist=["get_config"]) \
        .get_config(arch)
    cfg = get_config(arch)
    pshape = jax.eval_shape(lambda: JMD.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    flat = _flat(JR.param_specs(jcfg, pshape, m))
    for batch in (256, 0):
        sh = train_lib.shardings_for(cfg, m, batch, 0, cfg.cross_ctx_len > 0)
        assert sh["params_shape"] == MD.param_shapes(cfg)
        for name, spec in sh["param_sharding"].items():
            path = R.ref_path(cfg, name)
            want = tuple(flat[path])
            if path.startswith(("g", "enc_g")) and path != "final_norm":
                want = want[1:]
            assert tuple(spec) == want, (name, spec, want)
        opt = sh["opt_sharding"]
        assert tuple(opt.step) == ()
        assert opt.m == sh["param_sharding"] == opt.v
        assert tuple(sh["tokens_sharding"]) == \
            tuple(JR.batch_spec(m, batch or None))
        if cfg.cross_ctx_len:
            dp = JR.maybe(batch, JR.batch_axes(m), m) if batch else \
                JR.batch_axes(m)
            assert tuple(sh["cross_sharding"]) == (dp, None, None)
        else:
            assert "cross_sharding" not in sh


def test_production_mesh_needs_256_ranks(ranks):
    argv = ["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "1",
            "--production-mesh"]
    with pytest.raises(RuntimeError, match="needs 256 ranks, have 4"):
        ranks.gather(T.main, argv)
