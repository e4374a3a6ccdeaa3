"""The port's train step over ``data 2 x model 2`` for the reduced SSM
members — jamba-v0.1-52b (channel-parallel mamba, attention, dense and
expert-parallel MoE FFNs) and xlstm-350m (mLSTM / sLSTM whole on every
rank over a vocab-parallel tied embedding) — against the reference's
sharded step.

The reference runs once per arch, in a subprocess with 4 fake CPU devices
(``torch_shard_train_ref.reference(..., model=2, launch=False)``):
``build_train_step`` on ``make_host_mesh(2)`` at float32, ``STEPS``
steps.  The port runs the same step on 4 ``gloo`` CPU ranks from the
bridged weights.  Mamba's whole 1-D leaves (``conv_b``, ``dt_b``, ``D``)
enter the rank's channels (``layers.enter``), so each rank's partial
gradient of them is summed over "model"; the xLSTM's leaves get the whole
gradient on every rank from its replicated compute.

Tolerances (``torch_shard_train_ref``'s): each step's loss, ``ce``,
``moe_lb``, ``moe_z`` and ``grad_norm`` within rel 1e-5; the weights after
the steps every element within ``2 * lr * steps`` and 99.9% within 1e-5
of their leaf's largest magnitude.  Exact: every leaf the rules keep whole
over "model" is bitwise identical on the two model ranks of each data
row after the steps (one copy); a checkpoint written over the 4 ranks
restores in one process without a mesh to the gathered weights, bit for
bit.
"""

import pytest

from torch_shard_train_ref import check_sharded_step, reference

ARCHS = ("jamba-v0.1-52b", "xlstm-350m")
MODEL = 2


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return {arch: reference(arch, tmp_path_factory.mktemp("ssm_train"),
                            model=MODEL, launch=False) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_ssm_step_matches_reference(refs, arch, tmp_path):
    split = ((".mamba.in_proj", ".mamba.x_proj", ".mamba.A_log",
              ".mamba.out_proj", "embed") if arch.startswith("jamba")
             else ("embed",))
    check_sharded_step(arch, refs[arch], tmp_path, want_split=split)
