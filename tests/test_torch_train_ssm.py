"""``loss_fn`` and its gradients of the port against the JAX package's for
the SSM archs (jamba: mamba + attention + MoE;
xlstm: mLSTM + sLSTM), reduced, float32, bridged weights; MoE layers
under "gshard" and "sort".  The check and its tolerances are
``test_torch_train.py``'s (loss and metrics within rel 1e-5, each
gradient leaf within 1e-4 of its max |g|).
"""

import pytest

from test_torch_train import SSM_ARCHS, cases, check_loss_and_grads

CASES = cases(SSM_ARCHS)


@pytest.mark.parametrize("arch,impl", CASES,
                         ids=[f"{a}-{i}" for a, i in CASES])
def test_loss_and_grads_match_jax(arch, impl):
    check_loss_and_grads(arch, impl)
