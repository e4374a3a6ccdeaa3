"""The port's train step over ranks against the reference's for the
reduced qwen3-moe-235b-a22b (expert parallelism, ``moe_impl="ep"``, a
vocab-parallel untied head, q/k norms inside the head-split attention),
and against its own unsharded step for the MoE archs of the registry.

As ``test_torch_train_shard.py`` (the same tolerances and the same
reference runs, ``torch_shard_train_ref``), plus the aux losses with the
batch split over ``"data"``: the reference computes ``moe_lb`` / ``moe_z``
per data shard inside ``moe_ep``'s ``shard_map`` and declares them
replicated (``P()``, ``check_rep=False``).  GSPMD then reports the first
shard's value (device 0's buffer) and its transpose averages the shards'
gradients (each shard's cotangent divided by the unmentioned axes, the
router's gradient summed over them).  The metrics and the weights after
the reference's steps, held here against the port's, pin both; the first
shard's value is also held against the port's unsharded ``loss_fn`` on
that shard's rows.

The port against itself runs ``moe_impl="sort"`` (the whole batch's
routing and capacity, which the reference's GSPMD program also gives),
since ``"ep"`` takes each data shard's capacity and aux losses.
"""

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as LM
from repro_torch.launch import train as T
from repro_torch.models import model as MD
from torch_shard_train_ref import (B, STEPS, assert_metrics_close,
                                   assert_params_close, batches,
                                   port_steps, reference, shardable)

ARCH = "qwen3-moe-235b-a22b"


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


def test_aux_losses_are_the_first_data_shards(ref):
    """Step 0's ``moe_lb`` / ``moe_z`` (the reference's, which the port
    matches above) are those of rows 0..1, the first data shard, under
    the unsharded ``loss_fn`` with the shard's own capacity — not the
    shards' mean."""
    cfg = get_reduced(ARCH).replace(dtype="float32")
    model = MD.Model(cfg, "cpu")
    model.load_state_dict(params_from_jax(ref["init"]))
    toks, labels = batches(cfg.vocab_size, 0)
    per = []
    with torch.no_grad():
        for rows in (slice(0, 2), slice(2, 4)):
            _, m = MD.loss_fn(cfg, model, torch.from_numpy(toks[rows]),
                              torch.from_numpy(labels[rows]),
                              moe_impl="sort", remat=False)
            per.append({k: float(v) for k, v in m.items()})
    want = ref["metrics"][0]
    for k in ("moe_lb", "moe_z"):
        assert per[0][k] == pytest.approx(want[k], rel=1e-5)
        mean = (per[0][k] + per[1][k]) / 2
        assert abs(mean - want[k]) > 1e-4 * abs(want[k]), k


def test_launcher_over_ranks_matches_reference_launcher(ref, ranks):
    argv = ["--device", "cpu", "--arch", ARCH, "--reduced", "--steps",
            str(STEPS), "--batch", str(B), "--seq", "16", "--log-every",
            "100"]
    got = ranks.run(None, T.main, argv, gather=True, init=ref["launch0"])
    for losses in got:
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-3)
        assert losses == got[0]


@pytest.mark.parametrize("arch", shardable(moe=True))
def test_sharded_step_equals_unsharded(arch, ranks):
    named = MD.init_params(get_reduced(arch).replace(dtype="float32"),
                           torch.Generator().manual_seed(1),
                           "cpu").state_dict()
    want, want_p = port_steps(arch, 0, named, steps=2, moe_impl="sort")
    outs = ranks.gather(port_steps, arch, 2, named, 2, "sort")
    for metrics, _ in outs:
        assert_metrics_close(metrics, want)
    assert_params_close(outs[0][1], want_p, steps=2)


def test_expert_parallel_step_on_a_replicated_batch(ranks):
    """``moe_ep`` with a batch the data ranks do not divide (3 rows on
    ``data 2 x model 2``): every data rank routes the whole batch, with
    the whole batch's capacity, so the step equals ``make_step_fn``'s
    ``"ep"`` step on one process."""
    named = MD.init_params(get_reduced(ARCH).replace(dtype="float32"),
                           torch.Generator().manual_seed(2),
                           "cpu").state_dict()
    want, want_p = port_steps(ARCH, 0, named, 2, batch=3)
    outs = ranks.gather(port_steps, ARCH, 2, named, 2, "ep", True, 3)
    for metrics, _ in outs:
        assert_metrics_close(metrics, want)
    assert_params_close(outs[0][1], want_p, steps=2)
