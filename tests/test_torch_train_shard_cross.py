"""The port's train step over ranks for the reduced cross-attention members
— whisper-tiny (the encoder over stub frames, cross-attention in every
decoder layer) and llama-3.2-vision-90b (self- and cross-attention over
patch embeddings) — against the reference's sharded step, whose compiled
form takes five arguments: ``params, opt, tokens, labels, cross_ctx``.

The reference runs once per case, in a subprocess with 4 fake CPU devices
(``torch_shard_train_ref.reference(..., launch=False)``): whisper and
vision on ``data 2 x model 2``, vision also on ``data 1 x model 4``, where
its 4 query heads split while its 2 KV heads stay whole (``wk``/``wv``
enter the rank's query heads' branch of the cross-attention too, so each
rank's partial gradient of them is summed over "model").  Both packages
take the same seeded context (``torch_shard_train_ref.cross_batch``), cut
to each data rank's rows.

Tolerances and exact checks are ``torch_shard_train_ref.
check_sharded_step``'s: metrics within rel 1e-5, the weights after the
steps within ``2 * lr * steps`` (99.9% within 1e-5 of the leaf's largest
magnitude), every leaf whole over "model" bitwise equal on the model ranks
of a data row, and the 4 ranks' checkpoint restored unsharded bit for
bit.

The launcher (``launch/train.py``) over 2 data ranks trains whisper and
jamba (cut by ``--layers`` to one period) with the same losses on every
rank, whisper's within rel 1e-3 of its one-process run (the reduced
config at its bf16; the ranks sum their rows' gradients in float32).
"""

import numpy as np
import pytest

from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as LM
from repro_torch.launch import train as T
from torch_shard_train_ref import check_sharded_step, reference

CASES = (("whisper-tiny", 2), ("llama-3.2-vision-90b", 2),
         ("llama-3.2-vision-90b", 4))


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return {case: reference(case[0], tmp_path_factory.mktemp("cross_train"),
                            model=case[1], launch=False) for case in CASES}


@pytest.mark.parametrize("arch,model", CASES)
def test_sharded_cross_step_matches_reference(refs, arch, model, tmp_path):
    split = (".attn.wq", ".attn.wo", ".ffn.w_down")
    if model == 2:
        split += (".attn.wk",)
    check_sharded_step(arch, refs[(arch, model)], tmp_path, model=model,
                       want_split=split)


@pytest.mark.parametrize("arch,layers", [("whisper-tiny", 0),
                                         ("jamba-v0.1-52b", 4)])
def test_launcher_over_ranks_trains_mixer_members(arch, layers):
    """Jamba's MoE routes each data rank's rows within their own capacity
    (as the reference's ``moe_ep`` routes each shard's), so its losses
    are held for agreement between the ranks and against the cut; the
    whisper run equals the one-process run."""
    argv = ["--device", "cpu", "--arch", arch, "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "16", "--log-every", "100",
            "--layers", str(layers)]
    with LM.host_ranks(2, device="cpu") as ctl:
        got = ctl.gather(T.main, argv)
    assert got[0] == got[1] and len(got[0]) == 2
    assert np.isfinite(got[0]).all()
    if layers:
        cfg = T.cut_depth(get_reduced(arch), layers)
        assert cfg.n_blocks == layers < get_reduced(arch).n_blocks
        with pytest.raises(ValueError, match="whole periods"):
            T.cut_depth(get_reduced(arch), layers + 1)
    else:
        np.testing.assert_allclose(got[0], T.main(argv), rtol=1e-3)
