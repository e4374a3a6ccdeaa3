"""Checkpoints written by ranks, restored onto any mesh in either package,
and the launcher's crash drill over ranks.

A train state of the reduced float32 qwen3-moe-235b-a22b (the
reference's ``init_params`` weights, random moments at step 3) is cut to
the blocks of ``data 2 x model 2`` on 4 ``gloo`` CPU ranks and saved
there (``save_checkpoint(..., mesh=)``: rank r writes the whole leaves
``i % 4 == r``).  It must restore, bit for bit at float32:

* onto the 4 ranks as ``data 4 x model 1``, and onto 2 ranks as ``data 1
  x model 2`` (each rank's blocks == ``bridge.shard_params`` of the whole);
* from a 2-rank save, in one process without a mesh, and in the
  reference's ``restore_checkpoint``;
* from the reference's own ``save_checkpoint``, onto the 4 ranks.

The crash drill: ``launch.train.main`` over 2 ranks (``data 2``) exits
with 17 on every rank at ``--fail-at-step 6``; a fresh world resumes from
the step-4 checkpoint to the uninterrupted 2-rank run's final loss (rel
1e-4, as ``test_torch_ckpt``'s one-process drill), and the 2 ranks'
step-4 checkpoint, restored in one process, gives that run's step-4 loss.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import ckpt as JC
from repro.configs import get_reduced as j_get_reduced
from repro.models import model as JMD
from repro.training import optimizer as JO
from repro_torch.bridge import (opt_state_from_jax, opt_state_to_jax,
                                params_from_jax, ref_tree, shard_opt_state,
                                shard_params, train_state_tree,
                                whole_params)
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import read_manifest
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as LM
from repro_torch.launch import train as T
from repro_torch.models import model as MD
from repro_torch.training import optimizer as O

ARCH = "qwen3-moe-235b-a22b"


def _state():
    """The reference's train state ``(params, OptState)`` at step 3 with
    random moments, as numpy trees."""
    cfg = j_get_reduced(ARCH).replace(dtype="float32")
    params = JMD.init_params(cfg, jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    m = jax.tree.map(lambda x: r.standard_normal(x.shape).astype(
        np.float32), params)
    v = jax.tree.map(lambda x: np.abs(r.standard_normal(x.shape)).astype(
        np.float32), params)
    return jax.tree.map(np.asarray, (params, JO.OptState(
        np.asarray(3, np.int32), m, v)))


def _cfg():
    return get_reduced(ARCH).replace(dtype="float32")


def save_blocks(model: int, state, ckdir: str, step: int):
    """One rank: the whole ``state`` cut to this rank's blocks of
    ``make_host_mesh(model)``, saved over the mesh."""
    cfg, mesh = _cfg(), LM.make_host_mesh(model)
    params = MD.Model(cfg, "cpu", mesh=mesh)
    params.load_state_dict(shard_params(params_from_jax(state[0]), cfg,
                                        mesh))
    opt = shard_opt_state(state[1], cfg, mesh, "cpu")
    save_checkpoint(ckdir, step, train_state_tree(params, opt, cfg),
                    {"next_step": step}, mesh=mesh)
    return mesh.size


def restore_blocks(model: int, state, ckdir: str, step: int) -> bool:
    """One rank: restore checkpoint ``step`` onto ``make_host_mesh(model)``;
    True when every block equals ``shard_params`` of the whole ``state``,
    bitwise, and the step and meta came back."""
    cfg, mesh = _cfg(), LM.make_host_mesh(model)
    params = MD.Model(cfg, "cpu", mesh=mesh)
    opt = O.init_opt_state(params)
    (ptree, otree), meta = restore_checkpoint(
        ckdir, step, train_state_tree(params, opt, cfg), mesh=mesh)
    params.load_state_dict(params_from_jax(ptree))
    opt = opt_state_from_jax(otree, "cpu")
    want_p = shard_params(params_from_jax(state[0]), cfg, mesh)
    want_o = shard_opt_state(state[1], cfg, mesh, "cpu")
    ok = all(params.state_dict()[k].equal(want_p[k]) for k in want_p)
    ok &= all(opt.m[k].equal(want_o.m[k]) and opt.v[k].equal(want_o.v[k])
              for k in want_p)
    return bool(ok and int(opt.step) == int(state[1][0])
                and meta == {"next_step": step}
                and all(t.shape == params.get_parameter(k).shape
                        for k, t in want_p.items()))


def whole_after_restore(model: int, ckdir: str, step: int):
    """One rank: restore onto ``make_host_mesh(model)`` and gather the
    whole weights back (``bridge.whole_params``)."""
    cfg, mesh = _cfg(), LM.make_host_mesh(model)
    params = MD.Model(cfg, "cpu", mesh=mesh)
    opt = O.init_opt_state(params)
    (ptree, _), _ = restore_checkpoint(
        ckdir, step, train_state_tree(params, opt, cfg), mesh=mesh)
    params.load_state_dict(params_from_jax(ptree))
    return whole_params(params, params, mesh)


def _same_tree(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [jax.tree_util.keystr(p) for p, _ in fa] == \
        [jax.tree_util.keystr(p) for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert np.array_equal(x, y), jax.tree_util.keystr(p)


def test_restores_in_every_direction(tmp_path):
    state = _state()
    cfg = _cfg()
    ck4, ck2, ckref = (str(tmp_path / d) for d in ("ck4", "ck2", "ref"))
    JC.save_checkpoint(ckref, 3, jax.tree.map(jnp.asarray, state),
                       {"next_step": 3})
    with LM.host_ranks(4, device="cpu") as ctl:
        assert ctl.gather(save_blocks, 2, state, ck4, 3) == [4] * 4
        man = read_manifest(ck4, 3)
        assert man["process_count"] == 4
        assert sorted(os.listdir(os.path.join(ck4, "step_00000003"))) == \
            ["manifest.msgpack"] + [f"shard_{r}.npz" for r in range(4)]
        assert man == dict(read_manifest(ckref, 3), process_count=4)
        # 4 ranks -> the same ranks as data 4 x model 1; the reference's
        # checkpoint -> data 2 x model 2
        assert all(ctl.gather(restore_blocks, 1, state, ck4, 3))
        assert all(ctl.gather(restore_blocks, 2, state, ckref, 3))
        whole = ctl.gather(whole_after_restore, 2, ck4, 3)
    for k, v in params_from_jax(state[0]).items():
        assert all(w[k].equal(v) for w in whole), k
    with LM.host_ranks(2, device="cpu") as ctl:
        # -> 2 ranks as data 1 x model 2, then a 2-rank save
        assert all(ctl.gather(restore_blocks, 2, state, ck4, 3))
        assert ctl.gather(save_blocks, 2, state, ck2, 3) == [2, 2]
    assert read_manifest(ck2, 3)["process_count"] == 2
    # -> one process, no mesh
    model = MD.Model(cfg, "cpu")
    opt = O.init_opt_state(model)
    (ptree, otree), meta = restore_checkpoint(
        ck2, 3, (ref_tree(model, cfg), opt_state_to_jax(opt, cfg,
                                                        numpy=False)))
    assert meta == {"next_step": 3} and latest_step(ck2) == 3
    model.load_state_dict(params_from_jax(ptree))
    opt = opt_state_from_jax(otree, "cpu")
    _same_tree((ref_tree(model, cfg), opt_state_to_jax(opt, cfg)),
               (state[0], JO.OptState(*state[1])))
    # -> the reference
    back, meta = JC.restore_checkpoint(ck2, 3, jax.tree.map(jnp.zeros_like,
                                                            state))
    assert meta == {"next_step": 3}
    _same_tree(back, state)


def test_crash_drill_over_ranks(tmp_path):
    base = ["--device", "cpu", "--arch", "llama3.2-1b", "--reduced",
            "--steps", "8", "--batch", "4", "--seq", "32", "--log-every",
            "100"]
    with LM.host_ranks(2, device="cpu") as ctl:
        full = ctl.gather(T.main, base)
    assert full[0] == full[1]
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as e:
        with LM.host_ranks(2, device="cpu") as ctl:
            ctl.gather(T.main, base + ["--ckpt-dir", ck, "--ckpt-every", "4",
                                       "--fail-at-step", "6"])
    assert e.value.code == 17              # and both workers exited 17
    assert latest_step(ck) == 4
    assert read_manifest(ck, 4)["process_count"] == 2
    one = str(tmp_path / "one")
    shutil.copytree(ck, one)
    with LM.host_ranks(2, device="cpu") as ctl:
        resumed = ctl.gather(T.main, base + ["--ckpt-dir", ck,
                                             "--ckpt-every", "4"])
    assert len(resumed[0]) == 4 and resumed[0] == resumed[1]
    assert resumed[0][-1] == pytest.approx(full[0][-1], rel=1e-4)
    assert latest_step(ck) == 8
    # the 2 ranks' step-4 checkpoint in one process: the next step's loss
    stats = {}
    step4 = T.main(base[:5] + ["--steps", "5"] + base[7:] +
                   ["--ckpt-dir", one, "--ckpt-every", "100"], stats=stats)
    assert stats["restore_s"] is not None and len(step4) == 1
    assert step4[0] == pytest.approx(full[0][4], rel=1e-4)
