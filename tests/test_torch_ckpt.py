"""The port's checkpoints, data pipeline and training launcher against the
JAX package's: twins of ``test_infra``'s checkpoint roundtrip, atomicity
and ``TokenStream`` cases; checkpoints written by either package restore
in the other bit for bit, with equal manifests; the manifest codec against
the ``msgpack`` package both ways; the twin of
``test_system::test_train_restart_determinism``; and the launcher's losses
against the reference launcher's from the same weights.
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JC
from repro.configs import get_reduced as j_get_reduced
from repro.data.pipeline import TokenStream as JTokenStream
from repro.data.pipeline import router_corpus as j_router_corpus
from repro.models import model as JMD
from repro.training import optimizer as JO
from repro_torch.bridge import (model_from_jax, opt_state_from_jax,
                                opt_state_to_jax, params_from_jax,
                                params_to_jax, ref_tree, to_numpy)
from repro_torch.checkpoint import (codec, latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import read_manifest
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import TokenStream, router_corpus
from repro_torch.training import optimizer as O


# ---------------------------------------------------------------------------
# checkpoint (twins of test_infra)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 10, tree, {"note": "x"})
    assert latest_step(str(tmp_path)) == 10
    target = {"a": torch.zeros((3, 4)),
              "nested": {"b": torch.zeros((5,), dtype=torch.bfloat16),
                         "step": torch.tensor(0, dtype=torch.int32)}}
    restored, meta = restore_checkpoint(str(tmp_path), 10, target)
    assert meta["note"] == "x"
    for k in ("a",):
        assert torch.equal(restored[k], tree[k])
    for k in ("b", "step"):
        assert restored["nested"][k].dtype == tree["nested"][k].dtype
        assert torch.equal(restored["nested"][k], tree["nested"][k])


def test_checkpoint_atomicity(tmp_path):
    tree = {"a": torch.ones((4,))}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    # a stray .tmp dir (crash mid-save) must not be picked up
    os.makedirs(str(tmp_path / "step_00000099.tmp"))
    assert latest_step(str(tmp_path)) == 2
    assert latest_step(str(tmp_path / "missing")) is None


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _train_state(dtype):
    """A reference train state ``(params, OptState)`` of reduced
    llama3.2-1b with nonzero moments at step 3."""
    cfg = j_get_reduced("llama3.2-1b").replace(dtype=dtype)
    params = JMD.init_params(cfg, jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    m = jax.tree.map(lambda x: jnp.asarray(
        r.standard_normal(x.shape), jnp.float32), params)
    v = jax.tree.map(lambda x: jnp.asarray(
        np.abs(r.standard_normal(x.shape)), jnp.float32), params)
    return cfg, (params, JO.OptState(jnp.asarray(3, jnp.int32), m, v))


def _leaves_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [jax.tree_util.keystr(p) for p, _ in fa] == \
        [jax.tree_util.keystr(p) for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert np.array_equal(x.reshape(-1).view(np.uint8),
                              y.reshape(-1).view(np.uint8)), p


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    """A checkpoint the reference writes restores in the port bit for bit
    (the model and the optimizer state), and the port's own save of that
    state writes the same manifest keys and entries."""
    jcfg, state = _train_state(dtype)
    JC.save_checkpoint(str(tmp_path / "ref"), 3, state, {"next_step": 3})
    cfg = get_reduced("llama3.2-1b").replace(dtype=dtype)
    model = model_from_jax(jax.tree.map(np.zeros_like, state[0]), cfg,
                           "cpu")
    opt = O.init_opt_state(model)
    target = (ref_tree(model, cfg), opt_state_to_jax(opt, cfg, numpy=False))
    (ptree, otree), meta = restore_checkpoint(str(tmp_path / "ref"), 3,
                                              target)
    assert meta == {"next_step": 3}
    model.load_state_dict(params_from_jax(ptree))
    opt = opt_state_from_jax(otree, "cpu")
    got = (ref_tree(model, cfg), opt_state_to_jax(opt, cfg, numpy=False))
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(state)[0],
                         jax.tree_util.tree_leaves(got)):
        assert str(b.dtype) == f"torch.{a.dtype}", jax.tree_util.keystr(p)
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                       else a)
        assert np.array_equal(a, to_numpy(b)), jax.tree_util.keystr(p)
    save_checkpoint(str(tmp_path / "port"), 3, got, {"next_step": 3})
    jm = read_manifest(str(tmp_path / "ref"), 3)
    tm = read_manifest(str(tmp_path / "port"), 3)
    assert len(jm["keys"]) == 34
    assert "1/.step" in jm["keys"] and "0/g0/b0/attn/wq" in jm["keys"]
    assert tm == jm


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_checkpoint_restores_in_reference(tmp_path, dtype):
    """A checkpoint the port writes from its model and optimizer state
    restores in the reference bit for bit, into the reference's tree."""
    jcfg, state = _train_state(dtype)
    cfg = get_reduced("llama3.2-1b").replace(dtype=dtype)
    model = model_from_jax(state[0], cfg, "cpu")
    opt = opt_state_from_jax(state[1], "cpu")
    save_checkpoint(str(tmp_path), 5,
                    (ref_tree(model, cfg),
                     opt_state_to_jax(opt, cfg, numpy=False)),
                    {"next_step": 5, "loss": 1.5})
    target = jax.tree.map(jnp.zeros_like, state)
    restored, meta = JC.restore_checkpoint(str(tmp_path), 5, target)
    assert meta == {"next_step": 5, "loss": 1.5}
    _leaves_equal(restored, state)
    assert JC.latest_step(str(tmp_path)) == 5
    # and back through the port's bridge: the same tensors
    again = model_from_jax(jax.tree.map(np.asarray, restored[0]), cfg,
                           "cpu")
    for (n, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), n


def test_params_to_jax_inverts_params_from_jax():
    """``params_to_jax`` re-stacks the unrolled blocks into the reference's
    tree: the reference's weights come back leaf for leaf, in the same
    tree, for a config with several groups (deepseek: a dense group and a
    MoE group) and an encoder-decoder (whisper)."""
    for arch in ("deepseek-v2-236b", "whisper-tiny", "jamba-v0.1-52b"):
        jcfg = j_get_reduced(arch).replace(dtype="float32")
        params = JMD.init_params(jcfg, jax.random.PRNGKey(1))
        cfg = get_reduced(arch).replace(dtype="float32")
        back = params_to_jax(model_from_jax(params, cfg, "cpu"), cfg)
        _leaves_equal(back, jax.tree.map(np.asarray, params))


# ---------------------------------------------------------------------------
# the manifest codec
# ---------------------------------------------------------------------------

MANIFESTS = [
    {"step": 12, "meta": {"next_step": 12, "loss": 3.25, "task": "jb",
                          "vocab": 30522, "ok": True, "none": None},
     "process_count": 1,
     "keys": {f"0/g0/b{i}/attn/wq": {"shape": [2, 64, 64],
                                     "dtype": "bfloat16",
                                     "stored_as": "float32"}
              for i in range(20)}},
    {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768,
              -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
     "floats": [0.0, -1.5, 1e-300, 3.141592653589793, float("inf")],
     "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
     "list": list(range(20)) + [[], {}, [None, False]],
     "big": {str(i): i for i in range(70000)}},
]


@pytest.mark.parametrize("obj", MANIFESTS, ids=["manifest", "formats"])
def test_codec_matches_msgpack(obj):
    ours = codec.packb(obj)
    assert ours == msgpack.packb(obj)
    assert msgpack.unpackb(ours) == obj
    assert codec.unpackb(msgpack.packb(obj)) == obj
    assert codec.unpackb(msgpack.packb((1, 2.5, "x"))) == [1, 2.5, "x"]
    with pytest.raises(ValueError):
        codec.unpackb(ours + b"\x00")
    with pytest.raises(TypeError):
        codec.packb({"x": object()})


# ---------------------------------------------------------------------------
# data pipeline (twin of test_infra)
# ---------------------------------------------------------------------------

def test_token_stream_deterministic_and_matches_reference():
    s1 = TokenStream(1000, 4, 64, seed=3)
    s2 = TokenStream(1000, 4, 64, seed=3)
    a1, b1 = s1.batch_at(17)
    a2, b2 = s2.batch_at(17)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
    a3, _ = s1.batch_at(18)
    assert not np.array_equal(a1, a3)
    assert b1.shape == a1.shape == (4, 64)
    np.testing.assert_array_equal(a1[:, 1:], b1[:, :-1])  # shifted labels
    ref = JTokenStream(1000, 4, 64, seed=3)
    for step, (a, b) in zip(range(3), s1):
        ja, jb = ref.batch_at(step)
        assert np.array_equal(a, ja) and np.array_equal(b, jb)
        assert a.dtype == ja.dtype
    for step in (0, 5, 9):
        assert all(np.array_equal(x, y) for x, y in zip(
            TokenStream(49152, 8, 512).batch_at(step),
            JTokenStream(49152, 8, 512).batch_at(step)))
    assert router_corpus(n_per_class=7, seed=2) == \
        j_router_corpus(n_per_class=7, seed=2)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_restart_determinism(tmp_path):
    """Twin of ``test_system::test_train_restart_determinism``: crash at
    step 6 (exit code 17), resume from the step-4 checkpoint, the final
    loss matches an uninterrupted run."""
    from repro_torch.launch import train as T
    base = ["--device", "cpu", "--arch", "llama3.2-1b", "--reduced",
            "--steps", "8", "--batch", "2", "--seq", "32",
            "--log-every", "100"]
    losses_full = T.main(base)
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as e:
        T.main(base + ["--ckpt-dir", ck, "--ckpt-every", "4",
                       "--fail-at-step", "6"])
    assert e.value.code == 17
    stats = {}
    losses_resumed = T.main(base + ["--ckpt-dir", ck, "--ckpt-every", "4"],
                            stats=stats)
    assert len(losses_resumed) == 4 and stats["restore_s"] is not None
    assert losses_resumed[-1] == pytest.approx(losses_full[-1], rel=1e-4)
    assert latest_step(ck) == 8


def test_train_main_matches_reference_launcher(tmp_path):
    """The port's launcher from the reference launcher's initial weights
    (``init_params(cfg, PRNGKey(0))``) gives the reference launcher's
    losses (rel 1e-4), and the reference launcher resumes from the port's
    checkpoint."""
    from repro.launch import train as JT
    from repro_torch.launch import train as T
    base = ["--arch", "llama3.2-1b", "--reduced", "--steps", "6",
            "--batch", "2", "--seq", "32", "--log-every", "100"]
    jcfg = j_get_reduced("llama3.2-1b")
    init = jax.tree.map(np.asarray,
                        JMD.init_params(jcfg, jax.random.PRNGKey(0)))
    want = JT.main(base)
    ck = str(tmp_path / "ck")
    got = T.main(base + ["--device", "cpu", "--ckpt-dir", ck,
                         "--ckpt-every", "3"], init=init)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the reference resumes at step 6 of 6 from the port's last checkpoint
    # and has nothing left to run; from the step-3 one it runs 3 steps
    import shutil
    shutil.rmtree(os.path.join(ck, "step_00000006"))
    resumed = JT.main(base + ["--ckpt-dir", ck, "--ckpt-every", "100"])
    np.testing.assert_allclose(resumed, want[3:], rtol=1e-4)
