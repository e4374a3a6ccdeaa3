"""The port's sharded fleet (``LocalFleet(model_axis=2)``) against the
reference's and against its own unsharded fleet.

The reference's own case (``tests/test_fleet_lanes.py``'s sharded
snippet): reduced qwen3-moe-235b-a22b, ``batch=2, max_seq=64,
gen_tokens=4, model_axis=2`` over 4 devices — mesh ``data 2 x model 2`` —
here at float32.  The reference runs in a subprocess with 4 fake CPU
devices and hands back its tokens and its weights (``.npz``); the port
runs on 4 ``gloo`` CPU ranks (``launch.mesh.host_ranks``: this process is
rank 0), its members loaded with the reference's weights
(``LocalFleet.load_params``: each rank keeps its blocks).

The tokens must equal the reference's sharded fleet's and the port's
unsharded fleet's, under the ``xla`` and ``flash_paged`` decodes (the
kernels' plain versions on the CPU), with a waiver only for a near-tie
(the gap between the top-2 logits below the measured logit error): the
shards' partial sums are added in another order than the unsharded
member's, in both packages.  ``build_serve_steps`` over the same ranks
must give the same tokens under ``decode_impl="shardmap"`` (split-KV
over the sequence-sharded contiguous cache) as under ``"xla"``, and
``serve.main(["--model-axis", "2", ...])`` must serve.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as LM
from repro_torch.models import model as MD
from repro_torch.serving import serve_lib
from repro_torch.serving.fleet import LocalFleet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-moe-235b-a22b"
F32 = {ARCH: {"dtype": "float32"}}
KW = dict(reduced=True, batch=2, max_seq=64, gen_tokens=4)
PROMPTS = ["shard me across hosts",
           "a second request that shares nothing with the first one",
           "tiny", " ".join(f"w{i}" for i in range(30))]

_JAX = r"""
import sys
import numpy as np
import jax
assert jax.device_count() == 4, jax.device_count()
from repro.serving.fleet import LocalFleet
fleet = LocalFleet([%(arch)r], model_axis=2, warmup=False,
                   arch_overrides=%(f32)r, decode_impl="xla", **%(kw)r)
assert dict(fleet.mesh.shape) == {"data": 2, "model": 2}
m = fleet.members[%(arch)r]
specs = [str(tuple(x.sharding.spec)) for x in jax.tree.leaves(m.params)]
assert any("model" in sp for sp in specs), specs[:8]
outs = fleet.generate(%(arch)r, %(prompts)r)
flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(m.params)[0]}
tokens = np.asarray([o["tokens"] for o in outs], np.int32)
np.savez(sys.argv[1], tokens=tokens, **{"p/" + k: v for k, v in flat.items()})
"""


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("shard") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    script = _JAX % {"arch": ARCH, "f32": F32, "kw": KW, "prompts": PROMPTS}
    proc = subprocess.run([sys.executable, "-c", script, str(out)],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = dict(np.load(out))
    named = params_from_jax(_nest({k[2:]: v for k, v in data.items()
                                   if k.startswith("p/")}))
    return data["tokens"].tolist(), named


def _near_tie(named, prompt_ids, out_a, out_b, err=1e-4):
    """The first position where two token lists differ is a near-tie of
    the unsharded float32 member (top-2 logit gap below ``err``)."""
    cfg = get_reduced(ARCH).replace(dtype="float32")
    model = MD.Model(cfg, "cpu")
    model.load_state_dict(named)
    i = next(k for k, (a, b) in enumerate(zip(out_a, out_b)) if a != b)
    ids = torch.as_tensor(list(prompt_ids) + list(out_a[:i]))[None]
    logits = MD.forward(cfg, model, ids, moe_impl="sort")[0][0, -1]
    top = torch.topk(logits, 2).values
    gap = float(top[0] - top[1])
    print(f"near-tie at token {i}: top-2 gap {gap:.3g}")
    return gap < err


def _same_or_near_tie(named, fleet, got, want):
    from repro_torch.serving.fleet import hash_tokens
    cfg = get_reduced(ARCH)
    for prompt, a, b in zip(PROMPTS, got, want):
        if a != b:
            ids = hash_tokens(prompt, cfg.vocab_size,
                              fleet.members[ARCH].prompt_cap)
            assert _near_tie(named, ids, a, b), (prompt, a, b)


def _steps_tokens(impl):
    """One rank: ``build_serve_steps`` prefill + 6 decodes of two rows
    at one depth (scalar ``pos``) on the (2, 2) mesh."""
    mesh = LM.make_host_mesh(2)
    cfg = get_reduced(ARCH).replace(dtype="float32", decode_impl=impl)
    params = MD.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                            mesh=mesh)
    prefill, decode, sh = serve_lib.build_serve_steps(cfg, mesh, 2, 32)
    cache = MD.init_cache(cfg, 2, 32, "cpu", mesh=mesh)
    nxt, cache = prefill(params, torch.tensor([[5, 9, 13, 2], [7, 7, 1, 3]],
                                              dtype=torch.int32), cache)
    out = [nxt]
    for _ in range(6):
        nxt, cache = decode(params, nxt[:, None], cache)
        out.append(nxt)
    split = any(getattr(t, "_seq_split", False)
                for t in cache["g0"]["b0"].values())
    return torch.stack(out, 1).tolist(), split, \
        str(sh["param_specs"]["blocks.0.attn.wq"])


def test_sharded_fleet_matches_reference_and_unsharded(reference):
    ref_tokens, named = reference
    plain = LocalFleet([ARCH], arch_overrides=F32, device="cpu",
                       warmup=False, **KW)
    plain.load_params(ARCH, named)
    unsharded = [o["tokens"] for o in plain.generate(ARCH, PROMPTS)]
    _same_or_near_tie(named, plain, unsharded, ref_tokens)
    with LM.host_ranks(4, device="cpu") as ctl:
        for impl in ("xla", "flash_paged"):
            over = {ARCH: dict(F32[ARCH], attn_impl="pallas")} \
                if impl == "flash_paged" else F32
            fleet = LocalFleet([ARCH], model_axis=2, arch_overrides=over,
                               decode_impl=impl, device="cpu", warmup=False,
                               **KW)
            assert fleet.mesh.shape == {"data": 2, "model": 2}
            fleet.load_params(ARCH, named)
            params = fleet.members[ARCH].params
            # wq (d 64, 4 heads x 16): FSDP rows over "data", heads over
            # "model" — the rank holds a quarter
            assert params.blocks[0].attn["wq"]._spec == ("data", "model")
            assert tuple(params.blocks[0].attn["wq"].shape) == (32, 32)
            got = [o["tokens"] for o in fleet.generate(ARCH, PROMPTS)]
            _same_or_near_tie(named, fleet, got, ref_tokens)
            _same_or_near_tie(named, fleet, got, unsharded)
            stats = fleet.rank_stats()
            assert len(stats) == 4 and all(
                s["collectives"]["calls"] > 0 for s in stats)
            assert fleet.schedulers[ARCH].pool.live_refs() == 0
        shard, split, spec = zip(*ctl.gather(_steps_tokens, "shardmap"))
        xla, xsplit, _ = zip(*ctl.gather(_steps_tokens, "xla"))
    assert all(s == shard[0] for s in shard) and shard[0] == xla[0]
    assert all(split) and not any(xsplit)
    assert spec[0] == "P('data', 'model')"


def test_sharded_fleet_contiguous_and_without_ranks():
    """``paged=False`` on the ranks serves the unsharded tokens; with no
    ranks up, ``model_axis=2`` raises "model axis"."""
    with pytest.raises(RuntimeError, match="model axis"):
        LocalFleet([ARCH], model_axis=2, device="cpu", warmup=False, **KW)
    kw = dict(KW, arch_overrides=F32, device="cpu", warmup=False,
              paged=False)
    want = [o["tokens"] for o in LocalFleet([ARCH], **kw).generate(
        ARCH, PROMPTS)]
    with LM.host_ranks(2, device="cpu"):
        fleet = LocalFleet([ARCH], model_axis=2, **kw)
        assert fleet.mesh.shape == {"data": 1, "model": 2}
        got = [o["tokens"] for o in fleet.generate(ARCH, PROMPTS)]
    assert got == want


def test_serve_main_with_model_axis(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--model-axis", "2", "--requests", "4",
                "--batch", "4", "--gen-tokens", "2"])
    out = capsys.readouterr().out
    assert "4 requests in" in out and "mesh {'data': 1, 'model': 2}" in out


def test_threads_of_rank_zero_share_the_ranks():
    """Two threads of rank 0 drive two sharded members at once (as the
    router's front end and a caller do): every step reaches every rank
    in one order (the controller's lock), so each thread gets the tokens
    a sequential run gets."""
    import threading
    archs = [ARCH, "qwen3-1.7b"]
    kw = dict(KW, device="cpu", warmup=False,
              arch_overrides={a: {"dtype": "float32"} for a in archs})
    want = {}
    solo = LocalFleet(archs, **kw)
    for a in archs:
        want[a] = [o["tokens"] for o in solo.generate(a, PROMPTS)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with LM.host_ranks(2, device="cpu"):
            fleet = LocalFleet(archs, model_axis=2, **kw)
            got, errors = {}, []

            def serve(a):
                try:
                    for _ in range(2):
                        got[a] = [o["tokens"]
                                  for o in fleet.generate(a, PROMPTS)]
                except Exception as e:          # noqa: BLE001 — asserted
                    errors.append(e)

            threads = [threading.Thread(target=serve, args=(a,))
                       for a in archs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    assert got == want
