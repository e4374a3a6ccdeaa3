"""Speculative decoding over ranks: ``LocalFleet(model_axis=N,
speculative=...)`` against the reference's sharded speculative fleet and
against the port's own sharded plain fleet.

The reference shards its draft with the target's ``serve_shardings``
(``repro/serving/fleet.py`` ``_build_spec_runtime``); the port's
``MemberShard`` holds the draft's blocks beside the target's on every
rank, and the draft's steps, its cache and the wide verify run on the
ranks.  Two cases on 4 devices / ranks, each an aligned draft (the
target's own registry config, so every proposal is accepted), ``k = 2``,
``batch=2, max_seq=64, gen_tokens=6``:

* reduced qwen3-1.7b at model axis 2 (``data 2 x model 2``; its 2 KV
  heads split with the 4 query heads);
* reduced glm4-9b at model axis 4 (``data 1 x model 4``; 4 query heads
  over 2 KV heads that do not split: the target's and the draft's
  attention read the one KV head of the rank's query heads).

The drafts take their arch's registry config, so both packages read the
reduced registries at float32 while the fleets are built (as
``tests/test_torch_spec.py``); the reference runs once, in a subprocess
with 4 fake CPU devices and ``decode_impl="xla"``, and hands back its
tokens, spec counters, and target and draft weights, which the port
loads (``LocalFleet.load_params(arch, target, draft=)``).  The port's
speculative tokens must be bitwise equal to its sharded plain fleet's
under ``xla`` and ``flash_paged`` (the kernels' plain versions on the
CPU) and equal the reference's, and the spec counters (rounds, offered,
accepted, emitted) must equal the reference's.  ``serve.main`` serves
``--speculative`` over ``--model-axis 2``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.bridge import params_from_jax
from repro_torch.launch import mesh as LM
from repro_torch.serving import fleet as tfleet
from repro_torch.serving.fleet import LocalFleet
from repro_torch.serving.scheduler import SpecConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"qwen3-1.7b": 2, "glm4-9b": 4}
K = 2
KW = dict(reduced=True, batch=2, max_seq=64, gen_tokens=6)
PROMPTS = ["shard me across hosts",
           "a second request that shares nothing with the first one",
           "tiny", " ".join(f"w{i}" for i in range(30))]

_JAX = r"""
import sys
import numpy as np
import jax
assert jax.device_count() == 4, jax.device_count()
from repro.serving import fleet as F
from repro.serving.scheduler import SpecConfig
orig = F.get_reduced
F.get_reduced = lambda a: orig(a).replace(dtype="float32")
out = {}
for arch, model in %(cases)r.items():
    fleet = F.LocalFleet([arch], model_axis=model, warmup=False,
                         decode_impl="xla",
                         speculative=SpecConfig(arch, k=%(k)d), **%(kw)r)
    assert dict(fleet.mesh.shape) == {"data": 4 // model, "model": model}
    outs = fleet.generate(arch, %(prompts)r)
    s = fleet.schedulers[arch]
    out[arch + "/tokens"] = np.asarray([o["tokens"] for o in outs], np.int32)
    out[arch + "/counters"] = np.asarray(
        [s.spec_rounds, s.spec_offered, s.spec_accepted, s.spec_emitted])
    for tag, tree in (("p", fleet.members[arch].params),
                      ("d", s.drafter.rt.params)):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[f"{arch}/{tag}/{key}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
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
    out = tmp_path_factory.mktemp("spec") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    script = _JAX % {"cases": CASES, "k": K, "kw": KW, "prompts": PROMPTS}
    proc = subprocess.run([sys.executable, "-c", script, str(out)],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = dict(np.load(out))
    res = {}
    for arch in CASES:
        trees = {}
        for tag in ("p", "d"):
            pre = f"{arch}/{tag}/"
            trees[tag] = params_from_jax(_nest(
                {k[len(pre):]: v for k, v in data.items()
                 if k.startswith(pre)}))
        res[arch] = (data[arch + "/tokens"].tolist(),
                     data[arch + "/counters"].tolist(), trees["p"],
                     trees["d"])
    return res


def _counters(sched):
    return [sched.spec_rounds, sched.spec_offered, sched.spec_accepted,
            sched.spec_emitted]


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_spec_fleet_matches_reference_and_plain(reference,
                                                        monkeypatch, arch):
    ref_tokens, ref_counters, target, draft = reference[arch]
    model = CASES[arch]
    orig = tfleet.get_reduced
    monkeypatch.setattr(tfleet, "get_reduced",
                        lambda a: orig(a).replace(dtype="float32"))
    kw = dict(KW, model_axis=model, device="cpu", warmup=False)
    with LM.host_ranks(4, device="cpu"):
        plain = LocalFleet([arch], decode_impl="xla", **kw)
        plain.load_params(arch, target)
        want = [o["tokens"] for o in plain.generate(arch, PROMPTS)]
        for impl in ("xla", "flash_paged"):
            over = {arch: {"attn_impl": "pallas"}} \
                if impl == "flash_paged" else None
            fleet = LocalFleet([arch], decode_impl=impl, arch_overrides=over,
                               speculative=SpecConfig(arch, k=K), **kw)
            assert fleet.mesh.shape == {"data": 4 // model, "model": model}
            m = fleet.members[arch]
            # the draft's blocks live on the ranks beside the target's
            assert m.shard.draft_cfg.name == arch
            assert m.spec.params.blocks[0].attn["wq"]._spec[1] == "model"
            fleet.load_params(arch, target, draft=draft)
            got = [o["tokens"] for o in fleet.generate(arch, PROMPTS)]
            sched = fleet.schedulers[arch]
            assert got == want, (impl, got, want)
            assert got == ref_tokens, (impl, got, ref_tokens)
            assert _counters(sched) == ref_counters
            assert sched.spec_rounds > 0
            assert sched.spec_accepted == sched.spec_offered > 0
            assert sched.spec_tokens_per_round > 1.0
            assert sched.pool.live_refs() == 0


def test_serve_main_speculative_with_model_axis(capsys, monkeypatch):
    """A router config whose GLOBAL block asks for speculation (the
    qwen3 profile's arch as every lane's draft) served by ``serve.main``
    over 2 ranks."""
    from repro_torch.launch import serve
    orig = serve.build_dsl
    monkeypatch.setattr(serve, "build_dsl", lambda lanes=("text",): orig(
        lanes).replace('GLOBAL {\n', 'GLOBAL {\n  speculative: { '
                       'draft_model: "qwen3", k: 2 },\n', 1))
    serve.main(["--device", "cpu", "--model-axis", "2", "--requests", "4",
                "--batch", "4", "--gen-tokens", "4"])
    out = capsys.readouterr().out
    assert "4 requests in" in out and "mesh {'data': 1, 'model': 2}" in out
    rounds = [int(ln.split("spec_rounds=")[1].split()[0])
              for ln in out.splitlines() if "  backend " in ln]
    assert len(rounds) == 4 and sum(rounds) > 0, out


def test_speculative_model_axis_needs_ranks():
    """No fallback: a speculative fleet asked for a model axis with no
    ranks up raises, never serves unsharded."""
    with pytest.raises(RuntimeError, match="model axis"):
        LocalFleet(["glm4-9b"], model_axis=4, device="cpu", warmup=False,
                   speculative=SpecConfig("glm4-9b", k=K), **KW)
