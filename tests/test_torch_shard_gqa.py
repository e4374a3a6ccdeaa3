"""GQA members whose query heads split over ``"model"`` while their KV
heads do not, served over ranks, against the reference's sharded fleet.

The reference shards ``wq``/``wo`` over ``"model"`` when ``n_heads``
divides it and keeps ``wk``/``wv`` whole when ``n_kv_heads`` does not
(``repro/sharding/rules.py``); GSPMD then computes the unsharded
attention.  The port computes every KV head on every rank and attends its
query heads with the one KV head they read (``models.model._rank_kv``);
its paged pools hold that head alone (``kv_layout`` "group").

Two cases over ``data 1 x model 4`` (4 devices / ranks), float32,
``batch=2, max_seq=64, gen_tokens=4``:

* reduced qwen3-1.7b (4 query / 2 KV heads): one query head a rank;
* reduced glm4-9b with ``n_heads`` 8 (8 / 2 heads, in both packages):
  two query heads a rank, both under KV head ``j // 2`` of rank j.  A
  rank that mapped its query head g to KV head ``g // 4`` (the GQA
  reshape over its local heads) would raise no error and give other
  tokens here.

The reference runs once, in a subprocess with 4 fake CPU devices and
``decode_impl="xla"`` (its ``flash_paged`` fails under the installed
JAX), and hands back its tokens and weights (``.npz``).  The port loads
those weights (``LocalFleet.load_params``) on 4 ``gloo`` CPU ranks.  Its
tokens must equal the reference's and its own unsharded fleet's under
``xla`` and ``flash_paged`` (the kernels' plain versions on the CPU),
a mismatch waived only at a near-tie (top-2 logit gap of the unsharded
float32 member below 1e-4).  Within the port, on the ranks, bitwise:
paged == contiguous, ``build_serve_steps`` under ``shardmap`` == ``xla``,
``live_refs() == 0`` after a drain.
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
from repro_torch.serving.fleet import LocalFleet, hash_tokens

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"qwen3-1.7b": {"dtype": "float32"},
         "glm4-9b": {"dtype": "float32", "n_heads": 8}}
MODEL = 4
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
out = {}
for arch, ov in %(cases)r.items():
    fleet = LocalFleet([arch], model_axis=%(model)d, warmup=False,
                       arch_overrides={arch: ov}, decode_impl="xla",
                       **%(kw)r)
    assert dict(fleet.mesh.shape) == {"data": 1, "model": %(model)d}
    m = fleet.members[arch]
    specs = {"/".join(str(getattr(k, "key", k)) for k in path):
             tuple(x.sharding.spec)
             for path, x in jax.tree_util.tree_flatten_with_path(m.params)[0]}
    assert "model" in specs["g0/b0/attn/wq"], specs
    assert "model" not in specs["g0/b0/attn/wk"], specs
    outs = fleet.generate(arch, %(prompts)r)
    out[arch + "/tokens"] = np.asarray([o["tokens"] for o in outs], np.int32)
    for path, v in jax.tree_util.tree_flatten_with_path(m.params)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[arch + "/p/" + key] = np.asarray(v)
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
    out = tmp_path_factory.mktemp("gqa") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    script = _JAX % {"cases": CASES, "model": MODEL, "kw": KW,
                     "prompts": PROMPTS}
    proc = subprocess.run([sys.executable, "-c", script, str(out)],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = dict(np.load(out))
    res = {}
    for arch in CASES:
        pre = arch + "/p/"
        named = params_from_jax(_nest({k[len(pre):]: v for k, v in
                                       data.items() if k.startswith(pre)}))
        res[arch] = (data[arch + "/tokens"].tolist(), named)
    return res


def _cfg(arch):
    return get_reduced(arch).replace(**CASES[arch])


def _near_tie(arch, named, prompt, out_a, out_b, err=1e-4):
    """The first position where two token lists differ is a near-tie of
    the unsharded float32 member (top-2 logit gap below ``err``)."""
    cfg = _cfg(arch)
    model = MD.Model(cfg, "cpu")
    model.load_state_dict(named)
    ids = hash_tokens(prompt, cfg.vocab_size, KW["max_seq"] -
                      KW["gen_tokens"] - 1)
    i = next(k for k, (a, b) in enumerate(zip(out_a, out_b)) if a != b)
    seq = torch.as_tensor(list(ids) + list(out_a[:i]))[None]
    logits = MD.forward(cfg, model, seq)[0][0, -1]
    top = torch.topk(logits, 2).values
    gap = float(top[0] - top[1])
    print(f"{arch}: near-tie at token {i}: top-2 gap {gap:.3g}")
    return gap < err


def _same_or_near_tie(arch, named, got, want):
    for prompt, a, b in zip(PROMPTS, got, want):
        if a != b:
            assert _near_tie(arch, named, prompt, a, b), (arch, prompt, a, b)


def _fleet(arch, impl, **kw):
    over = dict(CASES[arch])
    if impl == "flash_paged":
        over["attn_impl"] = "pallas"
    return LocalFleet([arch], arch_overrides={arch: over}, decode_impl=impl,
                      device="cpu", warmup=False, **dict(KW, **kw))


def _steps_tokens(arch, impl):
    """One rank: ``build_serve_steps`` prefill + 6 decodes of two rows at
    one depth (scalar ``pos``) on ``data 1 x model 4``."""
    mesh = LM.make_host_mesh(MODEL)
    cfg = _cfg(arch).replace(decode_impl=impl)
    params = MD.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                            mesh=mesh)
    prefill, decode, _ = serve_lib.build_serve_steps(cfg, mesh, 2, 32)
    cache = MD.init_cache(cfg, 2, 32, "cpu", mesh=mesh)
    nxt, cache = prefill(params, torch.tensor([[5, 9, 13, 2], [7, 7, 1, 3]],
                                              dtype=torch.int32), cache)
    out = [nxt]
    for _ in range(6):
        nxt, cache = decode(params, nxt[:, None], cache)
        out.append(nxt)
    split = any(getattr(t, "_seq_split", False)
                for t in cache["g0"]["b0"].values())
    return torch.stack(out, 1).tolist(), split


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_gqa_fleet_matches_reference_and_unsharded(reference, arch):
    ref_tokens, named = reference[arch]
    cfg = _cfg(arch)
    plain = _fleet(arch, "xla")
    plain.load_params(arch, named)
    unsharded = [o["tokens"] for o in plain.generate(arch, PROMPTS)]
    _same_or_near_tie(arch, named, unsharded, ref_tokens)
    hq, G = cfg.n_heads // MODEL, cfg.n_heads // cfg.n_kv_heads
    with LM.host_ranks(MODEL, device="cpu") as ctl:
        paged = {}
        for impl in ("xla", "flash_paged"):
            fleet = _fleet(arch, impl, model_axis=MODEL)
            assert fleet.mesh.shape == {"data": 1, "model": MODEL}
            fleet.load_params(arch, named)
            attn = fleet.members[arch].params.blocks[0].attn
            # the rank's query heads; wk whole on every rank
            assert attn["wq"]._spec == ("data", "model")
            assert tuple(attn["wq"].shape) == (cfg.d_model,
                                               hq * cfg.head_dim)
            assert attn["wk"]._spec == ("data", None)
            assert tuple(attn["wk"].shape) == (
                cfg.d_model, cfg.n_kv_heads * cfg.head_dim)
            # each paged pool holds the one KV head of the rank's group
            assert MD.kv_layout(cfg, fleet.mesh, KW["max_seq"],
                                paged=True) == "group"
            pool = fleet.schedulers[arch].cache["g0"]["b0"]["k"]
            assert pool.shape[-2:] == (1, cfg.head_dim)
            got = [o["tokens"] for o in fleet.generate(arch, PROMPTS)]
            _same_or_near_tie(arch, named, got, ref_tokens)
            _same_or_near_tie(arch, named, got, unsharded)
            assert fleet.schedulers[arch].pool.live_refs() == 0
            stats = fleet.rank_stats()
            assert len(stats) == MODEL and all(
                s["collectives"]["calls"] > 0 for s in stats)
            paged[impl] = got
        contig = _fleet(arch, "xla", model_axis=MODEL, paged=False)
        contig.load_params(arch, named)
        assert not contig.members[arch].paged
        assert [o["tokens"] for o in contig.generate(arch, PROMPTS)] == \
            paged["xla"]
        shard, split = zip(*ctl.gather(_steps_tokens, arch, "shardmap"))
        xla, xsplit = zip(*ctl.gather(_steps_tokens, arch, "xla"))
    assert paged["flash_paged"] == paged["xla"]
    # KV heads that do not divide the axis: the contiguous cache is
    # sequence-sharded under both decodes (``cache_specs``)
    assert all(split) and all(xsplit)
    assert all(s == shard[0] for s in shard) and all(x == shard[0]
                                                     for x in xla)
    assert G // hq == MODEL // cfg.n_kv_heads


def test_refused_gqa_case_and_no_ranks():
    """Query heads that split over KV heads that neither divide the axis
    nor are a divisor of it stay refused, with a message that names the
    case; a model axis with no ranks up raises, never serves unsharded."""
    odd = get_reduced("glm4-9b").replace(n_heads=12, n_kv_heads=3)
    with pytest.raises(NotImplementedError, match="neither divide"):
        MD.check_shardable(odd, LM.Mesh({"data": 1, "model": 4}))
    MD.check_shardable(_cfg("glm4-9b"), LM.Mesh({"data": 1, "model": 4}))
    with pytest.raises(RuntimeError, match="model axis"):
        _fleet("glm4-9b", "xla", model_axis=MODEL)
