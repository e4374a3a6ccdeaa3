"""The port's model-axis collectives against the reference's ``shard_map``
versions: split-KV decode (``smdec.gqa_decode_sm`` / ``mla_decode_sm``),
expert parallelism (``moe.moe_ep`` / ``moe_ep_serve``) and the int8
compressed all-reduce.

The reference runs in a subprocess with 4 fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on meshes
``data 2 x model 2`` and ``data 1 x model 4``; the port runs on 4
``gloo`` CPU ranks (``launch.mesh.host_ranks``, ``Controller.gather``)
with each rank's blocks (``bridge.shard_params``; a sequence shard of
the cache).  Inputs come from a numpy seed and the reference's outputs
come back as ``.npz``.

Tolerance: float32 throughout, ``atol`` 1e-5 (``ATOL``): the two packages
add the shards' partial sums in different orders.  The quantiser, fed
the same stochastic-rounding noise on both sides, must match exactly;
``compressed_psum_mean`` over 4 ranks must be within one quantum of the
gradient every rank holds, and ``compression_ratio`` < 0.27.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import shard_params
from repro_torch.configs import get_reduced
from repro_torch.distributed import compression as C
from repro_torch.launch import mesh as LM
from repro_torch.models import moe as M
from repro_torch.models import smdec
from repro_torch.sharding import rules as R
from repro_torch.sharding.ctx import sharding_rules

ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 2), (1, 4))
MOE_ARCH = "qwen3-moe-235b-a22b"
MLA_ARCH = "deepseek-v2-236b"
B, S, HQ, HKV, HD = 2, 16, 4, 2, 8
POS = (9, 3)                      # a write on the second shard, the first
MOE_B = (4, 3)                    # divides data 2, and does not

_JAX = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_reduced
from repro.models import smdec, moe
from repro.sharding.ctx import sharding_rules
from repro.sharding import rules as R
from repro.distributed import compression as C
assert jax.device_count() == 4
inp = dict(np.load(sys.argv[1]))
out = {}
for d, m in %(meshes)r:
    mesh = Mesh(np.asarray(jax.devices()).reshape(d, m), ("data", "model"))
    tag = f"{d}x{m}"
    with sharding_rules(mesh, R.act_rules(mesh)):
        mcfg = get_reduced(%(mla)r).replace(dtype="float32")
        gqa = jax.jit(lambda *a: smdec.gqa_decode_sm(mcfg, *a))
        mla = jax.jit(lambda *a: smdec.mla_decode_sm(mcfg, *a))
        for pos in %(pos)r:
            o, kc, vc = gqa(inp["q"], inp["k_new"], inp["v_new"], inp["kc"],
                            inp["vc"], jnp.int32(pos))
            out[f"gqa/{tag}/{pos}/out"] = np.asarray(o)
            out[f"gqa/{tag}/{pos}/kc"] = np.asarray(kc)
            out[f"gqa/{tag}/{pos}/vc"] = np.asarray(vc)
            c, ckv, kr = mla(inp["q_lat"], inp["q_rope"], inp["ckv_new"],
                             inp["kr_new"], inp["ckv"], inp["kr"],
                             jnp.int32(pos))
            out[f"mla/{tag}/{pos}/ctx"] = np.asarray(c)
            out[f"mla/{tag}/{pos}/ckv"] = np.asarray(ckv)
            out[f"mla/{tag}/{pos}/kr"] = np.asarray(kr)
        cfg = get_reduced(%(moe)r).replace(dtype="float32")
        p = {k: jnp.asarray(inp["moe_" + k])
             for k in ("router", "w_gate", "w_up", "w_down")}
        ep = jax.jit(lambda p, x: moe.moe_ep(p, cfg, x)[0])
        ep_serve = jax.jit(lambda p, x: moe.moe_ep_serve(p, cfg, x)[0])
        for b in %(moe_b)r:
            x = jnp.asarray(inp[f"x{b}"])
            out[f"ep/{tag}/{b}"] = np.asarray(ep(p, x))
            out[f"ep_serve/{tag}/{b}"] = np.asarray(ep_serve(p, x))
# the quantiser with injected stochastic-rounding noise
noise = jnp.asarray(inp["noise"])
jax.random.uniform = lambda key, shape: noise
q, scale, pad = C._quantize(jnp.asarray(inp["g"]), jax.random.PRNGKey(0))
out["q"], out["scale"] = np.asarray(q), np.asarray(scale)
out["back"] = np.asarray(C._dequantize(q, scale, pad, inp["g"].shape,
                                       jnp.float32))
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    mla = get_reduced(MLA_ARCH)
    r, rh = mla.kv_lora_rank, mla.rope_head_dim
    moe = get_reduced(MOE_ARCH)
    E, d, ff = moe.n_experts, moe.d_model, moe.d_ff_expert
    inp = {"q": rng.standard_normal((B, 1, HQ, HD)),
           "k_new": rng.standard_normal((B, 1, HKV, HD)),
           "v_new": rng.standard_normal((B, 1, HKV, HD)),
           "kc": rng.standard_normal((B, S, HKV, HD)),
           "vc": rng.standard_normal((B, S, HKV, HD)),
           "q_lat": rng.standard_normal((B, 1, HQ, r)),
           "q_rope": rng.standard_normal((B, 1, HQ, rh)),
           "ckv_new": rng.standard_normal((B, 1, r)),
           "kr_new": rng.standard_normal((B, 1, rh)),
           "ckv": rng.standard_normal((B, S, r)),
           "kr": rng.standard_normal((B, S, rh)),
           "moe_router": rng.standard_normal((d, E)) * 0.5,
           "moe_w_gate": rng.standard_normal((E, d, ff)) / np.sqrt(d),
           "moe_w_up": rng.standard_normal((E, d, ff)) / np.sqrt(d),
           "moe_w_down": rng.standard_normal((E, ff, d)) / np.sqrt(ff),
           "g": rng.standard_normal((1000,)) * 0.01,
           "noise": rng.random((4, C.BLOCK))}
    for b in MOE_B:
        inp[f"x{b}"] = rng.standard_normal((b, 3, d))
    return {k: v.astype(f) for k, v in inp.items()}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smdec")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    script = _JAX % {"meshes": MESHES, "mla": MLA_ARCH, "moe": MOE_ARCH,
                     "pos": POS, "moe_b": MOE_B}
    proc = subprocess.run([sys.executable, "-c", script, str(tmp / "in.npz"),
                           str(tmp / "out.npz")], capture_output=True,
                          text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(tmp / "out.npz"))
    with LM.host_ranks(4, device="cpu") as ctl:
        port = ctl.gather(_rank_run, inp)
    return inp, ref, port


def _moe_params(inp, cfg, mesh):
    named = {f"blocks.0.moe.{k}": torch.from_numpy(inp["moe_" + k])
             for k in ("router", "w_gate", "w_up", "w_down")}
    blocks = shard_params(named, cfg, mesh)
    return {k.rsplit(".", 1)[1]: v for k, v in blocks.items()}


def _rank_run(inp):
    """One rank: every case on every mesh; returns its local results."""
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    mla = get_reduced(MLA_ARCH).replace(dtype="float32")
    moe = get_reduced(MOE_ARCH).replace(dtype="float32")
    out = {}
    for d, m in MESHES:
        mesh = LM.make_host_mesh(m)
        assert mesh.shape == {"data": d, "model": m}
        tag, j = f"{d}x{m}", mesh.coords["model"]
        s_loc = S // m
        sl = slice(j * s_loc, (j + 1) * s_loc)
        with sharding_rules(mesh, R.act_rules(mesh)):
            for pos in POS:
                kc, vc = t["kc"][:, sl].clone(), t["vc"][:, sl].clone()
                o, kc, vc = smdec.gqa_decode_sm(
                    mla, t["q"], t["k_new"], t["v_new"], kc, vc,
                    torch.tensor(pos, dtype=torch.int32))
                out[f"gqa/{tag}/{pos}"] = (o, kc, vc)
                ckv, kr = t["ckv"][:, sl].clone(), t["kr"][:, sl].clone()
                c, ckv, kr = smdec.mla_decode_sm(
                    mla, t["q_lat"], t["q_rope"], t["ckv_new"], t["kr_new"],
                    ckv, kr, torch.tensor(pos, dtype=torch.int32))
                out[f"mla/{tag}/{pos}"] = (c, ckv, kr)
            p = _moe_params(inp, moe, mesh)
            for b in MOE_B:
                x = t[f"x{b}"]
                out[f"ep/{tag}/{b}"] = M.moe_ep(p, moe, x, aux=False)[0]
                out[f"ep_serve/{tag}/{b}"] = M.moe_ep_serve(
                    p, moe, x, aux=False)[0]
    # the compressed mean of a gradient every rank holds (pure DP)
    dp = LM.make_host_mesh(1)          # data 4 x model 1
    g = {"w": torch.linspace(-1, 1, 512).reshape(2, 256),
         "b": [t["g"]]}
    out["psum"] = C.compressed_psum_mean(g, dp, axis="data")
    out["rank"] = dp.rank
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("pos", POS)
def test_split_kv_decode_matches_shard_map(cases, mesh, pos):
    inp, ref, port = cases
    tag = f"{mesh[0]}x{mesh[1]}"
    for kind, names in (("gqa", ("out", "kc", "vc")),
                        ("mla", ("ctx", "ckv", "kr"))):
        outs = [r[f"{kind}/{tag}/{pos}"] for r in port]
        for rank_out in outs:          # the combine is the same everywhere
            np.testing.assert_allclose(
                rank_out[0].numpy(), ref[f"{kind}/{tag}/{pos}/{names[0]}"],
                atol=ATOL, rtol=0)
        # rank (0, j) holds sequence shard j of the written cache
        for c, name in ((1, names[1]), (2, names[2])):
            whole = torch.cat([outs[j][c] for j in range(mesh[1])], dim=1)
            np.testing.assert_array_equal(
                whole.numpy(), ref[f"{kind}/{tag}/{pos}/{name}"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("impl", ["ep", "ep_serve"])
@pytest.mark.parametrize("b", MOE_B)
def test_expert_parallel_matches_shard_map(cases, mesh, impl, b):
    inp, ref, port = cases
    key = f"{impl}/{mesh[0]}x{mesh[1]}/{b}"
    for r in port:
        np.testing.assert_allclose(r[key].numpy(), ref[key], atol=ATOL,
                                   rtol=0)


def test_quantizer_matches_with_injected_noise(cases):
    inp, ref, _ = cases
    q, scale, pad = C._quantize(torch.from_numpy(inp["g"]),
                                noise=torch.from_numpy(inp["noise"]))
    np.testing.assert_array_equal(q.numpy(), ref["q"])
    np.testing.assert_array_equal(scale.numpy(), ref["scale"])
    back = C._dequantize(q, scale, pad, inp["g"].shape, torch.float32)
    np.testing.assert_array_equal(back.numpy(), ref["back"])
    assert float((back - torch.from_numpy(inp["g"])).abs().max()) <= \
        float(scale.max()) + 1e-9
    assert C.compression_ratio({"g": torch.from_numpy(inp["g"])}) < 0.27


def test_compressed_psum_mean_over_four_ranks(cases):
    inp, _, port = cases
    g = {"w": torch.linspace(-1, 1, 512).reshape(2, 256),
         "b": [torch.from_numpy(inp["g"])]}
    assert [r["rank"] for r in port] == [0, 1, 2, 3]
    for r in port:
        out = r["psum"]
        for got, want in ((out["w"], g["w"]), (out["b"][0], g["b"][0])):
            quantum = want.abs().reshape(-1).max() / 127.0
            assert got.shape == want.shape
            assert float((got - want).abs().max()) <= float(quantum) + 1e-7
        # every rank ends with the same mean
        torch.testing.assert_close(out["w"], port[0]["psum"]["w"], rtol=0,
                                   atol=0)
    assert C.compression_ratio(g) < 0.27
