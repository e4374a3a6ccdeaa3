"""The port's sharding rules and rank meshes against the reference's.

``sharding.rules`` is pure Python in both packages, so the specs are held
leaf for leaf on the same spec-only meshes (``launch.mesh.Mesh``: the
production ``(16, 16)`` and ``(2, 16, 16)`` and two host shapes), for
every arch of the registry: the reference's parameter tree (its
``init_params`` shapes, group leaves stacked over repeats) against the
port's unrolled parameters (a block leaf's spec is the reference's
without the leading repeats entry), and the contiguous caches' trees as
they are.  Then the mesh functions: ``make_host_mesh`` raising "model
axis" without ranks, ``make_production_mesh`` below its size,
``data_axes``, ``stage_split``, and ``bridge.shard_params`` /
``block_slices`` reassembling every parameter.
"""

import jax
import pytest
import torch

from repro.models import model as JMD
from repro.sharding import rules as JR
from repro_torch.bridge import shard_params
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.launch import mesh as LM
from repro_torch.models import model as MD
from repro_torch.sharding import rules as R

MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16},
          "host22": {"data": 2, "model": 2},
          "host14": {"data": 1, "model": 4}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _specs_equal(a, b):
    return tuple(a) == tuple(b)


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_cache_specs_match_reference(arch, mesh):
    m = LM.Mesh(MESHES[mesh])
    jcfg = __import__("repro.configs", fromlist=["get_config"]) \
        .get_config(arch)
    cfg = get_config(arch)
    pshape = jax.eval_shape(lambda: JMD.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    ref = _flat(JR.param_specs(jcfg, pshape, m))
    shapes = MD.param_shapes(cfg)
    port = R.param_specs(cfg, shapes, m)
    seen = set()
    for name, spec in port.items():
        path = R.ref_path(cfg, name)
        assert path in ref, (name, path)
        want = tuple(ref[path])
        got = tuple(spec)
        if path.startswith(("g", "enc_g")):
            got = (None,) + got
        assert got == want, (arch, name, got, want)
        seen.add(path)
        # every sharded dim divides its axes
        for dim, ax in zip(shapes[name], spec):
            if ax is not None:
                assert dim % R._axis_size(m, ax) == 0
    assert seen == set(ref)

    cshape = jax.eval_shape(lambda: JMD.init_cache(jcfg, 128, 1024))
    cref = _flat(JR.cache_specs(jcfg, cshape, m))
    cport = _flat(R.cache_specs(cfg, MD.init_cache(cfg, 128, 1024, "meta"),
                                m))
    assert set(cport) == set(cref)
    for path, spec in cport.items():
        assert tuple(spec) == tuple(cref[path]), (arch, path)


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_batch_and_activation_rules_match_reference(mesh):
    m = LM.Mesh(MESHES[mesh])
    assert R.batch_axes(m) == JR.batch_axes(m)
    for batch in (None, 1, 2, 32, 128):
        assert tuple(R.batch_spec(m, batch)) == \
            tuple(JR.batch_spec(m, batch))
        port, ref = R.act_rules(m, batch), JR.act_rules(m, batch)
        assert set(port) == set(ref)
        for k in port:
            assert tuple(port[k]) == tuple(ref[k])
    for dim in (1, 2, 4, 15, 16, 64, 151936):
        for ax in ("data", "model", ("pod", "data") if "pod" in m.shape
                   else ("data", "model"), None):
            assert R.maybe(dim, ax, m) == JR.maybe(dim, ax, m)


def test_mesh_functions_without_ranks():
    with pytest.raises(RuntimeError, match="model axis"):
        LM.make_host_mesh(2)
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        LM.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        LM.make_production_mesh(multi_pod=True)
    one = LM.make_host_mesh(1)
    assert one.shape == {"data": 1, "model": 1} and one.coords == \
        {"data": 0, "model": 0}
    x = torch.arange(6.0)
    assert one.all_reduce(x) is x and one.all_gather(x, "data", 0) is x
    pod = LM.Mesh(MESHES["multipod"])
    assert LM.data_axes(pod) == ("pod", "data")
    assert LM.data_axes(LM.Mesh(MESHES["host22"])) == ("data",)
    host = LM.Mesh({"data": 2, "model": 4})
    stages = LM.stage_split(host, 2)
    assert [s.tolist() for s in stages] == [[[0, 1], [4, 5]],
                                           [[2, 3], [6, 7]]]
    assert host.coords_of(6) == {"data": 1, "model": 2}


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b",
                                  "smollm-360m", "glm4-9b"])
def test_shard_params_blocks_reassemble(arch):
    """Every rank's blocks of every parameter, under the (2, 2) host mesh,
    tile the whole tensor exactly once; each carries its spec, and a
    sharded model takes them as its state."""
    cfg = get_reduced(arch).replace(dtype="float32")
    m = LM.Mesh(MESHES["host22"])
    whole = MD.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    named = dict(whole.named_parameters())
    seen = {k: torch.zeros(v.shape, dtype=torch.int32) for k, v in
            named.items()}
    split = 0
    for rank in range(m.size):
        blocks = shard_params(named, cfg, m, rank)
        for k, b in blocks.items():
            sl = R.block_slices(tuple(named[k].shape), b._spec, m,
                                m.coords_of(rank))
            torch.testing.assert_close(b, named[k][sl], rtol=0, atol=0)
            seen[k][sl] += 1
            split += b.numel() < named[k].numel()
    for k, n in seen.items():
        # a replicated leaf is held by all four ranks, a leaf split over
        # one axis by two, over both by one
        assert n.min() == n.max() and int(n.max()) in (1, 2, 4), k
    assert split > 0


def test_kv_layouts():
    qwen = get_config("qwen3-moe-235b-a22b")
    m2 = LM.Mesh({"data": 1, "model": 2})
    assert MD.kv_layout(qwen, m2, 512, paged=True) == "heads"
    assert MD.kv_layout(qwen, m2, 512, paged=False) == "heads"
    assert MD.kv_layout(qwen.replace(decode_impl="shardmap"), m2, 512,
                        paged=False) == "seq"
    small = get_config("smollm-360m")          # 5 KV heads
    assert MD.kv_layout(small, m2, 512, paged=True) == "full"
    assert MD.kv_layout(small, m2, 512, paged=False) == "seq"
    assert MD.kv_layout(small, m2, 511, paged=False) == "full"
    assert MD.kv_layout(get_config("deepseek-v2-236b"), m2, 512,
                        paged=False) == "seq"
    assert MD.kv_layout(qwen, None, 512, paged=False) == "full"
    # SSM and cross-attention members take the model axis: jamba's mamba
    # state is the rank's channels, its attention cache the rank's heads
    MD.check_shardable(get_config("jamba-v0.1-52b"), m2)
    jamba = MD.init_cache(get_reduced("jamba-v0.1-52b"), 2, 16, "meta",
                          mesh=m2)
    assert jamba["g0"]["b0"]["h"].shape[-2] == 64      # di 128 over 2
    assert jamba["g0"]["b2"]["k"].shape[-2] == 1       # 2 KV heads over 2
    # glm4-9b's 32 query heads split over 4 ranks, its 2 KV heads do not:
    # each paged pool holds the KV head of the rank's query heads, the
    # contiguous cache a sequence shard of every head
    glm, m4 = get_config("glm4-9b"), LM.Mesh({"data": 1, "model": 4})
    MD.check_shardable(glm, m4)
    assert MD.kv_layout(glm, m4, 512, paged=True) == "group"
    assert MD.kv_layout(glm, m4, 512, paged=False) == "seq"
    with pytest.raises(NotImplementedError, match="neither divide"):
        MD.check_shardable(glm.replace(n_heads=12, n_kv_heads=3), m4)
