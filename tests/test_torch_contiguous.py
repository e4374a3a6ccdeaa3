"""The port's contiguous (slot-row) cache against the JAX one, and paged
== contiguous inside the port.

Reduced smollm-360m (GQA) and deepseek-v2 (MLA + MoE, dropless,
``moe_impl="sort"``) with the reference's weights bridged over:

* ``init_cache`` + ``prefill`` (two right-padded rows, ``lens``-aware) +
  per-row-position ``decode_step``s: float32 logits within 1e-4 of JAX
  (as ``tests/test_torch_model.py``), greedy tokens identical;
* ``_cache_write`` at a scalar and at per-row positions, and
  ``serve_lib.merge_row`` (a prefilled batch-1 row into one slot, every
  leaf but ``pos``), against the reference's;
* ``tests/test_prefix_paged.py``'s acceptance bar inside the port: random
  prompts with shared prefixes give IDENTICAL tokens on a ``paged=False``
  and a ``paged=True`` fleet of the same seed (bf16, the plain paths);
* a contiguous fleet token-exact against the JAX contiguous fleet
  (float32, bridged weights), and a contiguous park/resume == the
  uninterrupted run.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import model as JMD
from repro.serving import serve_lib as JSL
from repro.serving.fleet import LocalFleet as JaxFleet
from repro_torch.bridge import model_from_jax, params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import model as MD
from repro_torch.serving import serve_lib
from repro_torch.serving.fleet import LocalFleet

ARCH = "smollm-360m"
MLA_ARCH = "deepseek-v2-236b"
MAX_SEQ, STEPS = 48, 6


def _dropless(cfg):
    if not cfg.n_experts:
        return cfg
    return cfg.replace(moe_capacity_factor=max(
        cfg.moe_capacity_factor, cfg.n_experts / cfg.moe_top_k))


def _pair_models(arch):
    jcfg = _dropless(j_get_reduced(arch).replace(dtype="float32"))
    cfg = _dropless(get_reduced(arch).replace(dtype="float32"))
    jparams = JMD.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, jparams, cfg, model_from_jax(jparams, cfg, "cpu")


@pytest.mark.parametrize("arch", [ARCH, MLA_ARCH])
def test_contiguous_prefill_decode_match_jax(arch):
    jcfg, jparams, cfg, model = _pair_models(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(4, 256, (2, 16)).astype(np.int32)
    lens = np.asarray([16, 11], np.int32)
    jl, jc = JMD.prefill(jcfg, jparams, jnp.asarray(toks),
                         JMD.init_cache(jcfg, 2, MAX_SEQ), moe_impl="sort",
                         lens=jnp.asarray(lens))
    tl, tc = MD.prefill(cfg, model, torch.from_numpy(toks),
                        MD.init_cache(cfg, 2, MAX_SEQ, "cpu"),
                        moe_impl="sort", lens=torch.from_numpy(lens))
    assert int(tc["pos"]) == 16 == int(jc["pos"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    jc["pos"] = jnp.asarray(lens)
    tc["pos"] = torch.from_numpy(lens)
    for i in range(STEPS):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        assert tl.numpy().argmax(-1).tolist() == tok.tolist(), f"step {i}"
        jl, jc = JMD.decode_step(jcfg, jparams, jnp.asarray(tok[:, None]),
                                 jc, moe_impl="sort")
        tl, tc = MD.decode_step(cfg, model, torch.from_numpy(tok[:, None]),
                                tc, moe_impl="sort")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"step {i}")
    assert tc["pos"].tolist() == (lens + STEPS).tolist()
    # the caches agree leaf for leaf up to each row's depth
    for g in ("g0",):
        for name, leaf in tc[g]["b0"].items():
            np.testing.assert_allclose(leaf[:, 1, :lens[1] + STEPS].numpy(),
                                       np.asarray(jc[g]["b0"][name])
                                       [:, 1, :lens[1] + STEPS],
                                       atol=1e-5, rtol=0)


def test_cache_write_scalar_and_per_row_positions():
    rng = np.random.default_rng(2)
    buf = rng.standard_normal((3, 10, 2, 4)).astype(np.float32)
    val = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    wide = rng.standard_normal((3, 4, 2, 4)).astype(np.float32)
    for v, pos in ((val, np.asarray([0, 7, 9], np.int32)), (val, 5),
                   (wide, 3), (wide, 8)):    # 8 + 4 > 10: clamped start
        t = torch.from_numpy(buf.copy())
        MD._cache_write(t, torch.from_numpy(v),
                        torch.from_numpy(pos) if isinstance(pos, np.ndarray)
                        else pos)
        ref = JMD._cache_write(jnp.asarray(buf), jnp.asarray(v),
                               jnp.asarray(pos))
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref))


def test_merge_row_copies_one_slot_but_not_pos():
    """A batch-1 row cache prefilled by ``make_prefill_fn`` lands in slot
    1 of a 3-slot cache (every leaf: attention K/V or MLA latents), the
    reference's ``merge_row`` gives the same cache, and ``pos`` stays the
    scheduler's."""
    for arch in (ARCH, MLA_ARCH):
        jcfg, jparams, cfg, model = _pair_models(arch)
        toks = np.arange(4, 13, dtype=np.int32)[None]
        _, row = serve_lib.make_prefill_fn(cfg, moe_impl="sort")(
            model, torch.from_numpy(toks),
            MD.init_cache(cfg, 1, MAX_SEQ, "cpu"))
        cache = MD.init_cache(cfg, 3, MAX_SEQ, "cpu")
        cache["pos"] = torch.tensor([5, 6, 7], dtype=torch.int32)
        cache = serve_lib.merge_row(cache, row, 1)
        assert cache["pos"].tolist() == [5, 6, 7]
        _, jrow = JMD.prefill(jcfg, jparams, jnp.asarray(toks),
                              JMD.init_cache(jcfg, 1, MAX_SEQ),
                              moe_impl="sort")
        jcache = JMD.init_cache(jcfg, 3, MAX_SEQ)
        jcache["pos"] = jnp.asarray([5, 6, 7], jnp.int32)
        _, _, jmerge = JSL.build_row_serve_steps(jcfg, moe_impl="sort")
        jcache = jmerge(jcache, jrow, 1)
        for g in cache:
            if g == "pos":
                continue
            for b, leaves in cache[g].items():
                for name, leaf in leaves.items():
                    assert not leaf[:, 0].any() and not leaf[:, 2].any()
                    np.testing.assert_allclose(
                        leaf.numpy(), np.asarray(jcache[g][b][name]),
                        atol=1e-5, rtol=0)


def _rand_prompts(rnd, n, shared=None):
    out = []
    for _ in range(n):
        L = rnd.randrange(1, 90)
        body = " ".join(f"w{rnd.randrange(500)}" for _ in range(L))
        if shared and rnd.random() < 0.6:
            body = shared + " " + body
        out.append(body)
    return out


@pytest.mark.parametrize("arch", [ARCH, MLA_ARCH])
def test_paged_tokens_match_contiguous_random_sweep(arch):
    """``tests/test_prefix_paged.py``'s acceptance bar inside the port:
    random admission orders and prompt lengths (shared prefixes included,
    so the cached suffix-prefill path is hit) give IDENTICAL tokens on the
    paged and contiguous fleets of one seed."""
    kw = dict(batch=3, gen_tokens=6, warmup=False, device="cpu")
    contig = LocalFleet([arch], paged=False, **kw)
    paged = LocalFleet([arch], paged=True, **kw)
    assert not contig.members[arch].paged and paged.members[arch].paged
    shared = " ".join(f"sys{i}" for i in range(40))     # 2+ full blocks
    rnd = random.Random(0)
    prompts = _rand_prompts(rnd, 7, shared=shared)
    a = contig.generate(arch, prompts)
    b = paged.generate(arch, prompts)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x["tokens"] == y["tokens"], (i, prompts[i])
    st = paged.schedulers[arch].pool.stats
    assert st.hit_blocks > 0 and st.cached_tokens > 0, st.as_dict()


@pytest.fixture(scope="module")
def fleet_pair():
    f32 = {ARCH: {"dtype": "float32"}}
    jf = JaxFleet([ARCH], batch=2, gen_tokens=6, paged=False, warmup=False,
                  arch_overrides=f32)
    tf = LocalFleet([ARCH], batch=2, gen_tokens=6, paged=False,
                    warmup=False, arch_overrides=f32, device="cpu")
    tf.members[ARCH].params.load_state_dict(
        params_from_jax(jf.members[ARCH].params))
    return jf, tf


def test_contiguous_fleet_tokens_match_jax(fleet_pair):
    """More prompts than slots; then the same prompts with two rows
    prefilled ahead of a free slot (``prefill_lookahead=2``: each waiting
    row holds its own batch-1 cache until it is merged) give the same
    tokens."""
    jf, tf = fleet_pair
    prompts = ["a lone unshared prompt", "tiny",
               " ".join(f"w{i}" for i in range(56)), "and one more here"]
    a = jf.generate(ARCH, prompts)
    b = tf.generate(ARCH, prompts)
    assert [x["tokens"] for x in b] == [x["tokens"] for x in a]
    assert tf.schedulers[ARCH].prefill.prefills == \
        jf.schedulers[ARCH].prefill.prefills == len(prompts)
    ahead = LocalFleet([ARCH], batch=2, gen_tokens=6, paged=False,
                       warmup=False, prefill_lookahead=2, device="cpu",
                       arch_overrides={ARCH: {"dtype": "float32"}})
    ahead.members[ARCH].params.load_state_dict(
        tf.members[ARCH].params.state_dict())
    c = ahead.generate(ARCH, prompts)
    assert [x["tokens"] for x in c] == [x["tokens"] for x in a]


def test_contiguous_park_resume_equals_uninterrupted(fleet_pair):
    """A VIP arrival parks a running contiguous row; the row is
    re-prefilled at resume and its tokens equal an uninterrupted run's —
    and the reference's under the same schedule."""
    jf, tf = fleet_pair
    a, b = np.arange(4, 44, dtype=np.int32), np.arange(50, 70, dtype=np.int32)
    vip = np.arange(100, 117, dtype=np.int32)
    sched = tf.schedulers[ARCH]
    base = {}
    for ids in (a, b):
        rid = sched.submit(ids, max_new=6)
        base[rid] = ids
    plain = [list(s.out) for s in sorted(sched.drain(), key=lambda s: s.rid)]
    outs = []
    for fleet in (jf, tf):
        sch = fleet.schedulers[ARCH]
        sch.submit(a, max_new=6)
        sch.submit(b, max_new=6)
        sch.step()
        sch.step()
        sch.submit(vip, max_new=6, priority=10)
        before = sch.preempted
        done = sorted(sch.drain(), key=lambda s: s.rid)
        assert sch.preempted == before + 1
        outs.append([list(s.out) for s in done])
    assert outs[1] == outs[0]
    assert outs[1][:2] == plain
