"""The port's speculative decoding against the JAX package on the CPU.

* Plain verify attention (GQA and absorbed-latent MLA) against the
  reference's XLA attention and latent core on ``test_spec_decode.py``'s
  kernel-sweep shapes, float32 within ``_tol`` (2e-5); position t equals
  the plain decode at ``kv_len - W + t + 1`` bitwise, and W = 1 equals
  decode.  (The reference's Pallas verify kernels fail under the installed
  JAX, so its XLA path is the oracle.)
* ``model.verify`` against ``repro.models.model.verify`` (decode_impl
  "xla") on reduced smollm-360m and deepseek-v2 at float32 with bridged
  weights: logits within 1e-4 (summation order only), greedy tokens equal;
  the port's ``flash_paged`` verify equals its ``xla`` verify bitwise.
* Speculative fleets against the JAX speculative fleets with bridged
  target AND draft weights: identical tokens and spec counters.  The draft
  takes its arch's registry config, so these fleets read the reduced
  registry at float32 on both sides: in bf16 the two frameworks round at
  different places (XLA fuses elementwise ops in float32), which moves a
  near-tied draft proposal — never an output token, only the counters.
* Port-only twins of ``test_spec_decode.py``'s scheduler scenarios, each
  token-exact against the port's plain fleet.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import layers as JL
from repro.models import model as JMD
from repro.models.config import ModelConfig as JConfig
from repro.serving import fleet as jfleet
from repro.serving.scheduler import SpecConfig as JSpec
from repro_torch.bridge import model_from_jax, params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.kernels.flash_decode import (paged_flash_decode,
                                              paged_flash_decode_mla,
                                              paged_flash_verify,
                                              paged_flash_verify_mla,
                                              paged_flash_verify_mla_plain,
                                              paged_flash_verify_plain,
                                              paged_mla_verify_reference,
                                              paged_verify_reference)
from repro_torch.models import model as MD
from repro_torch.serving import fleet as tfleet
from repro_torch.serving.fleet import LocalFleet, _dropless
from repro_torch.serving.scheduler import SpecConfig
from test_kernels import _tol

ARCH = "smollm-360m"
MLA_ARCH = "deepseek-v2-236b"
MISALIGNED = "qwen3-1.7b"
VOCAB = 256                              # every reduced config's vocab
TOL = _tol(jnp.float32)
SHARED = " ".join(f"sys{i}" for i in range(20))
PROMPTS = [SHARED + " question one", "a lone unshared prompt",
           SHARED + " question two longer tail", "tiny"]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _tbl_and_lens(rng, *, B, nb, max_blocks, blk, W):
    """``test_spec_decode._tbl_and_lens``: random tables, kv_len >= W."""
    tbl = rng.randint(1, nb, size=(B, max_blocks)).astype(np.int32)
    kv_len = rng.randint(W, max_blocks * blk + 1, size=(B,)).astype(np.int32)
    return tbl, kv_len


def _gather(pool, tbl):
    nb, blk = pool.shape[:2]
    flat = pool.reshape((nb * blk,) + pool.shape[2:])
    idx = tbl[:, :, None] * blk + np.arange(blk)[None, None]
    return flat[idx.reshape(tbl.shape[0], -1)]


# ---------------------------------------------------------------------------
# plain verify attention vs the reference's XLA path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_plain_verify_vs_reference_xla_attention(seed):
    """``test_spec_decode.py:94``'s shapes (B 4, 12 blocks of 16, table of
    4, Hq 8, Hkv 2, hd 64, W 3).  The oracle is the reference's verify
    attention on its XLA path: ``layers.sdpa(causal=True, q_offset=kv_len
    - W, kv_len=kv_len)`` over the gathered view."""
    rng = np.random.RandomState(seed)
    B, nb, max_blocks, blk, Hq, Hkv, hd, W = 4, 12, 4, 16, 8, 2, 64, 3
    kp = rng.standard_normal((nb, blk, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, blk, Hkv, hd)).astype(np.float32)
    tbl, kv_len = _tbl_and_lens(rng, B=B, nb=nb, max_blocks=max_blocks,
                                blk=blk, W=W)
    q = rng.standard_normal((B, W, Hq, hd)).astype(np.float32)
    ref = np.asarray(JL.sdpa(jnp.asarray(q), jnp.asarray(_gather(kp, tbl)),
                             jnp.asarray(_gather(vp, tbl)), causal=True,
                             q_offset=jnp.asarray(kv_len - W),
                             kv_len=jnp.asarray(kv_len)))
    args = (_t(kp), _t(vp), torch.from_numpy(tbl), torch.from_numpy(kv_len))
    out = paged_flash_verify_plain(_t(q), *args)
    assert out.shape == (B, W, Hq, hd)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(paged_verify_reference(_t(q), *args).numpy(),
                               ref, atol=TOL, rtol=TOL)
    kl = args[3]
    for t in range(W):
        step = paged_flash_decode(_t(q[:, t]), *args[:3], kl - (W - 1 - t))
        assert torch.equal(out[:, t], step), f"t={t}"
    one = paged_flash_verify(_t(q[:, :1]), *args)
    assert torch.equal(one[:, 0], paged_flash_decode(_t(q[:, 0]), *args))


def _identity_mla(H, r, rh):
    """Reference MLA params whose projections are identities, so
    ``repro.models.layers.mla_attention`` returns its latent context
    (ctx·I·I is exact in float32): the reference's XLA latent core."""
    cfg = JConfig(name="latent-core", family="dense", d_model=H * r,
                  n_heads=H, n_kv_heads=H, head_dim=r, d_ff=1,
                  vocab_size=1, kv_lora_rank=r, nope_head_dim=r,
                  rope_head_dim=rh, v_head_dim=r, dtype="float32",
                  groups=())
    eye = np.broadcast_to(np.eye(r, dtype=np.float32), (H, r, r))
    p = {"wk_b": jnp.asarray(eye), "wv_b": jnp.asarray(eye),
         "wo": jnp.eye(H * r, dtype=jnp.float32)}
    return cfg, p


@pytest.mark.parametrize("seed", range(3))
def test_plain_mla_verify_vs_reference_latent_core(seed):
    """``test_spec_decode.py:118``'s shapes (B 3, 10 blocks of 16, table
    of 4, H 8, r 64, rh 32, W 4, scale 1/sqrt(96))."""
    rng = np.random.RandomState(100 + seed)
    B, nb, max_blocks, blk, H, r, rh, W = 3, 10, 4, 16, 8, 64, 32, 4
    scale = 1.0 / np.sqrt(96.0)
    ckv = rng.standard_normal((nb, blk, r)).astype(np.float32)
    kr = rng.standard_normal((nb, blk, rh)).astype(np.float32)
    tbl, kv_len = _tbl_and_lens(rng, B=B, nb=nb, max_blocks=max_blocks,
                                blk=blk, W=W)
    ql = rng.standard_normal((B, W, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, W, H, rh)).astype(np.float32)
    cfg, p = _identity_mla(H, r, rh)
    ref = np.asarray(JL.mla_attention(
        p, cfg, jnp.asarray(ql), jnp.asarray(qr), jnp.asarray(_gather(ckv,
                                                                      tbl)),
        jnp.asarray(_gather(kr, tbl)), causal=True,
        q_offset=jnp.asarray(kv_len - W), kv_len=jnp.asarray(kv_len)))
    ref = ref.reshape(B, W, H, r)
    pools = (_t(ckv), _t(kr), torch.from_numpy(tbl),
             torch.from_numpy(kv_len))
    out = paged_flash_verify_mla_plain(_t(ql), _t(qr), *pools, scale=scale)
    assert out.shape == (B, W, H, r)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        paged_mla_verify_reference(_t(ql), _t(qr), *pools,
                                   scale=scale).numpy(),
        ref, atol=TOL, rtol=TOL)
    kl = pools[3]
    for t in range(W):
        step = paged_flash_decode_mla(_t(ql[:, t]), _t(qr[:, t]), *pools[:3],
                                      kl - (W - 1 - t), scale=scale)
        assert torch.equal(out[:, t], step), f"t={t}"
    one = paged_flash_verify_mla(_t(ql[:, :1]), _t(qr[:, :1]), *pools,
                                 scale=scale)
    assert torch.equal(one[:, 0], paged_flash_decode_mla(
        _t(ql[:, 0]), _t(qr[:, 0]), *pools, scale=scale))


def test_plain_verify_dead_positions_are_zeros():
    """A position whose frontier ``kv_len - W + t + 1`` is <= 0 sees no
    key: exact zeros, as from the kernels (and from decode at kv_len 0)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 3, 4, 16), generator=g)
    pool = torch.randn((3, 4, 2, 16), generator=g)
    tbl = torch.tensor([[1, 2], [2, 1]], dtype=torch.int32)
    kl = torch.tensor([1, 8], dtype=torch.int32)        # row 0: t=2 only
    out = paged_flash_verify(q, pool, pool, tbl, kl)
    assert bool((out[0, :2] == 0).all()) and bool((out[0, 2] != 0).any())
    ckv, kr = torch.randn((3, 4, 16), generator=g), torch.randn((3, 4, 8),
                                                                generator=g)
    ctx = paged_flash_verify_mla(q, torch.randn((2, 3, 4, 8), generator=g),
                                 ckv, kr, tbl, kl, scale=0.2)
    assert bool((ctx[0, :2] == 0).all()) and bool((ctx[1] != 0).any())


# ---------------------------------------------------------------------------
# model.verify vs repro.models.model.verify
# ---------------------------------------------------------------------------

MAX_SEQ, BLK, NB, W = 64, 16, 9, 5
ROWS = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)


def _verify_inputs():
    """Two rows prefilled fresh (37 and 20 tokens), then W = 5 verify
    tokens per row."""
    r = np.random.default_rng(7)
    toks = np.zeros((2, 64), np.int32)
    toks[0, :37] = r.integers(4, VOCAB, 37)
    toks[1, :20] = r.integers(4, VOCAB, 20)
    return toks, [37, 20], r.integers(4, VOCAB, (2, W)).astype(np.int32)


@pytest.fixture(scope="module", params=[ARCH, MLA_ARCH])
def jax_verify(request):
    """The reference: fresh prefill of both rows, then one W-wide verify
    on its XLA path.  Returns (arch, params, verify logits)."""
    arch = request.param
    cfg = _dropless(j_get_reduced(arch).replace(dtype="float32",
                                                decode_impl="xla"))
    params = JMD.init_params(cfg, jax.random.PRNGKey(0))
    cache = JMD.init_paged_cache(cfg, 2, MAX_SEQ, NB, BLK)
    toks, lens, vtoks = _verify_inputs()
    _, cache = JMD.prefill(cfg, params, jnp.asarray(toks), cache,
                           moe_impl="sort", lens=jnp.asarray(lens, jnp.int32),
                           start=jnp.zeros((2,), jnp.int32),
                           tbl=jnp.asarray(ROWS), paged_fresh=True)
    cache["pos"] = jnp.asarray(lens, jnp.int32)
    cache["tbl"] = jnp.asarray(ROWS)
    logits, _ = JMD.verify(cfg, params, jnp.asarray(vtoks), cache,
                           moe_impl="sort")
    return arch, params, np.asarray(logits, np.float32)


def _port_prefilled(arch, jparams, decode_impl):
    cfg = _dropless(get_reduced(arch).replace(dtype="float32",
                                              decode_impl=decode_impl))
    model = model_from_jax(jparams, cfg, device="cpu")
    cache = MD.init_paged_cache(cfg, 2, MAX_SEQ, NB, BLK, device="cpu")
    toks, lens, vtoks = _verify_inputs()
    MD.prefill(cfg, model, torch.from_numpy(toks), cache, moe_impl="sort",
               lens=torch.tensor(lens), start=torch.zeros(2, dtype=torch.int32),
               tbl=torch.from_numpy(ROWS), paged_fresh=True)
    cache["pos"] = torch.tensor(lens, dtype=torch.int32)
    cache["tbl"] = torch.from_numpy(ROWS)
    return cfg, model, cache, torch.from_numpy(vtoks)


def test_model_verify_matches_jax_and_decode_steps(jax_verify):
    """float32 logits within 1e-4 of the reference's verify, greedy tokens
    equal; ``pos``/``tbl`` unchanged; ``flash_paged`` == ``xla`` bitwise;
    and position t agrees with the t-th of W successive decode steps on
    the same cache (the wide GEMMs sum like the narrow ones to 1e-5)."""
    arch, jparams, jlogits = jax_verify
    outs = {}
    for impl in ("xla", "flash_paged"):
        cfg, model, cache, vtoks = _port_prefilled(arch, jparams, impl)
        pos0 = cache["pos"].clone()
        logits, cache = MD.verify(cfg, model, vtoks, cache, moe_impl="sort")
        assert logits.shape == (2, W, VOCAB)
        assert torch.equal(cache["pos"], pos0)
        outs[impl] = logits.numpy()
    np.testing.assert_allclose(outs["xla"], jlogits, atol=1e-4, rtol=0)
    assert np.array_equal(outs["xla"].argmax(-1), jlogits.argmax(-1))
    assert np.array_equal(outs["xla"], outs["flash_paged"])
    cfg, model, cache, vtoks = _port_prefilled(arch, jparams, "xla")
    for t in range(W):
        lg, cache = MD.decode_step(cfg, model, vtoks[:, t:t + 1], cache,
                                   moe_impl="sort")
        np.testing.assert_allclose(lg.numpy(), outs["xla"][:, t], atol=1e-5,
                                   rtol=0, err_msg=f"t={t}")
        assert np.array_equal(lg.numpy().argmax(-1),
                              outs["xla"][:, t].argmax(-1))


# ---------------------------------------------------------------------------
# speculative fleets vs the JAX speculative fleets
# ---------------------------------------------------------------------------

def _f32_registry(mp):
    """Read both packages' reduced registries at float32 (targets AND
    drafts) while fleets are built."""
    for mod, orig in ((jfleet, jfleet.get_reduced),
                      (tfleet, tfleet.get_reduced)):
        mp.setattr(mod, "get_reduced",
                   lambda a, _o=orig: _o(a).replace(dtype="float32"))


def _spec_pair(arch, draft, **kw):
    kw = dict(batch=2, gen_tokens=6, warmup=False, **kw)
    with pytest.MonkeyPatch.context() as mp:
        _f32_registry(mp)
        jf = jfleet.LocalFleet([arch], paged=True, decode_impl="xla",
                               speculative=JSpec(draft, k=4), **kw)
        tf = LocalFleet([arch], device="cpu",
                        speculative=SpecConfig(draft, k=4), **kw)
    tf.members[arch].params.load_state_dict(
        params_from_jax(jf.members[arch].params))
    js, ts = jf.schedulers[arch], tf.schedulers[arch]
    ts.drafter.rt.params.load_state_dict(
        params_from_jax(js.drafter.rt.params))
    return jf, tf


def _counters(sched):
    return (sched.spec_rounds, sched.spec_offered, sched.spec_accepted,
            sched.drafter.catchup_prefills, sched.decode_steps)


@pytest.mark.parametrize("arch,draft", [(ARCH, ARCH), (MLA_ARCH, MLA_ARCH),
                                        (ARCH, MISALIGNED)])
def test_spec_fleet_matches_jax(arch, draft):
    """Aligned drafts on both archs (every proposal accepted) and the
    misaligned qwen3-1.7b draft (rejected, the lane backs off): the same
    tokens, the same spec counters, a clean pool."""
    jf, tf = _spec_pair(arch, draft)
    a = jf.generate(arch, PROMPTS)
    b = tf.generate(arch, PROMPTS)
    assert [x["tokens"] for x in b] == [x["tokens"] for x in a]
    js, ts = jf.schedulers[arch], tf.schedulers[arch]
    assert _counters(ts) == _counters(js)
    assert ts.spec_rounds > 0 and ts.pool.live_refs() == 0
    if draft == arch:
        assert ts.spec_accepted == ts.spec_offered > 0
        assert ts.spec_tokens_per_round > 1.0
    else:
        assert ts.spec_accepted < ts.spec_offered
        assert ts.spec_rounds < ts.decode_steps


def test_spec_fleet_bf16_draft_tokens_match_jax():
    """The registry's own bf16 draft in front of a float32 target: the
    output tokens are the target's alone, so they match the reference's
    whatever the draft proposes."""
    f32 = {ARCH: {"dtype": "float32"}}
    kw = dict(batch=2, gen_tokens=6, warmup=False, arch_overrides=f32)
    jf = jfleet.LocalFleet([ARCH], paged=True, decode_impl="xla",
                           speculative=JSpec(ARCH, k=4), **kw)
    tf = LocalFleet([ARCH], device="cpu", speculative=SpecConfig(ARCH, k=4),
                    **kw)
    tf.members[ARCH].params.load_state_dict(
        params_from_jax(jf.members[ARCH].params))
    assert tf.schedulers[ARCH].drafter.rt.cfg.dtype == "bfloat16"
    tf.schedulers[ARCH].drafter.rt.params.load_state_dict(
        params_from_jax(jf.schedulers[ARCH].drafter.rt.params))
    a = [x["tokens"] for x in jf.generate(ARCH, PROMPTS)]
    b = [x["tokens"] for x in tf.generate(ARCH, PROMPTS)]
    assert a == b and tf.schedulers[ARCH].pool.live_refs() == 0


# ---------------------------------------------------------------------------
# port-only twins of test_spec_decode.py's scheduler scenarios
# ---------------------------------------------------------------------------

def _fleet(arch=ARCH, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("gen_tokens", 6)
    kw.setdefault("warmup", False)
    return LocalFleet([arch], device="cpu", **kw)


@pytest.fixture(scope="module")
def plain_tokens():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = [r["tokens"]
                           for r in _fleet(arch).generate(arch, PROMPTS)]
        return cache[arch]
    return get


@pytest.mark.parametrize("arch,decode_impl", [
    (ARCH, "xla"), (ARCH, "flash_paged"),
    (MLA_ARCH, "xla"), (MLA_ARCH, "flash_paged")])
def test_spec_tokens_match_plain(arch, decode_impl, plain_tokens):
    """``test_spec_decode.py:146``: an aligned draft (same arch, same seed,
    identical weights) accepts everything; the tokens still come from the
    verify and equal the plain fleet's."""
    f = _fleet(arch, decode_impl=decode_impl,
               speculative=SpecConfig(arch, k=4))
    assert [r["tokens"] for r in f.generate(arch, PROMPTS)] == \
        plain_tokens(arch)
    s = f.schedulers[arch]
    assert s.spec_rounds > 0 and s.spec_accepted == s.spec_offered > 0
    assert s.spec_tokens_per_round > 1.0 and s.pool.live_refs() == 0


def test_spec_random_acceptance_patterns_token_exact(plain_tokens):
    """``test_spec_decode.py:180``: scripted proposal corruption drives
    arbitrary acceptance patterns through verify and rollback; every
    pattern is token-exact and leaves the pool clean."""
    f = _fleet(speculative=SpecConfig(ARCH, k=4, adaptive=False))
    sched = f.schedulers[ARCH]
    dw = sched.drafter
    orig = dw.propose
    ref = plain_tokens(ARCH)
    try:
        for seed in range(6):
            rnd = random.Random(seed)

            def corrupt(live, W, _rnd=rnd):
                props = orig(live, W).copy()
                for i in live:
                    for j in range(W - 1):
                        if _rnd.random() < 0.45:
                            props[i, j] = (int(props[i, j]) + 1) % VOCAB
                return props

            dw.propose = corrupt
            out = [r["tokens"] for r in f.generate(ARCH, PROMPTS)]
            assert out == ref, f"seed={seed}"
            assert sched.pool.live_refs() == 0, f"seed={seed}"
        assert 0 < sched.spec_accepted < sched.spec_offered
    finally:
        dw.propose = orig


def test_spec_preempt_mid_speculation_park_resume_exact():
    """``test_spec_decode.py:213``: a high-priority arrival parks a row
    between speculative rounds; the resumed row finishes as an
    uninterrupted plain run would, and the pool ends clean."""
    plain = _fleet(max_seq=64, kv_blocks=8)
    spec = _fleet(max_seq=64, kv_blocks=8,
                  speculative=SpecConfig(ARCH, k=2))
    ids = {"lo1": np.arange(4, 44, dtype=np.int32),
           "lo2": np.arange(50, 90, dtype=np.int32),
           "hi": np.arange(100, 157, dtype=np.int32)}
    ref = {}
    for name, arr in ids.items():
        ps = plain.schedulers[ARCH]
        rid = ps.submit(arr.copy(), max_new=6)
        ref[name] = list({s.rid: s for s in ps.drain()}[rid].out)
    sched = spec.schedulers[ARCH]
    rids = {name: sched.submit(ids[name].copy(), max_new=6)
            for name in ("lo1", "lo2")}
    sched.step()                           # both admitted, speculating
    assert sched.spec_rounds >= 1
    rids["hi"] = sched.submit(ids["hi"].copy(), max_new=6, priority=10)
    sched.step()                           # eviction parks one victim
    assert sched.preempted == 1
    done = {s.rid: s for s in sched.drain()}
    done.update({s.rid: s for s in (sched.result(r) for r in rids.values())
                 if s is not None})
    for name, rid in rids.items():
        assert list(done[rid].out) == ref[name], name
    assert sum(s.parks > 0 for s in done.values()) == 1
    assert sched.pool.live_refs() == 0


def test_spec_adaptive_backoff_then_probe_recovery(plain_tokens):
    """``test_spec_decode.py:250``: always-rejected proposals back the lane
    off to plain decode with an exponentially backed-off probe cadence;
    restoring the aligned draft lets a probe recover speculation.
    Token-exact in both regimes."""
    f = _fleet(speculative=SpecConfig(ARCH, k=4, adaptive=True,
                                      probe_every=4))
    sched = f.schedulers[ARCH]
    dw = sched.drafter
    orig = dw.propose
    ref = plain_tokens(ARCH)
    try:
        dw.propose = lambda live, W: (orig(live, W) + 1) % VOCAB
        assert [r["tokens"] for r in f.generate(ARCH, PROMPTS)] == ref
        used = [i for i in range(sched.slots) if dw.ewma[i] < 1.0]
        assert used and all(dw.ewma[i] < dw.spec.min_accept for i in used)
        assert sched.spec_rounds < sched.decode_steps
        assert dw.probe_scale > 1
    finally:
        dw.propose = orig
    rounds0, accepted0 = sched.spec_rounds, sched.spec_accepted
    for _ in range(6):
        assert [r["tokens"] for r in f.generate(ARCH, PROMPTS)] == ref
        if sched.spec_accepted > accepted0:
            break
    assert sched.spec_accepted > accepted0 and sched.spec_rounds > rounds0
    assert dw.probe_scale == 1
    assert any(dw.ewma[i] >= dw.spec.min_accept for i in range(sched.slots))
    assert sched.pool.live_refs() == 0


def test_speculative_validated_at_construction():
    """``test_spec_decode.py:306``: invalid SpecConfigs fail before any
    model is built."""
    mk = lambda **kw: LocalFleet([ARCH], warmup=False, device="cpu",
                                 **kw)                      # noqa: E731
    with pytest.raises(ValueError, match="SpecConfig"):
        mk(speculative={"draft_arch": ARCH})
    with pytest.raises(ValueError, match="paged"):
        mk(paged=False, speculative=SpecConfig(ARCH))
    with pytest.raises(ValueError, match="draft_arch"):
        mk(speculative=SpecConfig("no-such-arch"))
    with pytest.raises(ValueError, match="draft_arch"):
        mk(speculative=SpecConfig("whisper-tiny"))   # not a port text draft
    with pytest.raises(ValueError, match="k must be >= 1"):
        mk(speculative=SpecConfig(ARCH, k=0))
    with pytest.raises(ValueError, match="probe_every"):
        mk(speculative=SpecConfig(ARCH, probe_every=0))
    with pytest.raises(ValueError, match="alpha"):
        mk(speculative=SpecConfig(ARCH, alpha=0.0))
    with pytest.raises(ValueError, match="min_accept"):
        mk(speculative=SpecConfig(ARCH, min_accept=1.5))
    with pytest.raises(ValueError, match="vocab"):
        LocalFleet([ARCH], reduced=False, warmup=False, device="cpu",
                   speculative=SpecConfig(MLA_ARCH))


def test_depth_mult_target_keeps_registry_depth_draft():
    """``test_spec_decode.py:343``: ``depth_mult`` deepens the member only;
    the draft keeps its registry depth."""
    f = _fleet(speculative=SpecConfig(ARCH, k=2),
               arch_overrides={ARCH: {"depth_mult": 3}})
    depth = lambda c: sum(g.repeats * len(g.period)
                          for g in c.groups)                # noqa: E731
    assert depth(f.members[ARCH].cfg) == \
        3 * depth(f.schedulers[ARCH].drafter.rt.cfg)
    plain = _fleet(arch_overrides={ARCH: {"depth_mult": 3}})
    out = f.generate(ARCH, PROMPTS[:2], max_new=4)
    assert [r["tokens"] for r in out] == \
        [r["tokens"] for r in plain.generate(ARCH, PROMPTS[:2], max_new=4)]
    assert all(len(r["tokens"]) == 4 for r in out)
    assert f.schedulers[ARCH].pool.live_refs() == 0


def test_spec_warmup_runs_every_step_and_resets_stats():
    f = LocalFleet([ARCH], batch=2, gen_tokens=4, device="cpu",
                   speculative=SpecConfig(ARCH, k=3))
    s = f.schedulers[ARCH]
    assert f.members[ARCH].warmup_ms > 0 and s.spec_enabled
    assert s.spec_rounds == s.spec_offered == s.spec_emitted == 0
    assert s.drafter.catchup_prefills == 0 and s.decode_steps == 0
    assert len(f.generate(ARCH, ["hello there"])[0]["tokens"]) == 4
    assert s.spec_rounds > 0
