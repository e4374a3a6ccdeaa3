"""The port's encoder, cross-attention and audio lane against the JAX ones.

Reduced whisper-tiny (4+4 heads of 16, 2 encoder + 2 decoder layers, 24
stub frames) and llama-3.2-vision-90b (cross-attention to 16 stub
patches) at float32 with the reference's weights bridged over: the
encoder (``_encode``, bidirectional self-attention, no cache),
``_cross_attn`` in prefill and decode, and whole-model prefill + decode
through the contiguous cache, each within 1e-4 of JAX (greedy tokens
identical).  Then ``tests/test_fleet_lanes.py``'s lane cases on a
text + image + audio fleet, the audio lane's tokens equal to the JAX
fleet's, and ``build_dsl`` with the audio lane byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.launch import serve as jserve
from repro.models import model as JMD
from repro.serving.fleet import LocalFleet as JaxFleet
from repro_torch.bridge import model_from_jax, params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.models import model as MD
from repro_torch.serving.fleet import AudioLane, LocalFleet

AUD, VIS = "whisper-tiny", "llama-3.2-vision-90b"
ARCH_TEXT, ARCH_IMG = "smollm-360m", "sd-tiny"
ATOL = dict(atol=1e-4, rtol=0)


@pytest.fixture(scope="module", params=[AUD, VIS])
def pair(request):
    arch = request.param
    jcfg = j_get_reduced(arch).replace(dtype="float32")
    cfg = get_reduced(arch).replace(dtype="float32")
    jparams = JMD.init_params(jcfg, jax.random.PRNGKey(7))
    ctx = np.random.default_rng(3).standard_normal(
        (2, cfg.cross_ctx_len, cfg.d_model)).astype(np.float32)
    return arch, jcfg, jparams, cfg, model_from_jax(jparams, cfg, "cpu"), ctx


def test_encoder_matches_jax(pair):
    arch, jcfg, jparams, cfg, model, ctx = pair
    if arch != AUD:
        assert not cfg.is_encoder_decoder and not hasattr(model, "enc_blocks")
        return
    ref = JMD._encode(jcfg, jparams, jnp.asarray(ctx), "sort", False)
    out = MD._encode(cfg, model, torch.from_numpy(ctx), "sort")
    assert out.shape == (2, cfg.cross_ctx_len, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATOL)


def test_cross_attn_prefill_and_decode_match_jax(pair):
    """One cross-attention layer (group 0, repeat 0, its cross slot):
    prefill projects the context into ``ck``/``cv`` (in place here, a new
    cache there) and attends; decode attends to the stored K/V."""
    arch, jcfg, jparams, cfg, model, ctx = pair
    j = [s.mixer for s in cfg.groups[0].period].index("cross_attn")
    jp = jax.tree.map(lambda x: x[0], jparams["g0"][f"b{j}"])
    blk = model.blocks[j]
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    h1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kv = (2, cfg.cross_ctx_len, cfg.n_kv_heads, cfg.head_dim)
    jc = {"ck": jnp.zeros(kv), "cv": jnp.zeros(kv)}
    tc = {"ck": torch.zeros(kv), "cv": torch.zeros(kv)}
    jo, jc = JMD._cross_attn(jcfg, jp, jnp.asarray(h), jnp.asarray(ctx),
                             "prefill", jc)
    to = MD._cross_attn(cfg, blk, torch.from_numpy(h), torch.from_numpy(ctx),
                        "prefill", tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **ATOL)
    for k in ("ck", "cv"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **ATOL)
    jo, _ = JMD._cross_attn(jcfg, jp, jnp.asarray(h1), None, "decode", jc)
    to = MD._cross_attn(cfg, blk, torch.from_numpy(h1), None, "decode", tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **ATOL)


def test_prefill_decode_with_cross_context_match_jax(pair):
    """Whole-model prefill (encoder first for whisper; patches straight in
    for vision) + 5 per-row-position decode steps on the contiguous
    cache."""
    arch, jcfg, jparams, cfg, model, ctx = pair
    toks = np.asarray([[4, 9, 17, 33, 0, 0], [5, 6, 7, 8, 9, 10]], np.int32)
    lens = np.asarray([4, 6], np.int32)
    jl, jc = JMD.prefill(jcfg, jparams, jnp.asarray(toks),
                         JMD.init_cache(jcfg, 2, 32), jnp.asarray(ctx),
                         moe_impl="sort", lens=jnp.asarray(lens))
    tl, tc = MD.prefill(cfg, model, torch.from_numpy(toks),
                        MD.init_cache(cfg, 2, 32, "cpu"),
                        torch.from_numpy(ctx), moe_impl="sort",
                        lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    jc["pos"] = jnp.asarray(lens)
    tc["pos"] = torch.from_numpy(lens)
    for i in range(5):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        assert tl.numpy().argmax(-1).tolist() == tok.tolist(), f"step {i}"
        jl, jc = JMD.decode_step(jcfg, jparams, jnp.asarray(tok[:, None]),
                                 jc, moe_impl="sort")
        tl, tc = MD.decode_step(cfg, model, torch.from_numpy(tok[:, None]),
                                tc, moe_impl="sort")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)


def test_encoder_attention_takes_the_kernel_option_on_cpu(pair):
    """Under ``attn_impl="pallas"`` the encoder's bidirectional attention
    and the decoder's prefill reach the flash-attention wrapper (its plain
    version on the CPU): the same logits, bit for bit."""
    arch, jcfg, jparams, cfg, model, ctx = pair
    kcfg = cfg.replace(attn_impl="pallas")
    toks = torch.tensor([[4, 9, 17, 33]], dtype=torch.int32)
    x = torch.from_numpy(ctx[:1])
    a, _ = MD.prefill(cfg, model, toks, MD.init_cache(cfg, 1, 16, "cpu"), x)
    b, _ = MD.prefill(kcfg, model, toks, MD.init_cache(kcfg, 1, 16, "cpu"),
                      x)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the three-lane fleet (tests/test_fleet_lanes.py's cases)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleets():
    f32 = {AUD: {"dtype": "float32"}}
    kw = dict(reduced=True, batch=3, gen_tokens=6, arch_overrides=f32)
    jf = JaxFleet([ARCH_TEXT, ARCH_IMG, AUD], warmup=False, **kw)
    tf = LocalFleet([ARCH_TEXT, ARCH_IMG, AUD], device="cpu", warmup=False,
                    **kw)
    tf.members[AUD].params.load_state_dict(
        params_from_jax(jf.members[AUD].params))
    return jf, tf


def test_lane_map_and_modalities(fleets):
    _, fleet = fleets
    assert fleet.modality_of(ARCH_TEXT) == "text"
    assert fleet.modality_of(ARCH_IMG) == "image"
    assert fleet.modality_of(AUD) == "audio"
    assert isinstance(fleet.lanes[AUD], AudioLane)
    # AR-based lanes keep their decode schedulers addressable
    assert ARCH_TEXT in fleet.schedulers and AUD in fleet.schedulers
    assert ARCH_IMG not in fleet.schedulers
    # the audio member serves from the contiguous cache, the text one paged
    assert not fleet.members[AUD].paged and fleet.members[ARCH_TEXT].paged


def test_audio_lane_transcribes_payload_dependent(fleets):
    """The payload is the audio (stub frontend): it enters as per-request
    cross-attention context, so different payloads yield different
    transcripts and identical payloads identical ones — and the JAX lane's
    tokens, payload for payload."""
    jf, fleet = fleets
    texts = ["transcribe my voice memo", "transcribe my voice memo",
             "a completely different recording"]
    a, b, c = fleet.generate(AUD, texts)
    assert a["transcript"] == b["transcript"]
    assert a["transcript"] != c["transcript"]
    assert a["lane"] == "audio" and len(a["tokens"]) == 6
    ref = jf.generate(AUD, texts)
    assert [x["tokens"] for x in (a, b, c)] == [x["tokens"] for x in ref]
    assert [x["transcript"] for x in (a, b, c)] == \
        [x["transcript"] for x in ref]


def test_cross_lane_interleaved_drain(fleets):
    """One batch_call carrying text+image+audio payloads drains all three
    lanes under one call, each producing its modality payload; the audio
    answer equals the JAX fleet's."""
    jf, fleet = fleets
    m2a = {"m-t": ARCH_TEXT, "m-i": ARCH_IMG, "m-a": AUD}
    payloads = [
        {"model": "m-t", "messages": [{"role": "user", "content": "solve"}]},
        {"model": "m-i", "messages": [{"role": "user", "content": "draw"}]},
        {"model": "m-a", "messages": [{"role": "user",
                                       "content": "transcribe"}]},
    ]
    outs = fleet.call_fn(m2a).batch_call(None, payloads, [{}] * 3)
    lanes = [o["usage"]["vsr_lane"] for o in outs]
    assert lanes == ["text", "image", "audio"]
    assert "image" in outs[1]["choices"][0]["message"]
    assert "transcript" in outs[2]["choices"][0]["message"]
    assert all(o["usage"]["vsr_service_ms"] > 0 for o in outs)
    ref = jf.call_fn(m2a).batch_call(None, payloads, [{}] * 3)
    assert outs[2]["choices"][0]["message"]["transcript"] == \
        ref[2]["choices"][0]["message"]["transcript"]


def test_build_dsl_with_audio_matches_reference():
    for lanes in (("text", "audio"), ("text", "image", "audio"),
                  ("text", "audio", "image")):
        assert serve.build_dsl(lanes) == jserve.build_dsl(lanes), lanes
    assert "whisper-tiny" in serve.build_dsl(("text", "audio"))
